"""Deprecated alias: the LM decode entry point moved to
``repro_torch.launch.serve_lm`` (the reference's ``launch.serve`` shim).

``serve`` now means the Ising solve service (``repro_torch.serve``, CLI
``repro_torch.launch.serve_ising``). This shim keeps old imports and
``python -m repro_torch.launch.serve`` working with a DeprecationWarning.
"""
from __future__ import annotations

import warnings

from .serve_lm import main, serve  # noqa: F401

warnings.warn(
    "repro_torch.launch.serve is deprecated: the LM decode entry point is "
    "repro_torch.launch.serve_lm; the Ising solve service lives in "
    "repro_torch.serve / repro_torch.launch.serve_ising",
    DeprecationWarning, stacklevel=2)

if __name__ == "__main__":
    main()
