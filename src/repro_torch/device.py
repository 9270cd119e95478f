"""The port's one device rule.

Every entry point (``solve_suite``, ``get_solver``, ``IsingMachine``,
``AnnealEngine``) takes ``torch_device`` and resolves it here. The default
is ``"cuda"``: the port runs on the card unless the caller asks for the
CPU by name. Without CUDA it raises instead of carrying on on the CPU, so
a run that meant to measure the card can never quietly measure the host.
(``DeviceModel`` is the chip model, hence the separate keyword.)
"""
from __future__ import annotations

import torch

DEFAULT_TORCH_DEVICE = "cuda"


def resolve_device(torch_device: str | torch.device = DEFAULT_TORCH_DEVICE
                   ) -> torch.device:
    """``torch_device`` as a ``torch.device``; raises if it names CUDA and
    no CUDA device is available."""
    dev = torch.device(torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"torch_device={str(torch_device)!r} but CUDA is not available; "
            "pass torch_device='cpu' to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"torch_device must be a CUDA device or 'cpu', "
                         f"got {str(torch_device)!r}")
    return dev


def device_key(dev: torch.device) -> str:
    """Cache-key spelling of a device: ``cuda:<device name>`` or ``cpu``."""
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return "cpu"

