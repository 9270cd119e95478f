"""The benchmark of ``repro_torch`` on NVIDIA GPUs.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the repository's root. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``compared``, each number judged beside its limit (also the last
lines of standard error). Exits non-zero, with no result, where CUDA is
missing or has fewer cards than the cell asks for, and where the
measured process holds JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into ``build/kernels``); the engine's
    autotune cache is pointed at a file that is never written, so it
    stays off."""
    base = ROOT / "build" / "cardbench"
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(base / "autotune-off.json")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cardbench.harness import loop, spec

    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = loop.measure(cell, args.seed % (1 << 63), args.seconds,
                          bool(args.trace), "cuda", T_START)
    bad = loop.forbidden_modules()      # after the window, before the line
    if bad:
        print(f"the measured process holds {bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
