"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` compiles into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library is built at first use into ``build/kernels/`` at the repository
root; its file name carries a hash of the source and the flags, so a
changed ``.cu`` rebuilds. ``nvcc`` is found through ``CUDA_HOME``, then
``PATH``, then ``/usr/local/cuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# No --use_fast_math: it would replace IEEE division and expf, and the
# schedule is held to ULP closeness with the reference.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}

#: what a C entry point returns when it refuses a launch plan (a plan that
#: does not fit the shape, or that the card cannot schedule); any other
#: nonzero return is the CUDA runtime's error from the launch itself
REFUSED = -1


class KernelLaunchError(RuntimeError):
    """A hand-written kernel's launch failed on the card (the CUDA runtime
    returned an error). A refused plan raises ``ValueError`` instead: that
    is a programming error, never worth a retry."""


def check_launch(err: int, kernel: str, plan) -> None:
    """Raise for a C entry point's nonzero return: ``ValueError`` for a
    refused plan, ``KernelLaunchError`` for a failed launch."""
    if err == REFUSED:
        raise ValueError(f"{kernel} refused the launch plan {plan}")
    if err != 0:
        raise KernelLaunchError(f"{kernel} failed to launch {plan}: "
                                f"cudaError {err}")


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: ``build/kernels/lib<stem>-<hash>.so``."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; returns the path.
    The compiler's output (register and shared-memory use, from ``-Xptxas
    -v``) is kept beside the library as ``<name>.log``."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)        # atomic: a concurrent build sees all or none
    return out


def ptxas_report(source: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel function of
    ``csrc/<source>``, from the ``-Xptxas -v`` log kept beside its library:
    ``{mangled name: {"registers", "spill_stores", "spill_loads"}}``."""
    log = library_path(source).with_suffix(".log")
    report: dict[str, dict[str, int]] = {}
    name = None
    for line in log.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name]["spill_stores"] = int(m.group(1))
            report[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


def sass_opcode_counts(source: str, opcodes: tuple[str, ...]
                       ) -> dict[str, dict[str, int]]:
    """How many SASS instructions of each of ``opcodes`` (e.g. ``HMMA``)
    each kernel function of ``csrc/<source>``'s built library holds, from
    ``cuobjdump -sass`` (beside nvcc): ``{mangled name: {opcode: n}}``."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(library_path(source))],
                          capture_output=True, text=True, check=True)
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {op: 0 for op in opcodes}
        elif name is not None:
            for op in opcodes:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``, once per
    process."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _loaded[source] = lib
    return lib
