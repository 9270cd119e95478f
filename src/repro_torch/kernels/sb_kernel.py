"""The simulated-bifurcation kernel: CUDA wrapper and plain PyTorch version.

``fused_sb_kernel`` replaces the TPU kernel
``src/repro/kernels/sb_kernel.py:79 _sb_kernel``. On CUDA tensors it
launches ``csrc/sb_kernel.cu`` (built with ``nvcc`` at first use, see
``kernels/build.py``) on the current stream, or raises; it never falls back.
On CPU tensors it runs ``sb_reference``, the plain version, which the CPU
tests hold against the reference and ``chip_smoke.py`` holds the kernel
against on the card.

One launch runs the whole integration: ``n_steps`` symplectic steps of
(Goto et al.; SNIPPETS.md Snippet 2)

  aSB  x += a0*dt*y;  y += dt*(Jc @ x - (x^2 + a0 - a_t)*x)
  bSB  x += a0*dt*y;  y += dt*(Jc @ x - (a0 - a_t)*x), then inelastic
       walls: |x| > 1 -> x = clip(x), y = 0
  dSB  as bSB, with the drive Jc @ sign_pm1(x)

with the pump ``a_t = a0*(t+1)/n_steps`` derived in-kernel from the step
index. Jc (P, N, N) float32 carries the coupling scale c0; x0, y0 (P, R, N)
float32; the result is x_final (P, R, N). All three variants are float32
end to end, as in the reference.

Float32 op order, held op for op by the kernel and the plain version (the
reference's ``_sb_step`` as XLA evaluates it): ``x + f32(a0*dt)*y`` (a0*dt
a double rounded once); ``a_t = f32(a0) * (f32(t+1) * f32(1/n_steps))``;
``y + f32(dt)*(dv - (x*x + (a0 - a_t))*x)`` for aSB and
``y + f32(dt)*(dv - (a0 - a_t)*x)`` for bSB / dSB, then ``hit = |x| > 1``
on the unclipped x, the clip, and ``y = 0`` where hit.

``dv = drive @ Jc^T`` is summed in the order j = 0..N-1, each term a
rounded multiply and a rounded add (no FMA), by the kernel and the plain
version alike, so the two are bitwise equal. The reference's ``jnp.dot``
sums in its own order; the plain version is held to it statistically (SB
amplifies a 1-ULP difference in dv: at N = 2048 aSB and bSB read out other
spins in ~15% of runs under another sum order, with the same energies).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.binarize import sign_pm1

SB_VARIANTS = ("aSB", "bSB", "dSB")
#: runs per block. At the Gset shape (P=1, R=256) this gives 32 blocks for
#: 132 SMs; the runs are independent, so block_r changes no result.
DEFAULT_BLOCK_R = 8
#: largest spin count the kernel takes (8 spins a thread at 256 threads;
#: Gset's N = 2000 pads to 2048)
MAX_N = 2048
SOURCE = "sb_kernel.cu"

_VARIANT_CODE = {"aSB": 0, "bSB": 1, "dSB": 2}
#: kernel name per variant, as counted and reported
KERNEL_NAMES = {"aSB": "sb_asb", "bSB": "sb_bsb", "dSB": "sb_dsb"}
#: launches of the CUDA kernel per variant name; the wrapper adds one where
#: it launches the kernel and nowhere else.
launches = {name: 0 for name in KERNEL_NAMES.values()}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def check_variant(variant: str) -> None:
    if variant not in SB_VARIANTS:
        raise ValueError(f"variant must be one of {SB_VARIANTS}, "
                         f"got {variant!r}")


def _f32(x: float) -> float:
    """``x`` rounded once to float32 (exact as a Python float)."""
    return float(np.float32(x))


def pump_offsets(n_steps: int, a0: float) -> np.ndarray:
    """(n_steps,) float32 ``a0 - a_t`` with ``a_t = f32(a0) * (f32(t+1) *
    f32(1/n_steps))``, each op rounded to float32 as in the kernel."""
    a0_32 = np.float32(a0)
    inv = np.float32(1.0 / float(n_steps)) if n_steps else np.float32(0)
    t1 = np.arange(1, n_steps + 1, dtype=np.float32)
    return a0_32 - a0_32 * (t1 * inv)


def ordered_matvec(drive: torch.Tensor, J_t: torch.Tensor) -> torch.Tensor:
    """``drive @ J_t`` for drive (P, R, N) and J_t (P, N, N), summed in the
    kernel's order: j = 0..N-1, a rounded multiply then a rounded add."""
    acc = torch.zeros(drive.shape[:-1] + J_t.shape[-1:], dtype=drive.dtype,
                      device=drive.device)
    for j in range(J_t.shape[-2]):
        acc.add_(drive[..., j:j + 1] * J_t[..., j:j + 1, :])
    return acc


def _sb_step(x, y, J_t, amat: float, *, variant: str, c_xy: float,
             dt: float):
    """One symplectic step on (P, r, N) positions / momenta; ``amat`` is
    this step's ``a0 - a_t``, ``c_xy`` is ``f32(a0*dt)``."""
    x = x + c_xy * y
    drive = sign_pm1(x) if variant == "dSB" else x
    dv = ordered_matvec(drive, J_t)
    if variant == "aSB":
        y = y + dt * (dv - (x * x + amat) * x)
    else:
        y = y + dt * (dv - amat * x)
        # perfectly inelastic walls (Goto's bSB stabilization)
        hit = torch.abs(x) > 1.0
        x = torch.clamp(x, -1.0, 1.0)
        y = torch.where(hit, 0.0, y)
    return x, y


def sb_reference(Jc: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, *,
                 variant: str = "bSB", n_steps: int = 400, dt: float = 0.5,
                 a0: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a loop of ``_sb_step`` over the
    whole (P, R, N) batch. Jc (P,N,N), x0 / y0 (P,R,N) -> x_final."""
    check_variant(variant)
    Jc = torch.as_tensor(Jc).to(torch.float32)
    x = torch.as_tensor(x0, device=Jc.device).to(torch.float32)
    y = torch.as_tensor(y0, device=Jc.device).to(torch.float32)
    J_t = Jc.transpose(-1, -2)
    c_xy, dt32 = _f32(a0 * dt), _f32(dt)
    for amat in pump_offsets(int(n_steps), a0).tolist():
        x, y = _sb_step(x, y, J_t, amat, variant=variant, c_xy=c_xy,
                        dt=dt32)
    return x


def _library() -> ctypes.CDLL:
    from . import build
    lib = build.load(SOURCE)
    fn = lib.sb_integrate
    if fn.argtypes is None:
        i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, f, f, p]
        fn.restype = i
    return lib


def fused_sb_kernel(Jc: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                    *, variant: str = "bSB", n_steps: int = 400,
                    dt: float = 0.5, a0: float = 1.0,
                    block_r: int | None = None) -> torch.Tensor:
    """Whole SB integration of Jc (P,N,N) float32 from x0, y0 (P,R,N)
    float32 -> x_final (P,R,N). CUDA tensors launch the kernel (one launch
    per call); CPU tensors run the plain version. ``block_r`` (runs per
    block, default ``DEFAULT_BLOCK_R``) changes no result."""
    check_variant(variant)
    block_r = DEFAULT_BLOCK_R if block_r is None else int(block_r)
    if block_r < 1:
        raise ValueError(f"block_r must be >= 1, got {block_r}")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    tensors = (Jc, x0, y0)
    if all(t.device.type == "cpu" for t in tensors):
        return sb_reference(Jc, x0, y0, variant=variant, n_steps=n_steps,
                            dt=dt, a0=a0)
    if Jc.device.type != "cuda" or any(t.device != Jc.device
                                       for t in tensors):
        raise ValueError(f"Jc, x0 and y0 must all be on one CUDA device (or "
                         f"all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"Jc, x0 and y0 must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if Jc.dim() != 3 or Jc.shape[1] != Jc.shape[2] or x0.dim() != 3 or \
            x0.shape != y0.shape or x0.shape[0] != Jc.shape[0] or \
            x0.shape[2] != Jc.shape[2]:
        raise ValueError(f"need Jc (P,N,N) and x0, y0 (P,R,N), got "
                         f"{tuple(Jc.shape)}, {tuple(x0.shape)}, "
                         f"{tuple(y0.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("Jc, x0 and y0 must be contiguous")
    P, N, _ = Jc.shape
    R = x0.shape[1]
    if N > MAX_N:
        raise ValueError(f"the SB kernel supports N <= {MAX_N}, got {N}")
    if P == 0 or R == 0 or N == 0:
        return x0.clone()

    lib = _library()
    # the kernel reads Jc^T so that neighbouring threads (neighbouring
    # spins i) read neighbouring words of one row j
    JT = Jc.transpose(-1, -2).contiguous()
    out = torch.empty_like(x0)
    inv = _f32(1.0 / n_steps) if n_steps else 0.0
    err = lib.sb_integrate(
        JT.data_ptr(), x0.data_ptr(), y0.data_ptr(), out.data_ptr(), P, R, N,
        _VARIANT_CODE[variant], block_r, int(n_steps), _f32(a0 * dt),
        _f32(dt), _f32(a0), inv,
        torch.cuda.current_stream(Jc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sb_integrate launch failed: cudaError {err}")
    launches[KERNEL_NAMES[variant]] += 1
    return out
