"""The whole-anneal kernel: CUDA wrapper and its plain PyTorch version.

``fused_anneal_kernel`` replaces the TPU kernel
``src/repro/kernels/ising_anneal.py:59 _anneal_kernel``. On a CUDA tensor it
launches ``csrc/ising_anneal.cu`` (built with ``nvcc`` at first use, see
``kernels/build.py``) on the current stream, or raises; it never falls back.
On CPU tensors it runs ``fused_anneal_torch``, the plain version, which the
CPU tests hold against the reference and ``chip_smoke.py`` holds the kernel
against on the card.

One launch runs the whole anneal: T steps of {ADC -> column scale ->
matvec -> integrate -> clip}, the schedule derived in-kernel from the step
index. j_dtype variants, as in the reference:
  'float32'  — exact for every schedule.
  'bfloat16' — J and the scaled spins in bf16, f32 accumulation. Exact on
               the unit schedule; rounds the leak decay otherwise.
  'int8'     — unit schedule only: ±1 spins x int8 levels, int32
               accumulation, then ·drive_dt. Bit-exact vs float32 for
               |levels| <= 127 and a power-of-two drive_dt.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.binarize import sign_pm1
from ..core.device_model import DeviceModel
from ..core.perturbation import (PerturbationConfig, scales_from_cols,
                                 unit_scales)

DEFAULT_BLOCK_R = 128
J_DTYPES = ("float32", "bfloat16", "int8")
MAX_N = 128
SOURCE = "ising_anneal.cu"

_J_CODE = {"float32": 0, "bfloat16": 1, "int8": 2}
_J_STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}
#: kernel name per variant, as counted and reported
KERNEL_NAMES = {"float32": "ising_anneal_f32", "bfloat16": "ising_anneal_bf16",
                "int8": "ising_anneal_int8"}
#: launches of the CUDA kernel per variant name; the wrapper adds one where
#: it launches the kernel and nowhere else.
launches = {name: 0 for name in KERNEL_NAMES.values()}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_args(j_dtype: str, dev: DeviceModel, pert: PerturbationConfig):
    if j_dtype not in J_DTYPES:
        raise ValueError(f"j_dtype must be one of {J_DTYPES}, got {j_dtype!r}")
    if j_dtype == "int8" and not unit_scales(dev, pert):
        raise ValueError("int8 J path requires a unit schedule "
                         "(no perturbation, no finite leakage)")


def fused_anneal_torch(J: torch.Tensor, v0: torch.Tensor, dev: DeviceModel,
                       pert: PerturbationConfig,
                       j_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of the kernel: a loop over steps with the
    kernel's grouping. J (P,N,N) float32 levels, v0 (P,R,N) -> v_final.

    Two CUDA facts shape it: torch's CUDA matmul has no int8/int32 kernel,
    so the int8 variant contracts ±1 x levels in float32 (exact below
    2^24) and casts the sum to int32; and a bf16 matmul returns bf16, so the
    bf16 variant upcasts both bf16 operands before an f32 product, which is
    the reference's ``preferred_element_type=f32``.
    """
    _check_args(j_dtype, dev, pert)
    J = J.to(torch.float32)
    v = v0.to(torch.float32)
    drive_dt = float(dev.drive_eff * dev.dt)
    Jt = J.to(_J_STORE[j_dtype]).to(torch.float32).transpose(-1, -2)
    Jt = Jt.contiguous()
    steps = torch.arange(dev.n_steps, device=J.device)[:, None]
    cols = torch.arange(J.shape[-1], device=J.device)[None, :]
    scales = scales_from_cols(steps, cols, dev, pert) * drive_dt   # (T, N)
    for t in range(dev.n_steps):
        q = sign_pm1(v, dev.threshold)
        if j_dtype == "int8":
            acc = torch.matmul(q, Jt).to(torch.int32)
            dv = acc.to(torch.float32) * drive_dt
        else:
            sq = q * scales[t]
            if j_dtype == "bfloat16":
                sq = sq.to(torch.bfloat16).to(torch.float32)
            dv = torch.matmul(sq, Jt)
        v = torch.clamp(v + dv, 0.0, dev.vdd)
    return v


def _library() -> ctypes.CDLL:
    from . import build
    lib = build.load(SOURCE)
    fn = lib.ising_anneal
    if fn.argtypes is None:
        i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, i, f, i, f, f,
                       f, f, p]
        fn.restype = i
    return lib


def fused_anneal_kernel(J: torch.Tensor, v0: torch.Tensor, *,
                        dev: DeviceModel, pert: PerturbationConfig,
                        block_r: int = DEFAULT_BLOCK_R,
                        j_dtype: str = "float32") -> torch.Tensor:
    """Whole anneal of J (P,N,N) float32 levels from v0 (P,R,N) float32 ->
    v_final (P,R,N). CUDA tensors launch the kernel (one launch per call);
    CPU tensors run the plain version."""
    _check_args(j_dtype, dev, pert)
    if J.shape[-1] > MAX_N:
        raise ValueError(f"the anneal kernel supports N <= {MAX_N}, "
                         f"got {J.shape[-1]}")
    if J.device.type == "cpu" and v0.device.type == "cpu":
        return fused_anneal_torch(J, v0, dev, pert, j_dtype)
    if J.device.type != "cuda" or J.device != v0.device:
        raise ValueError(f"J and v0 must both be on one CUDA device (or both "
                         f"on the CPU), got {J.device} and {v0.device}")
    if J.dtype != torch.float32 or v0.dtype != torch.float32:
        raise TypeError(f"J and v0 must be float32, got {J.dtype}, {v0.dtype}")
    if J.dim() != 3 or J.shape[1] != J.shape[2] or v0.dim() != 3 or \
            v0.shape[0] != J.shape[0] or v0.shape[2] != J.shape[2]:
        raise ValueError(f"need J (P,N,N) and v0 (P,R,N), got "
                         f"{tuple(J.shape)} and {tuple(v0.shape)}")
    if not (J.is_contiguous() and v0.is_contiguous()):
        raise ValueError("J and v0 must be contiguous")
    P, N, _ = J.shape
    R = v0.shape[1]
    if block_r < 1:
        raise ValueError(f"block_r must be >= 1, got {block_r}")
    if P == 0 or R == 0:
        return torch.empty_like(v0)

    lib = _library()
    Js = J.to(_J_STORE[j_dtype]).contiguous()   # levels are exact in bf16/int8
    out = torch.empty_like(v0)
    C = dev.cols_per_tile
    pert_on = pert.enabled
    err = lib.ising_anneal(
        Js.data_ptr(), v0.data_ptr(), out.data_ptr(), P, R, N,
        _J_CODE[j_dtype], block_r, dev.n_steps, dev.substeps, C,
        int(pert_on), pert.period_slots if pert_on else 1, pert.off_slots,
        (dev.anneal_sweeps - pert.settle_sweeps) * C,
        int(dev.has_leakage),
        C * dev.tau_leak_sweeps if dev.has_leakage else 1.0,
        float(dev.drive_eff * dev.dt), float(dev.vdd), float(dev.threshold),
        torch.cuda.current_stream(J.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ising_anneal launch failed: cudaError {err}")
    launches[KERNEL_NAMES[j_dtype]] += 1
    return out
