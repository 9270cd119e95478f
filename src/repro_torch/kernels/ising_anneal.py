"""The whole-anneal kernel: CUDA wrapper, launch plan and plain version.

``fused_anneal_kernel`` replaces the TPU kernel
``src/repro/kernels/ising_anneal.py:59 _anneal_kernel``. On a CUDA tensor it
launches ``csrc/ising_anneal.cu`` (built with ``nvcc`` at first use, see
``kernels/build.py``) on the current stream, or raises; it never falls back.
On CPU tensors it runs ``fused_anneal_torch``, the plain version, at any N;
the CPU tests hold it against the reference and ``chip_smoke.py`` holds the
kernel against it on the card.

One launch runs the whole anneal: T steps of {ADC -> column scale ->
matvec -> integrate -> clip}, the schedule derived in-kernel from the step
index. j_dtype variants, as in the reference:
  'float32'  — exact for every schedule; on the CUDA cores, one fmaf chain
               per (spin, run) in ascending j.
  'bfloat16' — J and the scaled spins in bf16, f32 accumulation, on the
               tensor cores (``mma.sync`` m16n8k16). Exact on the unit
               schedule; rounds the leak decay otherwise. Every partial sum
               is exact in f32 under the default device model (see
               ``tests/test_torch_kernel.py``), so the kernel's order gives
               the plain version's bits under both schedules.
  'int8'     — unit schedule only: ±1 spins x int8 levels on the tensor
               cores (m16n8k32), int32 accumulation, then ·drive_dt.
               Bit-exact vs float32 for |levels| <= 127 and a power-of-two
               drive_dt.

The launch geometry comes from ``anneal_launch_plan``, pure arithmetic that
the CPU tests check and the C side checks again. The J operand is laid out
by the wrapper (``mma_fragment_index`` for the tensor-core variants: each
lane's B fragments contiguous, so a warp reads them without bank
conflicts; J^T padded for f32).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.binarize import sign_pm1
from .build import check_launch
from ..core.device_model import DeviceModel
from ..core.perturbation import (PerturbationConfig, scales_from_cols,
                                 unit_scales)

#: runs per block; None: the plan's pick (``anneal_launch_plan``)
DEFAULT_BLOCK_R = None
J_DTYPES = ("float32", "bfloat16", "int8")
#: largest spin count the kernel takes (16 warps of 64 spins a run tile)
MAX_N = 1024
SOURCE = "ising_anneal.cu"
#: tag of the kernel design, part of the engine's autotune cache key, so
#: that a block_r tuned for another design is never applied to this one
KERNEL_DESIGN = "mma-v1"
#: the launch geometry's limits, as ``csrc/ising_anneal.cu`` checks them
SMEM_MAX = 232448          # opt-in shared memory of one block on sm_90
SMEM_SM = 233472           # shared memory of one SM
REGS_SM = 65536
#: blocks of one launch: all on grid.x, problem-major
MAX_BLOCKS = 2**31 - 1
#: the kernels' __launch_bounds__: the register regime (up to 255
#: registers a thread), the split kernels
MAX_THREADS = {"registers": 256, "split": 512}
REG_N = 64                 # the register regime's spins (N <= 64, padded)
REGIMES = ("registers", "shared", "streamed")
#: runs a warp owns: the mma's M for bf16 / int8, the thread tile for f32
RUNS_PER_WARP = {"float32": 8, "bfloat16": 16, "int8": 16}
#: spins a warp owns above 64 spins: four a lane for f32 on the CUDA cores,
#: two a lane (eight n-tiles of the mma) for bf16 / int8
SPLIT_SLICE = {"float32": 128, "bfloat16": 64, "int8": 64}

_J_CODE = {"float32": 0, "bfloat16": 1, "int8": 2}
_REGIME_CODE = {"registers": 0, "shared": 1, "streamed": 2}
_J_STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}
_J_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
#: kernel name per variant, as counted and reported
KERNEL_NAMES = {"float32": "ising_anneal_f32", "bfloat16": "ising_anneal_bf16",
                "int8": "ising_anneal_int8"}
#: launches of the CUDA kernel per variant name; the wrapper adds one where
#: it launches the kernel and nowhere else.
launches = {name: 0 for name in KERNEL_NAMES.values()}

#: int8 k slots: slot k = 16h + 4c + i of an m16n8k32 k-tile (quad lane c,
#: byte i of register h) holds column 16h + 8(i//2) + 2c + i%2, the spins
#: that lane already holds in its accumulator (n-tiles 2h and 2h+1, columns
#: 2c and 2c+1). J^T's rows are laid out in this order; csrc packs the A
#: fragment by the same rule.
INT8_K_PERM = tuple(16 * h + 8 * (i // 2) + 2 * c + i % 2
                    for h in range(2) for c in range(4) for i in range(4))


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


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AnnealLaunchPlan:
    """The anneal kernel's launch geometry (``anneal_launch_plan``).

    A run tile is ``runs_per_warp`` runs of one problem, annealed by
    ``warps_per_tile`` warps, each owning ``spins_per_warp`` of the
    ``n_pad`` spins; a block holds ``tiles_per_block`` run tiles
    (``block_r`` runs) of one problem. ``regime`` says where J^T lives:
    in each warp's registers (N <= 64, one warp a tile), in the block's
    shared memory, or streamed from device memory through L2 each step.
    ``j_rows`` is the row count of the J operand the wrapper lays out.
    ``registers`` is the design's count of the registers a thread keeps
    live through the anneal (J, voltages, sums, operands), not the
    compiler's figure (``build.ptxas_report`` has that)."""
    regime: str
    j_dtype: str
    n_pad: int
    j_rows: int
    spins_per_warp: int
    runs_per_warp: int
    warps_per_tile: int
    tiles_per_block: int
    block_r: int
    threads: int
    smem_bytes: int
    blocks: int
    waves: int
    registers: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _geometry(regime: str, j_dtype: str, N: int, G: int):
    """(spins_per_warp, n_pad, j_rows, warps_per_tile, threads, smem_bytes,
    registers) of one candidate geometry."""
    slice_ = REG_N if regime == "registers" else SPLIT_SLICE[j_dtype]
    if j_dtype == "float32":
        if regime == "registers":
            n_pad = rows = REG_N
            W = 1
            # rows: per warp, the step's scaled spins of 8 runs, twice
            smem = G * 2 * REG_N * 8 * 4
            regs = 2 * REG_N + 16 + 16 + 8 + _REG_OVERHEAD
        else:
            n_pad, rows = _round_up(N, slice_), N
            W = n_pad // slice_
            smem = G * 2 * N * 8 * 4
            if regime == "shared":
                smem += N * n_pad * 4
            regs = 32 + 32 + 8 + 4 + _REG_OVERHEAD
    else:
        n_pad = rows = REG_N if regime == "registers" else _round_up(N, slice_)
        W = n_pad // slice_
        k = 16 if j_dtype == "bfloat16" else 32
        # A fragments: a 512-byte tile a k-tile, double-buffered by step
        smem = 0 if regime == "registers" else G * 2 * (n_pad // k) * 512
        if regime == "shared":
            smem += n_pad * n_pad * _J_BYTES[j_dtype]
        # v and the sums (16 runs x the slice over 32 lanes each), one A
        # fragment, then all of J^T (registers) or one B fragment pair
        b = (REG_N * REG_N * _J_BYTES[j_dtype] // 4 // 32
             if regime == "registers" else 4)
        regs = slice_ // 2 + slice_ // 2 + 4 + b + _REG_OVERHEAD
    return slice_, n_pad, rows, W, 32 * G * W, smem, regs


#: registers a thread spends beyond its tile's arrays (indices, schedule,
#: addresses), about what ``-Xptxas -v`` reports for the H100 build
_REG_OVERHEAD = 40
#: the plan's cost model: an SM runs one warp-step in about the time it
#: issues this many warps' steps (a step is a dependent chain; with fewer
#: warps resident, latency binds and adding warps is free)
_LATENCY_WARPS = 16


def anneal_launch_plan(P: int, R: int, N: int, j_dtype: str, sm_count: int,
                       block_r: int | None = None,
                       regime: str | None = None) -> AnnealLaunchPlan:
    """Launch geometry of the anneal kernel for J (P,N,N) and v0 (P,R,N)
    on a card of ``sm_count`` SMs (``card_sm_count``).

    Pure arithmetic on the shape. The regime: J^T in registers where N <=
    64, else in shared memory where it fits beside the step buffers, else
    streamed. ``block_r`` (runs per block, a multiple of ``RUNS_PER_WARP``)
    defaults to the run tiles a block (1, 2, 4 or 8) of the least modelled
    time: waves x max(``_LATENCY_WARPS``, warps resident on an SM), the
    fewest tiles a block on a tie. ``regime`` forces another geometry (it
    gives the same result bit for bit). Raises ValueError for N above
    ``MAX_N`` and for a geometry the kernel does not take."""
    if j_dtype not in J_DTYPES:
        raise ValueError(f"j_dtype must be one of {J_DTYPES}, got {j_dtype!r}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"the anneal kernel supports 1 <= N <= {MAX_N}, "
                         f"got {N}")
    if P < 1 or R < 1:
        raise ValueError(f"need P >= 1 and R >= 1, got P={P}, R={R}")
    rpw = RUNS_PER_WARP[j_dtype]
    if block_r is not None and (int(block_r) < 1 or block_r % rpw):
        raise ValueError(f"block_r must be a positive multiple of {rpw} "
                         f"for {j_dtype}, got {block_r}")
    if regime is None:
        if N <= REG_N:
            regime = "registers"
        else:
            fits = _geometry("shared", j_dtype, N, 1)[5] <= SMEM_MAX
            regime = "shared" if fits else "streamed"
    if regime not in REGIMES or (regime == "registers" and N > REG_N):
        raise ValueError(f"regime {regime!r} does not take N={N}")
    max_threads = MAX_THREADS["registers" if regime == "registers"
                              else "split"]

    def make(G):
        slice_, n_pad, rows, W, threads, smem, regs = _geometry(
            regime, j_dtype, N, G)
        blocks = P * -(-R // (G * rpw))
        if threads > max_threads or smem > SMEM_MAX or blocks > MAX_BLOCKS:
            return None
        per_sm = min(32, 64 // (G * W), REGS_SM // (threads * regs),
                     SMEM_SM // (smem + 1024))
        if per_sm < 1:
            return None
        return AnnealLaunchPlan(regime, j_dtype, n_pad, rows, slice_, rpw, W,
                                G, G * rpw, threads, smem, blocks,
                                -(-blocks // (sm_count * per_sm)), regs)

    def cost(plan):
        per_sm = -(-plan.blocks // (sm_count * plan.waves))
        warps = per_sm * plan.tiles_per_block * plan.warps_per_tile
        return plan.waves * max(_LATENCY_WARPS, warps)

    if block_r is not None:
        plan = make(block_r // rpw)
        if plan is None:
            raise ValueError(f"no {j_dtype} {regime} plan with block_r "
                             f"{block_r} at N={N}")
        return plan
    plans = [pl for pl in map(make, (1, 2, 4, 8)) if pl is not None]
    if not plans:
        raise ValueError(f"no {j_dtype} {regime} plan at N={N}")
    return min(plans, key=cost)


def anneal_block_r_candidates(P: int, R: int, N: int, j_dtype: str,
                              sm_count: int) -> list[int]:
    """Runs per block that ``anneal_launch_plan`` accepts for this shape
    in its default regime: the autotuner's candidates."""
    rpw = RUNS_PER_WARP[j_dtype]
    out = []
    for G in (1, 2, 4, 8):
        try:
            anneal_launch_plan(P, R, N, j_dtype, sm_count, block_r=G * rpw)
        except ValueError:
            continue
        out.append(G * rpw)
    return out


def kernel_function(plan: AnnealLaunchPlan) -> str:
    """A substring of the mangled name of the kernel instance that runs
    ``plan`` (as ``-Xptxas -v`` and ``cuobjdump`` print it)."""
    r = _REGIME_CODE[plan.regime]
    if plan.j_dtype != "float32":
        return f"anneal_mmaILi{_J_CODE[plan.j_dtype]}ELi{r}E"
    if plan.regime == "registers":
        return "anneal_f32_registers"
    return f"anneal_f32_splitILi{r}E"


# ---------------------------------------------------------------------------
# J layouts
# ---------------------------------------------------------------------------

def mma_fragment_index(n_pad: int, j_dtype: str) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Index tensors (n, k), each (KT, n_pad/16, 32, E), that lay J out as
    the tensor cores' B operand of dv = A @ J^T: entry [kt, u, lane, e] is
    J[n, k], so that lane ``lane`` finds its B fragments of n-tiles 2u and
    2u+1 of k-tile kt in 16 contiguous bytes (four 32-bit registers: b0,
    b1 of n-tile 2u, then of 2u+1). E = 8 bf16 (k-tiles of 16) or 16 int8
    (k-tiles of 32, rows in ``INT8_K_PERM`` order). With g = lane // 4,
    c = lane % 4, register q: n = 8(2u + q//2) + g; bf16 element h of
    register q: k = 16kt + 2c + h + 8(q%2); int8 byte i of register q:
    k = 32kt + INT8_K_PERM[16(q%2) + 4c + i]."""
    kw = 16 if j_dtype == "bfloat16" else 32
    per = 2 if j_dtype == "bfloat16" else 4        # elements a register
    kt = torch.arange(n_pad // kw)[:, None, None, None]
    u = torch.arange(n_pad // 16)[None, :, None, None]
    lane = torch.arange(32)[None, None, :, None]
    e = torch.arange(4 * per)[None, None, None, :]
    g, c = lane // 4, lane % 4
    q, h = e // per, e % per
    n = 8 * (2 * u + q // 2) + g
    if j_dtype == "bfloat16":
        k = 16 * kt + 2 * c + h + 8 * (q % 2)
    else:
        perm = torch.tensor(INT8_K_PERM)
        k = 32 * kt + perm[16 * (q % 2) + 4 * c + h]
    shape = (n_pad // kw, n_pad // 16, 32, 4 * per)
    return n.expand(shape), k.expand(shape)


_index_cache: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def layout_j(J: torch.Tensor, plan: AnnealLaunchPlan) -> torch.Tensor:
    """J (P,N,N) float32 levels as the kernel reads them: for f32, J^T
    zero-padded to (P, j_rows, n_pad); for bf16 / int8, the fragment order
    of ``mma_fragment_index`` over J zero-padded to n_pad, in the variant's
    storage type (levels are exact in bf16 and int8)."""
    P, N, _ = J.shape
    store = _J_STORE[plan.j_dtype]
    if plan.j_dtype == "float32":
        Jt = J.new_zeros((P, plan.j_rows, plan.n_pad))
        Jt[:, :N, :N] = J.transpose(-1, -2)
        return Jt
    key = (plan.n_pad, plan.j_dtype, str(J.device))
    if key not in _index_cache:
        n, k = mma_fragment_index(plan.n_pad, plan.j_dtype)
        _index_cache[key] = (n.to(J.device), k.to(J.device))
    n, k = _index_cache[key]
    Jp = J.new_zeros((P, plan.n_pad, plan.n_pad), dtype=store)
    Jp[:, :N, :N] = J.to(store)
    return Jp[:, n, k].contiguous()


# ---------------------------------------------------------------------------
# the CUDA wrapper
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    from . import build
    lib = build.load(SOURCE)
    fn = lib.ising_anneal
    if fn.argtypes is None:
        i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i, i,
                       i, i, i, f, i, f, f, f, f, p]
        fn.restype = i
    return lib


def card_sm_count(device: str | torch.device = "cuda") -> int:
    """The SM count of the card ``device``: the launch plan's ``sm_count``
    wherever the kernel is planned for a card."""
    return torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count


def card_plan(P: int, R: int, N: int, j_dtype: str,
              block_r: int | None = None,
              device: str | torch.device = "cuda") -> AnnealLaunchPlan:
    """The plan ``fused_anneal_kernel`` launches on ``device`` for
    ``block_r``: ``anneal_launch_plan`` with the card's SM count."""
    return anneal_launch_plan(P, R, N, j_dtype, card_sm_count(device),
                              block_r)


def fused_anneal_kernel(J: torch.Tensor, v0: torch.Tensor, *,
                        dev: DeviceModel, pert: PerturbationConfig,
                        block_r: int | None = DEFAULT_BLOCK_R,
                        j_dtype: str = "float32",
                        plan: AnnealLaunchPlan | None = None) -> torch.Tensor:
    """Whole anneal of J (P,N,N) float32 levels from v0 (P,R,N) float32 ->
    v_final (P,R,N). CUDA tensors launch the kernel (one launch per call,
    its geometry ``plan``, by default ``card_plan`` for ``block_r``); CPU
    tensors run the plain version at any N. Neither block_r nor the plan
    changes the result."""
    _check_args(j_dtype, dev, pert)
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
    if N > MAX_N:
        raise ValueError(f"the anneal kernel supports N <= {MAX_N}, got {N}")
    if block_r is not None and block_r < 1:
        raise ValueError(f"block_r must be >= 1, got {block_r}")
    if P == 0 or R == 0 or N == 0:
        return v0.clone()
    if plan is None:
        plan = card_plan(P, R, N, j_dtype, block_r, J.device)
    elif plan.j_dtype != j_dtype:
        raise ValueError(f"plan is for {plan.j_dtype}, not {j_dtype}")

    lib = _library()
    Jl = layout_j(J, plan)
    out = torch.empty_like(v0)
    C = dev.cols_per_tile
    pert_on = pert.enabled
    err = lib.ising_anneal(
        Jl.data_ptr(), v0.data_ptr(), out.data_ptr(), P, R, N,
        _J_CODE[j_dtype], _REGIME_CODE[plan.regime], plan.n_pad, plan.j_rows,
        plan.spins_per_warp, plan.warps_per_tile, plan.tiles_per_block,
        plan.smem_bytes, dev.n_steps, dev.substeps, C,
        int(pert_on), pert.period_slots if pert_on else 1, pert.off_slots,
        (dev.anneal_sweeps - pert.settle_sweeps) * C,
        int(dev.has_leakage),
        C * dev.tau_leak_sweeps if dev.has_leakage else 1.0,
        float(dev.drive_eff * dev.dt), float(dev.vdd), float(dev.threshold),
        torch.cuda.current_stream(J.device).cuda_stream)
    check_launch(err, "ising_anneal", plan)
    launches[KERNEL_NAMES[j_dtype]] += 1
    return out
