"""The simulated-bifurcation kernel: CUDA wrapper and plain PyTorch version.

``fused_sb_kernel`` replaces the TPU kernel
``src/repro/kernels/sb_kernel.py:79 _sb_kernel``. On CUDA tensors it
launches ``csrc/sb_kernel.cu`` (built with ``nvcc`` at first use, see
``kernels/build.py``) on the current stream, or raises; it never falls back.
On CPU tensors it runs ``sb_reference``, the plain version, which the CPU
tests hold against the reference and ``chip_smoke.py`` holds the kernel
against on the card. The launch geometry (thread-block clusters that split
the spins, sized so that every cluster is on the card at once) comes from
``sb_launch_plan``, pure arithmetic that the CPU tests check.

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
import dataclasses

import numpy as np
import torch

from ..core.binarize import sign_pm1
from .build import check_launch

SB_VARIANTS = ("aSB", "bSB", "dSB")
#: runs per cluster. None: the plan takes the fewest runs per cluster (in
#: whole 4-run thread tiles) that put every cluster on the card at once;
#: at the Gset shape (P=1, R=256, N=2048) on an H100 that is 7 clusters of
#: 16 CTAs, 40 runs each. The runs are independent, so block_r changes no
#: result.
DEFAULT_BLOCK_R = None
#: runs per CTA where Jc^T stays resident in shared memory (small N)
RESIDENT_BLOCK_R = 16
#: largest spin count the kernel takes (a cluster of 16 CTAs of 512 spins)
MAX_N = 8192
#: the launch geometry's limits, as ``csrc/sb_kernel.cu`` checks them
SMEM_MAX = 232448          # opt-in shared memory of one block on sm_90
MAX_THREADS = 320          # the kernel's __launch_bounds__
MAX_CLUSTER = 16           # above 8 a non-portable cluster size
RUNS_PER_PASS_MAX = 64
#: the plan's cost model of one step on an H100: f32 lane operations a
#: second an SM reaches in the ordered sum with 8 warps or more (128 lanes
#: at 1.98 GHz, ~70% issued), and the L2's bytes a second
SM_LANE_OPS = 128 * 1.98e9 * 0.7
L2_BYTES = 3.5e12
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


@dataclasses.dataclass(frozen=True)
class SBLaunchPlan:
    """The SB kernel's launch geometry (``sb_launch_plan``). A cluster of
    ``cluster`` CTAs owns ``block_r`` runs of one problem and integrates
    them in passes of ``runs_per_pass``; CTA c owns spins [c*S, (c+1)*S)
    with S = ``spins_per_cta``. Each thread owns 4 spins x 4 runs. The
    first nine fields are what ``sb_integrate`` takes and checks."""
    regime: str             # "resident" (Jc^T in shared memory) or "cluster"
    cluster: int
    block_r: int
    runs_per_pass: int
    spins_per_cta: int
    tile_j: int             # rows of Jc^T a ring stage (0: resident)
    stages: int             # ring depth (0: resident)
    threads: int
    smem_bytes: int
    ctas: int
    waves: int              # rounds of clusters the card runs one after another


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem(regime: str, N: int, S: int, rc: int, tj: int, stages: int) -> int:
    pub = 2 * S * rc                      # the double-buffered drive table
    if regime == "resident":
        return 4 * (N * S + pub)
    # the ring, the staged drive tiles, the drive table, an mbarrier a stage
    return 4 * (stages * tj * S + 2 * tj * rc + pub) + 8 * stages


def _cluster_shapes(N: int, C: int, rc_max: int):
    """Per-CTA geometries of a cluster of C over N spins, most runs a pass
    first, then the deepest tiles and ring that fit: (rc, S, tj, stages,
    threads, smem). S is a multiple of tj and no CTA is empty."""
    for rc in range(rc_max, 0, -4):
        for tj in (128, 64, 32, 16, 8):
            S = _round_up(-(-N // C), tj)
            threads = (S // 4) * (rc // 4)
            if -(-N // S) < C or threads > MAX_THREADS:
                continue
            for stages in (4, 3, 2):
                smem = _smem("cluster", N, S, rc, tj, stages)
                if smem <= SMEM_MAX:
                    yield rc, S, tj, stages, threads, smem
                    break
            else:
                continue
            break


def sb_launch_plan(P: int, R: int, N: int, block_r: int | None,
                   capacity) -> SBLaunchPlan:
    """Launch geometry of the SB kernel for Jc (P,N,N) and x0 (P,R,N).

    Pure arithmetic on the shape and ``capacity(regime, cluster, threads,
    smem_bytes)``, the clusters the card holds at once (``sb_card_plan``
    asks the CUDA runtime). The C side checks the plan. Jc^T stays
    resident in one CTA's shared memory where it fits (N up to ~220,
    ``RESIDENT_BLOCK_R`` runs a CTA unless ``block_r`` says otherwise).
    Otherwise the spins are split over a cluster of C CTAs,
    each streaming its panel of Jc^T in tiles of ``tile_j`` rows through a
    ring of ``stages``, each filled by one bulk copy. ``block_r`` is the
    runs per cluster; None takes the fewest that fit every cluster in one
    wave. Among the cluster sizes and per-CTA shapes that fit 320 threads
    and the shared memory (runs a pass a multiple of 4, at most 64), the
    plan takes the least modelled step time (the slowest CTA's ordered
    sums plus the L2 traffic of Jc^T), then the least traffic.
    """
    if block_r is not None and int(block_r) < 1:
        raise ValueError(f"block_r must be >= 1, got {block_r}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"the SB kernel supports 1 <= N <= {MAX_N}, "
                         f"got {N}")
    if P < 1 or R < 1:
        raise ValueError(f"need P >= 1 and R >= 1, got P={P}, R={R}")

    br = RESIDENT_BLOCK_R if block_r is None else int(block_r)
    rc = min(_round_up(min(br, R), 4), RUNS_PER_PASS_MAX)
    S = _round_up(N, 4)
    smem = _smem("resident", N, S, rc, 0, 0)
    threads = (S // 4) * (rc // 4)
    if threads <= MAX_THREADS and smem <= SMEM_MAX:
        ctas = P * -(-R // br)
        cap = max(capacity("resident", 1, threads, smem), 1)
        return SBLaunchPlan("resident", 1, br, rc, S, 0, 0, threads, smem,
                            ctas, -(-ctas // cap))

    best, best_key = None, None
    for C in range(1, MAX_CLUSTER + 1):
        for rc, S, tj, stages, threads, smem in _cluster_shapes(
                N, C, RUNS_PER_PASS_MAX):
            cap = capacity("cluster", C, threads, smem)
            if cap < 1:
                continue
            if block_r is None:  # the fewest runs a cluster for one wave,
                br = -(-R // max(cap // P, 1))  # whole 4-run thread tiles
                br = _round_up(br, 4) if R >= 4 else br
            else:
                br = int(block_r)
            rc_used = min(rc, _round_up(min(br, R), 4))
            clusters = P * -(-R // br)
            waves = -(-clusters // cap)
            passes = -(-br // rc_used)
            threads_used = (S // 4) * (rc_used // 4)
            # an SM issues at its rate with 8 warps or more, in proportion
            # below that
            rate = SM_LANE_OPS * min(threads_used, 256) / 256
            compute = waves * passes * rc_used * S * N * 2 / rate
            traffic = clusters * C * S * _round_up(N, tj) * 4
            # the copies and the sums overlap only in part: add them
            key = (compute + traffic / L2_BYTES, traffic, C)
            if best_key is None or key < best_key:
                best_key = key
                best = SBLaunchPlan(
                    "cluster", C, br, rc_used, S, tj, stages, threads_used,
                    _smem("cluster", N, S, rc_used, tj, stages),
                    clusters * C, waves)
    if best is None:
        raise ValueError(f"no SB launch plan for P={P}, R={R}, N={N}, "
                         f"block_r={block_r}")
    return best


_REGIME_CODE = {"resident": 0, "cluster": 1}
#: the kernel function that runs each regime, as ``-Xptxas -v`` names it
KERNEL_FUNCTION = {"resident": "sb_resident", "cluster": "sb_cluster"}


def _panels(Jc: torch.Tensor, plan: SBLaunchPlan) -> tuple[torch.Tensor, int]:
    """Jc^T cut into the plan's per-CTA panels: (P, cluster, rows, S) with
    ``panels[p, c, j, s] = Jc[p, c*S + s, j]``, zero past N, so that a tile
    of a CTA's columns is one contiguous copy and neighbouring threads
    (neighbouring spins) read neighbouring words. ``rows`` is N (resident)
    or N rounded up to whole tiles."""
    P, N, _ = Jc.shape
    C, S = plan.cluster, plan.spins_per_cta
    rows = N if plan.regime == "resident" else _round_up(N, plan.tile_j)
    padded = Jc.new_zeros((P, C * S, rows))
    padded[:, :N, :N] = Jc
    return padded.view(P, C, S, rows).transpose(-1, -2).contiguous(), rows


_capacity_cache: dict[tuple, int] = {}


def _card_capacity(lib: ctypes.CDLL, device: torch.device):
    """``capacity`` for ``sb_launch_plan`` from the CUDA runtime
    (``cudaOccupancyMaxActiveClusters``): the clusters of
    a geometry that the card holds at once (0 where none fits), cached."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()

    def capacity(regime: str, cluster: int, threads: int,
                 smem_bytes: int) -> int:
        key = (index, regime, cluster, threads, smem_bytes)
        if key not in _capacity_cache:
            with torch.cuda.device(index):
                n = lib.sb_cluster_capacity(_REGIME_CODE[regime], cluster,
                                            threads, smem_bytes)
            if n < 0:
                raise RuntimeError(f"sb_cluster_capacity({regime}, "
                                   f"{cluster}, {threads}, {smem_bytes}) "
                                   f"failed: cudaError {-n}")
            _capacity_cache[key] = n
        return _capacity_cache[key]
    return capacity


def _library() -> ctypes.CDLL:
    from . import build
    lib = build.load(SOURCE)
    fn = lib.sb_integrate
    if fn.argtypes is None:
        i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, f, f,
                       i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
        cap = lib.sb_cluster_capacity
        cap.argtypes = [i, i, i, i]
        cap.restype = i
    return lib


def sb_card_plan(P: int, R: int, N: int, block_r: int | None = None,
                 device: str | torch.device = "cuda") -> SBLaunchPlan:
    """The plan ``fused_sb_kernel`` launches on ``device``: ``sb_launch_plan``
    with the card's own cluster capacity."""
    device = torch.device(device)
    return sb_launch_plan(P, R, N, block_r,
                          capacity=_card_capacity(_library(), device))


def fused_sb_kernel(Jc: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                    *, variant: str = "bSB", n_steps: int = 400,
                    dt: float = 0.5, a0: float = 1.0,
                    block_r: int | None = DEFAULT_BLOCK_R) -> torch.Tensor:
    """Whole SB integration of Jc (P,N,N) float32 from x0, y0 (P,R,N)
    float32 -> x_final (P,R,N). CUDA tensors launch the kernel (one launch
    per call, its geometry from ``sb_launch_plan``); CPU tensors run the
    plain version. ``block_r`` (runs per cluster, default
    ``DEFAULT_BLOCK_R``) changes no result."""
    check_variant(variant)
    if block_r is not None and int(block_r) < 1:
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

    plan = sb_card_plan(P, R, N, block_r, Jc.device)
    lib = _library()
    JT, rows = _panels(Jc, plan)
    out = torch.empty_like(x0)
    inv = _f32(1.0 / n_steps) if n_steps else 0.0
    err = lib.sb_integrate(
        JT.data_ptr(), x0.data_ptr(), y0.data_ptr(), out.data_ptr(), P, R, N,
        rows, _VARIANT_CODE[variant], int(n_steps), _f32(a0 * dt), _f32(dt),
        _f32(a0), inv, _REGIME_CODE[plan.regime], plan.cluster, plan.block_r,
        plan.runs_per_pass, plan.spins_per_cta, plan.tile_j, plan.stages,
        plan.threads, plan.smem_bytes,
        torch.cuda.current_stream(Jc.device).cuda_stream)
    check_launch(err, "sb_integrate", plan)
    launches[KERNEL_NAMES[variant]] += 1
    return out
