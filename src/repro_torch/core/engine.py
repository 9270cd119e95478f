"""AnnealEngine — the single dispatching front-end for every anneal path.

Two ways to integrate the chip dynamics:

  'scan'   — ``core.annealer.anneal``: a torch loop of plain ops. Runs on
             any device, supports noise and energy-trajectory recording.
  'fused'  — ``kernels.ising_anneal.fused_anneal_kernel``: the whole anneal
             in one CUDA kernel launch, schedule derived in-kernel. On CPU
             tensors the wrapper runs the kernel's plain version.

``AnnealEngine`` owns the choice: callers hand it (J, v0) and get an
``AnnealResult`` back. Dispatch rules:

  1. Features first: noise or trajectory recording forces 'scan' (the fused
     kernel never materializes intermediates); on the card that is torch
     ops on the card.
  2. Explicit ``path=`` wins otherwise.
  3. 'auto': 'fused' on a CUDA device, 'scan' on the CPU. A cache entry
     never changes that choice: it only supplies the kernel's block_r.
  4. j_dtype auto-selection: 'int8' when the schedule is identically one
     (``unit_scales``), J is integer levels and drive·dt is a power of two
     (bit-exact fast path); otherwise the device model's compute dtype.
  5. block_r (runs per kernel block): autotune-cache hit, else None: the
     kernel wrapper launches ``kernels.ising_anneal.anneal_launch_plan``'s
     pick for the card (the plan is made once, where it is launched).

The autotuner times real (shortened) anneals for each candidate (on CUDA
the kernel at each block_r the launch plan accepts; on the CPU the scan
path) and persists winners to a small JSON cache keyed on (torch device,
N, R, P, j_dtype, schedule kind, kernel design). Default path
``~/.cache/repro_torch/annealengine.json``, overridden by
``REPRO_TORCH_AUTOTUNE_CACHE``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..device import device_key, resolve_device
from ..utils import load_json_cache, store_json_cache
from .annealer import AnnealResult, anneal
from .device_model import DeviceModel
from .perturbation import DEFAULT_PERTURBATION, PerturbationConfig, unit_scales

_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                              "repro_torch", "annealengine.json")


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """A fully-resolved dispatch decision for one (P, R, N) workload."""
    path: str                    # 'scan' | 'fused'
    block_r: int | None          # fused-kernel runs per block (None: the
                                 # launch plan's pick; scan ignores it)
    j_dtype: str                 # 'float32' | 'bfloat16' | 'int8'
    reason: str = ""             # provenance: 'auto', 'cache', 'autotuned',
                                 # 'explicit', 'feature:noise/record'


def _cache_path() -> str:
    return os.environ.get(_CACHE_ENV, _DEFAULT_CACHE)


class AnnealEngine:
    """Unified batched-solve hot path. One instance per (device model,
    schedule, torch device).

    >>> eng = AnnealEngine(torch_device="cuda")
    >>> res = eng.run(Jq, v0)            # AnnealResult of tensors on the card
    """

    def __init__(self,
                 device: DeviceModel | None = None,
                 perturbation: PerturbationConfig | None = None,
                 path: str = "auto",
                 autotune: bool = False,
                 cache_path: Optional[str] = None,
                 torch_device: str | torch.device = "cuda"):
        if path not in ("auto", "scan", "fused"):
            raise ValueError(f"unknown path {path!r}")
        self.torch_device = resolve_device(torch_device)
        self.device = device or DeviceModel()
        self.perturbation = (perturbation if perturbation is not None
                             else DEFAULT_PERTURBATION)
        self.path = path
        self.autotune_enabled = autotune
        self.cache_path = cache_path or _cache_path()
        self._cache = load_json_cache(self.cache_path)

    @property
    def on_cuda(self) -> bool:
        return self.torch_device.type == "cuda"

    # -- planning ----------------------------------------------------------
    def _key(self, P: int, R: int, N: int, j_dtype: str) -> str:
        if unit_scales(self.device, self.perturbation):
            sched = "unit"
        elif self.perturbation.enabled:
            sched = "pert"
        else:
            sched = "leak"
        from ..kernels.ising_anneal import KERNEL_DESIGN
        return (f"{device_key(self.torch_device)}|N={N}|R={R}|P={P}"
                f"|j={j_dtype}|sched={sched}|kernel={KERNEL_DESIGN}")

    def _auto_j_dtype(self, J: torch.Tensor | None = None) -> str:
        # int8 is bit-exact vs float32 only when (a) the schedule is unit,
        # (b) J is integer levels, AND (c) drive_dt is a power of two (the
        # int path scales AFTER the sum).
        if unit_scales(self.device, self.perturbation) and J is not None \
                and integer_levels(torch.as_tensor(J)) and \
                _is_pow2(self.device.drive_eff * self.device.dt):
            return "int8"
        dt = str(self.device.compute_dtype)
        return dt if dt in ("float32", "bfloat16") else "float32"

    def plan(self, P: int, R: int, N: int, J=None,
             needs_scan: bool = False) -> EnginePlan:
        """Resolve the dispatch for a (P problems, R runs, N spins) solve.
        ``needs_scan``: noise / trajectory recording."""
        j_dtype = self._auto_j_dtype(J)
        block_r = None
        if needs_scan:
            return EnginePlan("scan", block_r, j_dtype,
                              reason="feature:noise/record")
        path, reason = self.path, "explicit"
        if path == "auto":
            path = "fused" if self.on_cuda else "scan"
            reason = "auto"
        # a cache entry supplies block_r for the path chosen above and never
        # changes the path: a stale 'scan' winner on CUDA would otherwise run
        # the main path as plain torch ops
        cached = self._cache.get(self._key(P, R, N, j_dtype))
        if cached and cached["path"] == path and self.path != "scan":
            block_r = cached["block_r"]
            reason = "cache"
        return EnginePlan(path, block_r, j_dtype, reason=reason)

    # -- autotuner ---------------------------------------------------------
    def autotune(self, P: int, R: int, N: int, seed: int = 0,
                 candidates=None, probe_sweeps: float = 0.25,
                 j_dtype: Optional[str] = None) -> EnginePlan:
        """Time shortened anneals of the device's own path and persist the
        winner under the workload key. Per-step cost is schedule
        independent, so the ranking transfers to the full anneal. On CUDA
        this tunes the kernel's block_r over ``candidates`` (default: every
        runs-per-block the launch plan accepts); the scan path
        (plain torch ops) is never a candidate there. On the CPU it times
        the scan path alone: there the kernel wrapper runs the plain
        version, whose time says nothing about the kernel."""
        from ..kernels import ops as kops
        from .lfsr import lfsr_voltage_inits
        rng = np.random.default_rng(seed)
        J = self.device.quantize(torch.as_tensor(
            _random_symmetric(rng, P, N), dtype=torch.float32,
            device=self.torch_device))
        v0 = torch.as_tensor(np.stack([lfsr_voltage_inits(N, R, seed=seed + i)
                                       for i in range(P)]),
                             device=self.torch_device)
        probe_dev = dataclasses.replace(self.device, n_spins=N,
                                        anneal_sweeps=probe_sweeps)
        if j_dtype is None:
            j_dtype = self._auto_j_dtype(J)

        results: list[tuple[float, str, int]] = []
        if not self.on_cuda:
            t = time_call(lambda: anneal(J, v0, probe_dev, self.perturbation),
                          self.torch_device)
            results.append((t, "scan", None))
        else:
            if candidates is None:
                from ..kernels import ising_anneal as ka
                candidates = ka.anneal_block_r_candidates(
                    P, R, N, j_dtype, ka.card_sm_count(self.torch_device))
            for br in candidates:
                t = time_call(lambda br=br: kops.fused_anneal(
                    J, v0, probe_dev, self.perturbation, block_r=br,
                    j_dtype=j_dtype), self.torch_device)
                results.append((t, "fused", br))
        if not results:
            raise ValueError(f"autotune needs at least one block_r candidate "
                             f"on {self.torch_device}, got {candidates!r}")
        results.sort()
        best_t, best_path, best_br = results[0]
        self._cache[self._key(P, R, N, j_dtype)] = {
            "path": best_path, "block_r": best_br, "probe_s": best_t,
            "tuned_at": time.strftime("%Y-%m-%d %H:%M:%S")}
        store_json_cache(self.cache_path, self._cache)
        return EnginePlan(best_path, best_br, j_dtype, reason="autotuned")

    # -- execution ---------------------------------------------------------
    def run(self, J, v0, noise_seed: Optional[int] = None,
            record_every: int = 0) -> AnnealResult:
        """Anneal quantized couplings J (P,N,N) from voltages v0 (P,R,N) on
        the engine's torch device. ``noise_seed`` enables the noise path."""
        J = torch.as_tensor(J, device=self.torch_device).to(torch.float32)
        v0 = torch.as_tensor(v0, device=self.torch_device).to(torch.float32)
        P, N, _ = J.shape
        R = v0.shape[1]
        dev = self.device
        if N != dev.n_spins:
            dev = dataclasses.replace(dev, n_spins=N)
        needs_scan = bool(record_every) or (
            noise_seed is not None and dev.noise_sigma > 0)
        if self.autotune_enabled and not needs_scan and \
                self.path != "scan":
            run_j_dtype = self._auto_j_dtype(J)
            if self._key(P, R, N, run_j_dtype) not in self._cache:
                self.autotune(P, R, N, j_dtype=run_j_dtype)
        plan = self.plan(P, R, N, J=J, needs_scan=needs_scan)

        if plan.path == "scan":
            res = anneal(J, v0, dev, self.perturbation, noise_seed=noise_seed,
                         record_every=record_every)
            return dataclasses.replace(res, j_dtype=plan.j_dtype)

        from ..kernels import ops as kops
        v, sigma, energy = kops.fused_anneal(
            J, v0, dev, self.perturbation, block_r=plan.block_r,
            j_dtype=plan.j_dtype)
        return AnnealResult(v_final=v, sigma=sigma, energy=energy,
                            j_dtype=plan.j_dtype)


# ---------------------------------------------------------------------------
# multi-chip decomposition: large-neighborhood search over one-die blocks
# ---------------------------------------------------------------------------

def lns_blocks(n: int, free_block: int) -> list[np.ndarray]:
    """Balanced contiguous partition of [0, n) into ceil(n/free_block)
    blocks of at most ``free_block`` spins each."""
    if free_block < 1:
        raise ValueError(f"free_block must be >= 1, got {free_block}")
    n_blocks = max(1, -(-n // free_block))
    return [np.asarray(b) for b in np.array_split(np.arange(n), n_blocks)]


class BlockLNS:
    """Large-neighborhood search past the single-die limit (N > chip block).

    The chip solves at most ``chip_block`` all-to-all spins. For larger
    problems we clamp all but one sub-block and anneal the free block on the
    die: each sub-block holds ``chip_block - 1`` free spins plus ONE
    boundary ancilla whose coupling row carries the exact field from every
    clamped spin (``h_i = sum_{j not in blk} J_ij s_j``) — so a sub-solve
    is exactly one 64-spin die dispatch, and the bias-free Z2 symmetry
    makes ancilla pinning unnecessary (candidates are gauge-fixed after).

    Per outer sweep, EVERY (problem, restart, block) sub-instance across
    the whole batch is stacked into one ``(S, chip_block, chip_block)``
    engine dispatch (on the card: one anneal-kernel launch). Candidate
    block configurations are then accepted sequentially per block by EXACT
    delta energy against the *current* state (float64 on the full J, host
    numpy), so the per-restart incumbent energy is monotonically
    non-increasing. Host numpy rng and LFSR inits, as in the reference:
    results are deterministic for a seed.
    """

    def __init__(self, engine: AnnealEngine, chip_block: int = 64,
                 inner_runs: int = 8):
        self.engine = engine
        self.chip_block = chip_block
        self.inner_runs = inner_runs
        #: host vs engine wall split of the last ``solve`` (seconds)
        self.last_timings: dict = {}

    def solve(self, J_list, restarts: int, outer_sweeps: int, seed: int = 0):
        """Minimize level-space H = -0.5 s'Js for each (N_i, N_i) in
        ``J_list``. Returns (per-problem (energies (R,), sigma (R, N_i),
        init_energies (R,)), dispatches)."""
        from .lfsr import lfsr_voltage_inits
        cb = self.chip_block
        rng = np.random.default_rng(seed)
        Js = [np.asarray(J, dtype=np.float64) for J in J_list]
        blocks = [lns_blocks(J.shape[0], cb - 1) for J in Js]
        states = [rng.choice([-1.0, 1.0], size=(restarts, J.shape[0]))
                  for J in Js]

        def energies(p):
            S = states[p]
            return -0.5 * np.einsum("ri,ij,rj->r", S, Js[p], S)

        init_e = [energies(p) for p in range(len(Js))]

        # flat subproblem order: for each problem, for each block, R restarts
        sub_of = [(p, b) for p in range(len(Js))
                  for b in range(len(blocks[p]))]
        n_subs = len(sub_of) * restarts

        # sweep-invariant precompute: per-(problem, block) index sets,
        # coupling extracts, and the padded batch template. Only the
        # boundary-ancilla row/col changes between sweeps.
        t_host0 = time.perf_counter()
        t_engine = 0.0
        sub_J = {}
        for p, b in sub_of:
            J, blk = Js[p], blocks[p][b]
            sub_J[(p, b)] = (blk, J[np.ix_(blk, blk)], J[:, blk])
        batch = np.zeros((n_subs, cb, cb), dtype=np.float32)
        row_of = {}
        k = 0
        for p, b in sub_of:
            blk, Jbb, _ = sub_J[(p, b)]
            m = len(blk)
            rows = slice(k, k + restarts)
            batch[rows, 1:m + 1, 1:m + 1] = Jbb            # stamped once
            row_of[(p, b)] = (rows, m)
            k += restarts

        dispatches = 0
        for sweep in range(outer_sweeps):
            # rewrite each sub-instance's boundary ancilla row/col — every
            # restart carries its own exact clamped field
            for p, b in sub_of:
                S = states[p]
                blk, Jbb, Jcols = sub_J[(p, b)]
                rows, m = row_of[(p, b)]
                h = S @ Jcols - S[:, blk] @ Jbb            # (R, m) exact field
                batch[rows, 0, 1:m + 1] = h
                batch[rows, 1:m + 1, 0] = h
            v0 = torch.as_tensor(lfsr_voltage_inits(
                cb, self.inner_runs, seed=seed + 7919 * (sweep + 1)))
            t0 = time.perf_counter()
            res = self.engine.run(batch, v0.expand((n_subs,) + v0.shape))
            e = res.energy.cpu().numpy()                   # (S, inner_runs)
            sig = res.sigma.cpu().numpy()                  # (S, inner, cb)
            t_engine += time.perf_counter() - t0
            dispatches += 1
            best = e.argmin(axis=1)
            cand_all = np.take_along_axis(
                sig, best[:, None, None], axis=1)[:, 0]    # (S, cb)

            for p, b in sub_of:
                S = states[p]
                blk, Jbb, Jcols = sub_J[(p, b)]
                rows, m = row_of[(p, b)]
                cand = cand_all[rows]
                # gauge-fix the boundary ancilla to +1, trim to the block
                cand = (cand[:, 1:m + 1] * cand[:, :1]).astype(np.float64)
                # exact delta vs the CURRENT state (earlier blocks of this
                # sweep may already have moved; h is recomputed, not reused)
                h = S @ Jcols - S[:, blk] @ Jbb
                e_new = -np.einsum("rm,rm->r", h, cand) \
                    - 0.5 * np.einsum("rm,mk,rk->r", cand, Jbb, cand)
                cur = S[:, blk]
                e_old = -np.einsum("rm,rm->r", h, cur) \
                    - 0.5 * np.einsum("rm,mk,rk->r", cur, Jbb, cur)
                acc = np.flatnonzero(e_new < e_old - 1e-9)
                if len(acc):
                    S[np.ix_(acc, blk)] = cand[acc]

        t_total = time.perf_counter() - t_host0
        self.last_timings = {"t_total": t_total, "t_engine": t_engine,
                             "t_host": t_total - t_engine,
                             "dispatches": dispatches}
        out = []
        for p in range(len(Js)):
            out.append((energies(p), states[p].astype(np.int8), init_e[p]))
        return out, dispatches


def _is_pow2(x: float) -> bool:
    """True when x is an exact power of two (mantissa 0.5 after frexp)."""
    if not (x > 0 and math.isfinite(x)):
        return False
    return math.frexp(x)[0] == 0.5


def integer_levels(J: torch.Tensor) -> bool:
    """True when J holds integer DAC levels in [-127, 127] (the int8 fast
    path's validity domain)."""
    if J.dtype.is_complex or J.dtype == torch.bool:
        return False
    return bool(torch.all(J == torch.round(J)) and
                torch.all(torch.abs(J) <= 127))


def _random_symmetric(rng, P, N):
    A = rng.standard_normal((P, N, N))
    A = 0.5 * (A + A.transpose(0, 2, 1))
    for p in range(P):
        np.fill_diagonal(A[p], 0.0)
    return A


def time_call(fn, torch_device: torch.device, iters: int = 2) -> float:
    """Warm up once, then average ``iters`` timed calls, each ending in a
    synchronize of ``torch_device`` when it is a CUDA device."""
    def call():
        fn()
        if torch_device.type == "cuda":
            torch.cuda.synchronize(torch_device)
    call()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) / iters
