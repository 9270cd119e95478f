"""Solver protocol + registry — one ``solve()`` surface over every backend.

    solver = get_solver("engine", torch_device="cuda")
    report = solver.solve(suite, runs=256, seed=0, budget=None)

``suite`` may be a :class:`ProblemSuite`, a single :class:`Problem`, or a
raw coupling matrix / batch (wrapped automatically). ``runs`` is the number
of independent runs per problem; ``budget`` is a solver-relative effort
multiplier (anneal length for the engine, sweeps for SA / PT, flips for
tabu, integration steps for SB; exact solvers ignore it).
Batched solvers bucket heterogeneous suites by padded size, so a mixed
16/32/64-spin sweep costs one device dispatch per bucket —
``SolveReport.dispatches`` records the count.

Registered here: ``engine`` (the digital twin on the AnnealEngine, variants
``perturbation`` / ``gd`` / ``noise``), ``sb-jax`` (simulated bifurcation on
its own kernel; the reference's name), ``chip-lns`` (block decomposition of
N > 64 onto the engine), the classical search tier (``sa-jax``, ``pt-jax``
and ``tabu-jax``: batched torch loops, one batch per pad bucket; ``sa-numpy``
and ``tabu``: host numpy loops, one call per problem) and ``brute-force``
(exact). Every solver takes ``torch_device`` (default ``"cuda"``; raises
without CUDA unless it is ``"cpu"``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..device import resolve_device
from ..solvers.brute_force import BRUTE_FORCE_MAX_N
from .batching import CHIP_BLOCK, padded_size, plan_buckets
from .budget import budget_factor, search_effort
from .oracle import best_known_energies, reconcile_best_known
from .problem import Problem
from .report import SolveReport
from .suite import ProblemSuite


@dataclasses.dataclass(frozen=True)
class SolverCaps:
    needs_oracle: bool                # success metrics need external best-known
    exact: bool                       # returned energies are ground truth
    device: str                       # 'torch' (batched) | 'numpy' (host loop)
    max_n: Optional[int] = None       # hard size limit, if any


@runtime_checkable
class Solver(Protocol):
    name: str
    caps: SolverCaps

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport: ...


_REGISTRY: dict[str, type] = {}


def register_solver(name: str, *, needs_oracle: bool, exact: bool,
                    device: str, max_n: Optional[int] = None):
    """Class decorator: publish a Solver implementation under ``name``."""
    caps = SolverCaps(needs_oracle=needs_oracle, exact=exact,
                      device=device, max_n=max_n)

    def deco(cls):
        cls.name = name
        cls.caps = caps
        _REGISTRY[name] = cls
        return cls
    return deco


def list_solvers() -> dict[str, SolverCaps]:
    return {name: cls.caps for name, cls in sorted(_REGISTRY.items())}


def get_solver(name: str, **opts) -> Solver:
    """Instantiate a registered solver; ``opts`` go to its constructor
    (every solver takes ``torch_device``)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown solver {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None
    return cls(**opts)


class SolverWrapper:
    """Delegating base for solver interposers.

    A wrapper satisfies the :class:`Solver` protocol by forwarding
    ``name`` / ``caps`` / ``solve`` to the wrapped instance, so anything
    that consumes a registered solver accepts a wrapped one. Subclass and
    override ``solve`` to interpose (fault injectors, test shims).
    """

    def __init__(self, inner: Solver):
        self.inner = inner

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def caps(self) -> SolverCaps:
        return self.inner.caps

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        return self.inner.solve(suite, runs=runs, seed=seed, budget=budget,
                                block=block)


def as_suite(problems) -> ProblemSuite:
    """Normalize Problem / ProblemSuite / raw (N,N) or (P,N,N) couplings."""
    if isinstance(problems, ProblemSuite):
        return problems
    if isinstance(problems, Problem):
        return ProblemSuite([problems])
    J = np.asarray(problems)
    if J.ndim == 2:
        J = J[None]
    return ProblemSuite([Problem.from_couplings(j) for j in J])


def solve_suite(problems, solver: str = "engine", runs: int = 64,
                seed: int = 0, budget: Optional[float] = None,
                block: int = CHIP_BLOCK, oracle: bool = True,
                use_cache: bool = True, oracle_path: Optional[str] = None,
                torch_device: str | torch.device = "cuda",
                **solver_opts) -> SolveReport:
    """One-call entry point: solve + (optionally) attach the best-known
    oracle so ``report.metrics()`` works immediately."""
    torch_device = resolve_device(torch_device)
    suite = as_suite(problems)
    sol = get_solver(solver, torch_device=torch_device, **solver_opts)
    report = sol.solve(suite, runs=runs, seed=seed, budget=budget,
                       block=block)
    if oracle:
        if sol.caps.needs_oracle:
            # Heuristic solver: external best-known, upgraded in place if
            # this solve happened to beat a stale cached entry.
            bk = best_known_energies(suite, use_cache=use_cache,
                                     path=oracle_path,
                                     torch_device=torch_device)
            bk = reconcile_best_known(
                suite, np.minimum(bk, report.best_energy),
                use_cache=use_cache, path=oracle_path,
                method=f"improved:{sol.name}")
        else:
            # The solver IS an oracle: reuse its own energies, reconciled
            # against anything better already cached. Only exact solvers
            # may seed missing entries (ground truth).
            bk = reconcile_best_known(
                suite, report.best_energy, use_cache=use_cache,
                path=oracle_path, method=f"self:{sol.name}",
                write_missing=sol.caps.exact)
        report.attach_oracle(bk)
    return report


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------

def _check_max_n(suite: ProblemSuite, caps: SolverCaps, name: str,
                 block: int = CHIP_BLOCK) -> None:
    """Enforce a solver's declared capacity BEFORE any padding happens (an
    N=65 problem would otherwise pad to a 128-spin virtual chip)."""
    if caps.max_n is None:
        return
    big = max(suite.sizes, default=0)
    if big > caps.max_n:
        pad = padded_size(big, block)
        raise ValueError(
            f"solver {name!r} declares max_n={caps.max_n} but the suite has "
            f"N={big} (would pad to a {pad}-spin virtual chip); use the "
            f"'chip-lns' decomposition solver for problems beyond one "
            f"{caps.max_n}-spin block")


def _bucketed_report(suite, solver_name, runs, block, run_bucket,
                     meta=None, buckets=None, warmup=False) -> SolveReport:
    """Shared bucket loop: run ``run_bucket(bucket, b_idx) -> (e, s)`` with
    ``e (P, R)`` level-space energies and ``s (P, R, n_pad)`` spins (numpy);
    trim and reorder into suite order via ``BatchPlan.scatter``.

    With ``warmup`` each bucket is dispatched twice: the first call pays
    one-time costs (kernel build and load, allocator growth), the second is
    timed; ``compile_s`` records the difference. Seeds are per-bucket
    deterministic, so both calls return identical results."""
    plan = plan_buckets(suite.sizes, block)
    buckets = buckets if buckets is not None else suite.buckets(block)
    outputs = []
    wall = compile_s = 0.0
    for b_idx, bucket in enumerate(buckets):
        if warmup:
            t0 = time.time()
            run_bucket(bucket, b_idx)
            t_first = time.time() - t0
        t0 = time.time()
        e, s = run_bucket(bucket, b_idx)
        e = np.asarray(e, dtype=np.float64)
        s = np.asarray(s)
        dt = time.time() - t0
        wall += dt
        if warmup:
            compile_s += max(0.0, t_first - dt)
        outputs.append((e, s))
    energies, sigmas = plan.scatter(outputs)
    return SolveReport(
        solver=solver_name, runs=runs, energies=energies, best_sigma=sigmas,
        problem_hashes=suite.hashes, sizes=suite.sizes,
        scales=tuple(p.scale for p in suite), wall_s=wall,
        compile_s=compile_s, dispatches=len(buckets), meta=meta or {})


@register_solver("engine", needs_oracle=True, exact=False, device="torch",
                 max_n=CHIP_BLOCK)
class EngineSolver:
    """The digital twin: IsingMachine -> AnnealEngine (scan/fused paths).

    Capacity: ONE 64-spin die (``max_n=CHIP_BLOCK``).

    ``variant``: 'perturbation' (paper default), 'gd' (no-perturbation
    gradient-descent baseline), 'noise' (inherent-circuit-noise baseline,
    its ``torch.Generator`` seeded with ``seed + 10007 * bucket``).
    ``budget`` multiplies the anneal length (sweeps). Couplings are passed
    in level space with ``quantize=False``. ``machine`` overrides the
    machine the variant would build (its own torch device then applies).
    """

    def __init__(self, backend: str = "auto", autotune: bool = False,
                 variant: str = "perturbation", machine=None,
                 noise_sigma: float = 2.0, warmup: bool = False,
                 torch_device: str | torch.device = "cuda"):
        if variant not in ("perturbation", "gd", "noise"):
            raise ValueError(f"unknown engine variant {variant!r}")
        self.backend = backend
        self.autotune = autotune
        self.variant = variant
        self.noise_sigma = noise_sigma
        self.warmup = warmup
        self._machine = machine
        self.torch_device = (machine.torch_device if machine is not None
                             else resolve_device(torch_device))

    def _make_machine(self, budget: Optional[float]):
        from ..core.device_model import DeviceModel
        from ..core.machine import IsingMachine
        if self._machine is not None:
            return self._machine
        dev = DeviceModel()
        if budget is not None:
            dev = dataclasses.replace(dev, anneal_sweeps=dev.anneal_sweeps *
                                      budget_factor(budget))
        m = IsingMachine(device=dev, backend=self.backend,
                         autotune=self.autotune,
                         torch_device=self.torch_device)
        if self.variant == "gd":
            m = m.gradient_descent_baseline()
        elif self.variant == "noise":
            m = m.inherent_noise_baseline(self.noise_sigma)
        return m

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        suite = as_suite(suite)
        _check_max_n(suite, self.caps, self.name, block)
        machine = self._make_machine(budget)

        def run_bucket(bucket, b_idx):
            gen = None
            if self.variant == "noise":
                gen = torch.Generator(device=machine.torch_device)
                gen.manual_seed(seed + 10007 * b_idx)
            out = machine.solve(bucket.J, num_runs=runs,
                                seed=seed + 7919 * b_idx, generator=gen,
                                quantize=False)
            return out.energy, out.sigma

        buckets = suite.buckets(block)
        rep = _bucketed_report(suite, self.name, runs, block, run_bucket,
                               meta={"variant": self.variant,
                                     "backend": self.backend,
                                     "torch_device": str(
                                         machine.torch_device)},
                               buckets=buckets, warmup=self.warmup)
        # Report the plan the biggest bucket ACTUALLY resolved to: with the
        # real J (int8 auto-select needs concrete levels) and the noise
        # variant's forced-scan feature flag.
        big = max(buckets, key=lambda b: b.n_pad)
        needs_scan = (self.variant == "noise" and
                      machine.device.noise_sigma > 0)
        plan = machine.engine.plan(big.num_problems, runs, big.n_pad,
                                   J=torch.as_tensor(big.J),
                                   needs_scan=needs_scan)
        rep.meta["engine_plan"] = {"path": plan.path,
                                   "block_r": plan.block_r,
                                   "j_dtype": plan.j_dtype,
                                   "reason": plan.reason}
        return rep


@register_solver("sa-jax", needs_oracle=True, exact=False, device="torch")
class SAJaxSolver:
    """Metropolis SA on the torch device (``solvers.sa_jax``): restarts x
    problems of a pad bucket in one batch. ``budget`` multiplies the sweep
    count. Bucket b draws from ``seed + 7919 * b``."""

    def __init__(self, n_sweeps: int = 200, beta0: float = 0.05,
                 beta1: float = 4.0, warmup: bool = False,
                 torch_device: str | torch.device = "cuda"):
        self.n_sweeps = n_sweeps
        self.beta0 = beta0
        self.beta1 = beta1
        self.warmup = warmup
        self.torch_device = resolve_device(torch_device)

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        from ..solvers.sa_jax import simulated_annealing_jax_runs
        suite = as_suite(suite)
        _check_max_n(suite, self.caps, self.name, block)
        eff = search_effort(self.n_sweeps, runs, budget)

        def run_bucket(bucket, b_idx):
            return simulated_annealing_jax_runs(
                bucket.J, n_runs=eff.restarts, n_sweeps=eff.iters,
                beta0=self.beta0, beta1=self.beta1, seed=seed + 7919 * b_idx,
                torch_device=self.torch_device)

        return _bucketed_report(suite, self.name, runs, block, run_bucket,
                                meta={"n_sweeps": eff.iters,
                                      "effort": dataclasses.asdict(eff),
                                      "torch_device": str(self.torch_device)},
                                warmup=self.warmup)


@register_solver("sa-numpy", needs_oracle=True, exact=False, device="numpy")
class SANumpySolver:
    """Host numpy SA (``solvers.sa``), one vectorized-restart call per
    problem, seeded ``seed + 31 * i``. ``torch_device`` is resolved like
    every entry point's, though nothing runs on it."""

    def __init__(self, n_sweeps: int = 200, beta0: float = 0.05,
                 beta1: float = 4.0,
                 torch_device: str | torch.device = "cuda"):
        self.n_sweeps = n_sweeps
        self.beta0 = beta0
        self.beta1 = beta1
        self.torch_device = resolve_device(torch_device)

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        from ..solvers.sa import simulated_annealing
        suite = as_suite(suite)
        _check_max_n(suite, self.caps, self.name, block)
        eff = search_effort(self.n_sweeps, runs, budget)
        energies, sigmas = [], []
        t0 = time.time()
        for i, p in enumerate(suite):
            e, s = simulated_annealing(
                p.J_levels, n_sweeps=eff.iters, n_restarts=eff.restarts,
                beta0=self.beta0, beta1=self.beta1, seed=seed + 31 * i,
                return_all=True)
            energies.append(np.asarray(e, dtype=np.float64))
            sigmas.append(s[int(np.argmin(e))])
        return SolveReport(
            solver=self.name, runs=runs, energies=energies,
            best_sigma=sigmas, problem_hashes=suite.hashes,
            sizes=suite.sizes, scales=tuple(p.scale for p in suite),
            wall_s=time.time() - t0, dispatches=0,
            meta={"n_sweeps": eff.iters, "host_evals": len(suite)})


@register_solver("tabu", needs_oracle=False, exact=False, device="numpy")
class TabuSolver:
    """qbsolv-style tabu search on the host (``solvers.tabu``), the paper's
    best-known oracle. ``runs`` maps to independent restarts; ``budget``
    multiplies the per-restart iteration count (default 40*N); problem i is
    seeded ``seed + 31 * i``.

    ``meta["iters_used"]`` records the flips each restart APPLIED: a
    restart stops early when every move is tabu and none aspirates."""

    def __init__(self, tenure: Optional[int] = None,
                 torch_device: str | torch.device = "cuda"):
        self.tenure = tenure
        self.torch_device = resolve_device(torch_device)

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        from ..solvers.tabu import tabu_search
        suite = as_suite(suite)
        _check_max_n(suite, self.caps, self.name, block)
        energies, sigmas, iters_used, n_iters = [], [], [], []
        t0 = time.time()
        for i, p in enumerate(suite):
            eff = search_effort(40 * p.n, runs, budget)
            e, s, used = tabu_search(
                p.J_levels, n_iters=eff.iters, n_restarts=eff.restarts,
                tenure=self.tenure, seed=seed + 31 * i, return_all=True,
                return_iters=True)
            energies.append(np.asarray(e, dtype=np.float64))
            sigmas.append(s[int(np.argmin(e))])
            iters_used.append(used.tolist())
            n_iters.append(eff.iters)
        return SolveReport(
            solver=self.name, runs=runs, energies=energies,
            best_sigma=sigmas, problem_hashes=suite.hashes,
            sizes=suite.sizes, scales=tuple(p.scale for p in suite),
            wall_s=time.time() - t0, dispatches=0,
            meta={"n_iters": n_iters, "iters_used": iters_used,
                  "host_evals": len(suite)})


@register_solver("tabu-jax", needs_oracle=False, exact=False,
                 device="torch")
class TabuJaxSolver:
    """The tabu oracle at machine batch scale (``solvers.tabu_jax``):
    restarts x problems of a pad bucket in one batch, lockstep iterations.
    Same algorithm and per-problem budgets as ``tabu`` (``n_iters = 40 * N
    * budget``, tenure ``max(4, N // 4)``); padded spins are masked out of
    the candidate moves. Bucket b draws from ``seed + 7919 * b``.

    ``meta["iters_used"]`` is the per-restart count of applied flips."""

    def __init__(self, tenure: Optional[int] = None, warmup: bool = False,
                 torch_device: str | torch.device = "cuda"):
        self.tenure = tenure
        self.warmup = warmup
        self.torch_device = resolve_device(torch_device)

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        from ..solvers.tabu_jax import tabu_search_jax_runs
        suite = as_suite(suite)
        _check_max_n(suite, self.caps, self.name, block)
        efforts = [search_effort(40 * p.n, runs, budget) for p in suite]
        restarts = efforts[0].restarts if efforts else max(1, runs)
        used_by_problem = {}

        def run_bucket(bucket, b_idx):
            e, s, used = tabu_search_jax_runs(
                bucket.J,
                n_true=[suite[i].n for i in bucket.indices],
                n_iters=[efforts[i].iters for i in bucket.indices],
                n_restarts=restarts, tenure=self.tenure,
                seed=seed + 7919 * b_idx, torch_device=self.torch_device)
            for k, i in enumerate(bucket.indices):
                used_by_problem[i] = used[k].tolist()
            return e, s

        rep = _bucketed_report(
            suite, self.name, runs, block, run_bucket,
            meta={"n_iters": [e.iters for e in efforts],
                  "torch_device": str(self.torch_device)},
            warmup=self.warmup)
        rep.meta["iters_used"] = [used_by_problem[i]
                                  for i in range(len(suite))]
        return rep


@register_solver("pt-jax", needs_oracle=True, exact=False, device="torch")
class PTJaxSolver:
    """Replica-exchange parallel tempering (``solvers.pt_jax``) on the
    shared Metropolis sweep: K fixed rungs per restart, checkerboard
    neighbour swaps, one batch per pad bucket. ``runs`` is independent PT
    restarts (each reports its across-rung best); ``budget`` multiplies the
    sweep count. Bucket b draws from ``seed + 7919 * b``.

    ``meta["swap_acceptances"]`` (mean per restart) is the mixing
    diagnostic: 0 means the ladder is too steep to exchange."""

    def __init__(self, n_sweeps: int = 120, n_rungs: int = 4,
                 beta0: float = 0.05, beta1: float = 4.0,
                 swap_every: int = 1, warmup: bool = False,
                 torch_device: str | torch.device = "cuda"):
        self.n_sweeps = n_sweeps
        self.n_rungs = n_rungs
        self.beta0 = beta0
        self.beta1 = beta1
        self.swap_every = swap_every
        self.warmup = warmup
        self.torch_device = resolve_device(torch_device)

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        from ..solvers.pt_jax import parallel_tempering_jax_runs
        suite = as_suite(suite)
        _check_max_n(suite, self.caps, self.name, block)
        eff = search_effort(self.n_sweeps, runs, budget,
                            rungs=self.n_rungs)
        swaps_by_problem = {}

        def run_bucket(bucket, b_idx):
            e, s, swaps = parallel_tempering_jax_runs(
                bucket.J, n_runs=eff.restarts, n_sweeps=eff.iters,
                n_rungs=eff.rungs, beta0=self.beta0, beta1=self.beta1,
                swap_every=self.swap_every, seed=seed + 7919 * b_idx,
                torch_device=self.torch_device)
            for k, i in enumerate(bucket.indices):
                swaps_by_problem[i] = float(np.mean(swaps[k]))
            return e, s

        rep = _bucketed_report(
            suite, self.name, runs, block, run_bucket,
            meta={"effort": dataclasses.asdict(eff),
                  "torch_device": str(self.torch_device)},
            warmup=self.warmup)
        rep.meta["swap_acceptances"] = [swaps_by_problem[i]
                                        for i in range(len(suite))]
        return rep


@register_solver("sb-jax", needs_oracle=True, exact=False, device="torch")
class SBJaxSolver:
    """Simulated bifurcation (``solvers.sb_jax``) — the state-of-the-art
    classical competitor on dense Max-Cut, run by the SB kernel
    (``kernels.sb_kernel``): position/momentum symplectic updates over
    (problems × restarts), the linear pump ramp derived in-kernel from the
    step index, inelastic walls for bSB/dSB, ``sign_pm1`` readout — one
    launch per pad bucket. No size limit.

    ``variant``: 'bSB' (default — ballistic, the robust all-rounder),
    'dSB' (discrete drive, strongest on dense Max-Cut), 'aSB' (the
    original adiabatic Kerr form). ``budget`` multiplies the integration
    step count per the uniform ``search_effort`` mapping; the per-problem
    coupling scale c0 is derived from each problem's TRUE size, so padded
    buckets normalize exactly like unpadded solves. Bucket b's inits are
    seeded ``seed + 7919 * b``.
    """

    def __init__(self, variant: str = "bSB", n_steps: int = 400,
                 dt: float = 0.5, a0: float = 1.0, warmup: bool = False,
                 torch_device: str | torch.device = "cuda"):
        from ..kernels.sb_kernel import check_variant
        check_variant(variant)
        self.variant = variant
        self.n_steps = n_steps
        self.dt = dt
        self.a0 = a0
        self.warmup = warmup
        self.torch_device = resolve_device(torch_device)

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        from ..solvers.sb_jax import simulated_bifurcation_jax_runs
        suite = as_suite(suite)
        _check_max_n(suite, self.caps, self.name, block)
        eff = search_effort(self.n_steps, runs, budget)

        def run_bucket(bucket, b_idx):
            return simulated_bifurcation_jax_runs(
                bucket.J,
                n_true=[suite[i].n for i in bucket.indices],
                variant=self.variant, n_steps=eff.iters,
                n_restarts=eff.restarts, dt=self.dt, a0=self.a0,
                seed=seed + 7919 * b_idx, torch_device=self.torch_device)

        return _bucketed_report(
            suite, self.name, runs, block, run_bucket,
            meta={"variant": self.variant, "dt": self.dt, "a0": self.a0,
                  "effort": dataclasses.asdict(eff),
                  "torch_device": str(self.torch_device)},
            warmup=self.warmup)


@register_solver("chip-lns", needs_oracle=True, exact=False, device="torch")
class ChipLNSSolver:
    """Multi-chip decomposition: large-neighborhood search over one-die
    blocks (``core.engine.BlockLNS``) — the registry's only solver WITHOUT
    a capacity limit that still runs on the chip's anneal path.

    Problems with N <= ``block`` are delegated verbatim to the direct
    engine solve (same machine, same seeds — bit-identical energies), so
    'chip-lns' is a strict superset of 'engine'. Larger problems iterate:
    clamp all but one (block-1)-spin sub-block, anneal the free block plus
    one boundary-field ancilla as exactly one die, and accept candidate
    block configurations by exact float64 delta energy — every (problem,
    restart, block) sub-instance of an outer sweep rides ONE engine
    dispatch. ``runs`` is the number of independent LNS restarts;
    ``budget`` multiplies the outer sweep count (the engine delegation for
    small problems keeps its own default anneal length). ``backend`` takes
    the engine's path names (``scan`` / ``fused`` / ``auto``).
    """

    def __init__(self, backend: str = "auto", inner_runs: int = 8,
                 outer_sweeps: Optional[int] = None,
                 anneal_sweeps: Optional[float] = None,
                 warmup: bool = False,
                 torch_device: str | torch.device = "cuda"):
        self.backend = backend
        self.inner_runs = inner_runs
        self.outer_sweeps = outer_sweeps
        self.anneal_sweeps = anneal_sweeps
        self.warmup = warmup
        self.torch_device = resolve_device(torch_device)

    def _engine(self):
        from ..core.device_model import DeviceModel
        from ..core.engine import AnnealEngine
        dev = DeviceModel()
        if self.anneal_sweeps:
            dev = dataclasses.replace(dev, anneal_sweeps=self.anneal_sweeps)
        return AnnealEngine(device=dev, path=self.backend,
                            torch_device=self.torch_device)

    def solve(self, suite, runs: int = 64, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        from ..core.engine import BlockLNS, lns_blocks
        suite = as_suite(suite)
        wall = 0.0
        # Delegation threshold: the direct engine can only take what BOTH
        # the requested block and its own die cap allow — with block > 64
        # the oversized problems must still decompose.
        delegate_n = min(block, EngineSolver.caps.max_n or block)
        small = [i for i, n in enumerate(suite.sizes) if n <= delegate_n]
        big = [i for i, n in enumerate(suite.sizes) if n > delegate_n]

        energies = [None] * len(suite)
        sigmas = [None] * len(suite)
        dispatches = 0
        compile_s = 0.0
        meta = {"block": block, "inner_runs": self.inner_runs,
                "lns_problems": big, "torch_device": str(self.torch_device)}

        if small:
            sub = ProblemSuite([suite[i] for i in small])
            rep = EngineSolver(backend=self.backend, warmup=self.warmup,
                               torch_device=self.torch_device).solve(
                sub, runs=runs, seed=seed, budget=None, block=delegate_n)
            for k, i in enumerate(small):
                energies[i] = rep.energies[k]
                sigmas[i] = rep.best_sigma[k]
            dispatches += rep.dispatches
            compile_s += rep.compile_s
            wall += rep.wall_s
            meta["engine_plan"] = rep.meta.get("engine_plan")

        if big:
            n_blocks = max(len(lns_blocks(suite[i].n, delegate_n - 1))
                           for i in big)
            outer = self.outer_sweeps or max(4, 2 * n_blocks)
            outer = search_effort(outer, runs, budget).iters
            # the die is delegate_n, never the (possibly larger) pad block
            lns = BlockLNS(self._engine(), chip_block=delegate_n,
                           inner_runs=self.inner_runs)
            big_J = [suite[i].J_levels.astype(np.float64) for i in big]
            if self.warmup:
                # same first-call / steady split as _bucketed_report: a
                # discarded identical solve (deterministic seed) first
                tw = time.time()
                lns.solve(big_J, restarts=runs, outer_sweeps=outer,
                          seed=seed + 104729)
                t_first = time.time() - tw
            t0 = time.time()
            results, d = lns.solve(big_J, restarts=runs,
                                   outer_sweeps=outer, seed=seed + 104729)
            if self.warmup:
                compile_s += max(0.0, t_first - (time.time() - t0))
            dispatches += d
            meta["outer_sweeps"] = outer
            meta["lns_timings"] = lns.last_timings
            meta["n_blocks"] = n_blocks
            meta["init_energies"] = {}
            for (e, s, e0), i in zip(results, big):
                energies[i] = e
                sigmas[i] = s[int(np.argmin(e))]
                meta["init_energies"][i] = e0.tolist()
            wall += time.time() - t0

        return SolveReport(
            solver=self.name, runs=runs, energies=energies,
            best_sigma=sigmas, problem_hashes=suite.hashes,
            sizes=suite.sizes, scales=tuple(p.scale for p in suite),
            wall_s=wall, compile_s=compile_s, dispatches=dispatches,
            meta=meta)


@register_solver("brute-force", needs_oracle=False, exact=True,
                 device="numpy", max_n=BRUTE_FORCE_MAX_N)
class BruteForceSolver:
    """Exhaustive exact minimum (``N <= BRUTE_FORCE_MAX_N``). Host numpy;
    ``runs``/``budget`` ignored — one energy per problem, the ground truth.
    ``torch_device`` is resolved like every entry point's, though nothing
    runs on it."""

    def __init__(self, torch_device: str | torch.device = "cuda"):
        self.torch_device = resolve_device(torch_device)

    def solve(self, suite, runs: int = 1, seed: int = 0,
              budget: Optional[float] = None,
              block: int = CHIP_BLOCK) -> SolveReport:
        from ..solvers.brute_force import brute_force_ground_state
        suite = as_suite(suite)
        _check_max_n(suite, self.caps, self.name, block)
        energies, sigmas = [], []
        t0 = time.time()
        for p in suite:
            e, s = brute_force_ground_state(p.J_levels)
            energies.append(np.array([e], dtype=np.float64))
            sigmas.append(np.asarray(s, dtype=np.int8))
        return SolveReport(
            solver=self.name, runs=1, energies=energies, best_sigma=sigmas,
            problem_hashes=suite.hashes, sizes=suite.sizes,
            scales=tuple(p.scale for p in suite),
            wall_s=time.time() - t0, dispatches=0,
            meta={"host_evals": len(suite)})
