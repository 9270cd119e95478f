"""Solver protocol + registry — one ``solve()`` surface over every backend.

    solver = get_solver("engine", torch_device="cuda")
    report = solver.solve(suite, runs=256, seed=0, budget=None)

``suite`` may be a :class:`ProblemSuite`, a single :class:`Problem`, or a
raw coupling matrix / batch (wrapped automatically). ``runs`` is the number
of independent runs per problem; ``budget`` is a solver-relative effort
multiplier (anneal length for the engine; exact solvers ignore it).
Batched solvers bucket heterogeneous suites by padded size, so a mixed
16/32/64-spin sweep costs one device dispatch per bucket —
``SolveReport.dispatches`` records the count.

Registered here: ``engine`` (the digital twin on the AnnealEngine, variants
``perturbation`` / ``gd`` / ``noise``) and ``brute-force`` (exact). Every
solver takes ``torch_device`` (default ``"cuda"``; raises without CUDA
unless it is ``"cpu"``).
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
from .budget import budget_factor
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
                                     path=oracle_path)
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
            f"N={big} (would pad to a {pad}-spin virtual chip)")


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
