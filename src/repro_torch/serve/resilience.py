"""``repro_torch.serve.resilience`` — supervised flush execution.

The paper's core trick turns a reliability mechanism into a feature:
continuous programming refresh both mitigates coefficient leakage *and*
perturbs the landscape. This module holds the serve tier to the same
standard — operation under faults is part of the contract, not an
afterthought. It sits between the batch planner and the solver registry
and supervises every flushed dispatch:

* **Bounded retry with backoff.** A failed dispatch retries on the same
  solver with exponential backoff plus deterministic (seeded) jitter —
  transient faults never reach a ticket. A ``ValueError`` (a kernel
  wrapper's refused launch plan, or another programming error) is not a
  fault: it is neither retried, bisected nor sent down the fallback
  chain, and every ticket of its flush fails with it.

* **Failure isolation by bisection.** A multi-request flush that keeps
  failing is split in half and each half re-dispatched; the poisoned
  request(s) are isolated down to singletons and fail (or degrade) alone
  instead of sinking their flush-mates.

* **Circuit breaker + fallback chain.** Each solver tier carries a
  consecutive-failure breaker; a tripped tier is skipped and flushes fall
  down the configured chain (e.g. ``engine -> tabu-jax -> sa-numpy``).
  Results produced below the primary tier are marked ``degraded`` — in
  the ``ServeResult``, and per problem in the partial ``SolveReport``
  meta. The chain's last rung is always attempted even with its breaker
  open: shedding to certain failure when a solver exists is strictly
  worse than a probe.

* **Watchdog + hedged re-dispatch.** A flush runs under a deadline-derived
  timeout (the tightest of: policy ``flush_timeout_s``, each member
  request's remaining deadline, and a multiple of the
  :class:`StragglerDetector`'s EWMA flush time). A flush that exceeds it
  is treated as a straggler: an identical dispatch is hedged alongside it
  and the first completion wins — seeds are deterministic, so the hedge
  returns bit-identical results.

* **Result validation guardrail.** Before any ticket resolves, returned
  energies are recomputed from the returned spins in exact float64
  against the problem's level-space couplings. NaN/garbage rows are
  rejected, quarantined from the result cache, and re-dispatched.

Everything here is policy-driven (:class:`ResiliencePolicy`) and defaults
to the least intrusive configuration: validation on, retries on, no
fallback chain, no watchdog, no admission thresholds — the fault-free
path stays bit-identical to the pre-resilience service.
"""
from __future__ import annotations

import dataclasses
import logging
import queue as queue_mod
import random
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..api.registry import get_solver
from ..api.suite import ProblemSuite
from ..device import resolve_device
from ..distributed.fault_tolerance import StragglerDetector

log = logging.getLogger("repro_torch.serve.resilience")


# ---------------------------------------------------------------------------
# typed failures
# ---------------------------------------------------------------------------

class Overloaded(RuntimeError):
    """Typed admission failure: the service shed this request at submit
    time instead of letting queue pressure blow every request's p95."""


class SolverCrash(RuntimeError):
    """The solver backend died (worker process gone, device lost). Not
    retryable on the same solver — trips its circuit breaker immediately
    and escalates down the fallback chain."""


class FlushTimeout(RuntimeError):
    """A flush and its hedged re-dispatch both exceeded the watchdog."""


class FlushFailed(RuntimeError):
    """Terminal per-request failure: retries, bisection, and every rung of
    the fallback chain were exhausted."""


class RequestCancelled(RuntimeError):
    """The ticket was cancelled before its request resolved."""


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Declarative supervision policy for the serve tier.

    The default instance preserves pre-resilience behavior on the happy
    path (no watchdog, no fallback, no admission control) while adding
    retry/bisection/validation, which only engage on faults.
    """
    # retry / backoff (deterministically jittered via ``seed``)
    max_retries: int = 2
    backoff_base_s: float = 0.01
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.5
    backoff_max_s: float = 0.5
    # result validation guardrail
    validate: bool = True
    validate_atol: float = 0.5       # level-space energies land on 0.5 grid
    validate_rtol: float = 1e-6
    # degradation ladder: solver names tried after the primary
    fallback: tuple = ()
    # circuit breaker (per solver tier, consecutive exhausted-retry counts)
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    # watchdog / hedging (None flush_timeout_s + no deadlines = no watchdog)
    flush_timeout_s: Optional[float] = None
    min_timeout_s: float = 0.25      # floor — never hedge a warm-path flush
    hedge: bool = True
    hedge_grace: float = 4.0         # hedge wait = grace * timeout
    straggler_factor: float = 4.0    # timeout candidate vs EWMA flush time
    # overload admission control (queued request counts; None = disabled)
    degrade_pending: Optional[int] = None
    shed_pending: Optional[int] = None
    seed: int = 0


# ---------------------------------------------------------------------------
# validation guardrail
# ---------------------------------------------------------------------------

def validate_row(problem, energies, sigma,
                 atol: float = 0.5, rtol: float = 1e-6) -> bool:
    """Does ``(energies, sigma)`` actually solve ``problem``?

    Exact float64 recompute: finite per-run energies, a ±1 spin vector of
    the true problem size, and the best energy matching
    ``-0.5 sigma' J_levels sigma`` (level space — integer couplings and ±1
    spins put honest energies on a 0.5 grid, so the default tolerance
    rejects any genuinely corrupted value while float32 device
    accumulation stays exact well past the 64-spin die)."""
    e = np.asarray(energies, dtype=np.float64)
    if e.size == 0 or not np.all(np.isfinite(e)):
        return False
    s = np.asarray(sigma, dtype=np.float64)
    if s.shape != (problem.n,) or not np.all(np.abs(s) == 1.0):
        return False
    J = problem.J_levels.astype(np.float64)
    ref = -0.5 * float(s @ J @ s)
    return abs(ref - float(e.min())) <= atol + rtol * abs(ref)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Consecutive-failure breaker for one solver tier.

    A "failure" is one fully-exhausted retry loop (not one failed
    dispatch), so a single poisoned request being bisected out cannot trip
    the breaker — the interleaved successful halves reset the count. After
    ``cooldown_s`` an open breaker allows one half-open probe; success
    closes it, failure re-opens the cooldown window.
    """

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.trips = 0

    @property
    def open(self) -> bool:
        return (self.failures >= self.threshold and
                self.opened_at is not None and
                time.monotonic() - self.opened_at < self.cooldown_s)

    def allow(self) -> bool:
        """closed -> yes; open -> only after cooldown (half-open probe)."""
        return not self.open

    def record_success(self) -> None:
        self.failures = 0
        self.opened_at = None

    def record_failure(self) -> None:
        self.failures += 1
        if self.failures >= self.threshold:
            if self.opened_at is None:
                self.trips += 1
            self.opened_at = time.monotonic()

    def trip(self) -> None:
        """Open immediately (solver crash — no point counting to three)."""
        self.failures = max(self.failures + 1, self.threshold)
        if self.opened_at is None:
            self.trips += 1
        self.opened_at = time.monotonic()


# ---------------------------------------------------------------------------
# supervised flush executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlushOutcome:
    """Per-request result of a supervised flush."""
    ok: bool
    energies: Optional[np.ndarray] = None     # (R,) level-space per-run
    sigma: Optional[np.ndarray] = None        # (n,) int8
    solver: str = ""                          # tier that produced it
    degraded: bool = False                    # solved below the primary tier
    rescued: bool = False                     # recovery path changed the
    attempts: int = 1                         # flush composition
    error: Optional[BaseException] = None


class FlushExecutor:
    """The supervision layer between the batch planner and the registry.

    ``execute(reqs)`` runs one coalesced flush under the policy and returns
    ``(outcomes, partial_reports, dispatches)``: outcomes aligned with
    ``reqs``, the valid-row partial ``SolveReport``s (tagged with
    per-problem ``solver_by_problem``/``degraded`` meta so streamed merges
    keep provenance), and the device dispatches actually issued.
    Fallback tiers are built on ``torch_device`` (default ``"cuda"``).
    """

    def __init__(self, policy: ResiliencePolicy, primary: Callable,
                 solver_name: str, runs: int, seed: int, block: int,
                 torch_device: str = "cuda"):
        self.policy = policy
        self.torch_device = resolve_device(torch_device)
        self._primary = primary              # late-bound: tests swap it
        self.solver_name = solver_name
        self.runs, self.seed, self.block = int(runs), int(seed), int(block)
        self._tiers = [solver_name] + list(policy.fallback)
        self._fallback_instances: dict[str, object] = {}
        self._breakers = {name: CircuitBreaker(policy.breaker_threshold,
                                               policy.breaker_cooldown_s)
                          for name in self._tiers}
        self._rng = random.Random(policy.seed)
        self.detector = StragglerDetector()
        self._lock = threading.Lock()
        self.retries = 0
        self.bisections = 0
        self.hedges = 0
        self.timeouts = 0
        self.validation_failures = 0
        self.fallback_solves = 0
        self.failed_requests = 0

    # -- tier / solver resolution ------------------------------------------
    def _solver_at(self, tier: int):
        name = self._tiers[tier]
        if tier == 0:
            return self._primary()
        inst = self._fallback_instances.get(name)
        if inst is None:
            inst = self._fallback_instances[name] = get_solver(
                name, torch_device=self.torch_device)
        return inst

    def _next_allowed_tier(self, start: int) -> Optional[int]:
        """First tier >= ``start`` whose breaker allows a dispatch. The
        LAST tier is returned even with its breaker open — the chain's
        final rung never rejects (a probe beats certain failure)."""
        if start >= len(self._tiers):
            return None
        for t in range(start, len(self._tiers)):
            if self._breakers[self._tiers[t]].allow():
                return t
        return len(self._tiers) - 1

    # -- public entry ------------------------------------------------------
    def execute(self, reqs):
        outcomes: list[Optional[FlushOutcome]] = [None] * len(reqs)
        partials: list = []
        dispatches = [0]
        self._run(list(enumerate(reqs)), 0, False, 0,
                  outcomes, partials, dispatches)
        for k, o in enumerate(outcomes):      # belt-and-braces: no request
            if o is None:                     # may leave without an outcome
                outcomes[k] = FlushOutcome(
                    ok=False, error=FlushFailed("request lost by executor"))
        return outcomes, partials, dispatches[0]

    # -- supervision core --------------------------------------------------
    def _run(self, items, tier, rescued, vdepth,
             outcomes, partials, dispatches) -> None:
        """Solve ``items`` (list of (position, request)) at the first
        allowed tier >= ``tier``; recurse on failure (bisection / fallback)
        and on validation rejects."""
        tier = self._next_allowed_tier(tier)
        if tier is None:
            err = FlushFailed(
                f"fallback chain exhausted for {len(items)} request(s) "
                f"(tiers: {self._tiers})")
            self._fail_items(items, outcomes, err)
            return
        solver = self._solver_at(tier)
        name = self._tiers[tier]
        reqs = [r for _, r in items]
        try:
            rep, attempts = self._attempt(solver, name, reqs, tier)
        except ValueError as e:
            # a refused launch plan or another programming error: every
            # retry, half and tier would meet it again, and a fallback
            # would hide it, so it goes to the flush's tickets as it is
            self._fail_items(items, outcomes, e)
            return
        except Exception as e:
            if len(items) > 1:
                # bisect: isolate the poisoned request(s) instead of
                # failing the whole flush
                with self._lock:
                    self.bisections += 1
                mid = len(items) // 2
                self._run(items[:mid], tier, True, 0,
                          outcomes, partials, dispatches)
                self._run(items[mid:], tier, True, 0,
                          outcomes, partials, dispatches)
                return
            # singleton: escalate down the fallback chain
            if tier + 1 < len(self._tiers):
                self._run(items, tier + 1, True, 0,
                          outcomes, partials, dispatches)
            else:
                self._fail_items(items, outcomes, FlushFailed(
                    f"request failed on every tier; last error from "
                    f"{name!r}: {e!r}"))
            return

        dispatches[0] += rep.dispatches
        if self.policy.validate:
            ok = [validate_row(r.problem, rep.energies[k], rep.best_sigma[k],
                               self.policy.validate_atol,
                               self.policy.validate_rtol)
                  for k, r in enumerate(reqs)]
        else:
            ok = [True] * len(reqs)
        good = [k for k, v in enumerate(ok) if v]
        bad = [k for k, v in enumerate(ok) if not v]
        if bad:
            with self._lock:
                self.validation_failures += len(bad)
            log.warning("flush validation rejected %d/%d result row(s) "
                        "from %r — quarantining and re-dispatching",
                        len(bad), len(reqs), name)
        if good:
            sub = rep if not bad else rep.slice_problems(good)
            sub.meta["solver_by_problem"] = [name] * len(good)
            sub.meta["degraded"] = [tier > 0] * len(good)
            partials.append(sub)
            if tier > 0:
                with self._lock:
                    self.fallback_solves += len(good)
            for k in good:
                pos, _ = items[k]
                outcomes[pos] = FlushOutcome(
                    ok=True,
                    energies=np.asarray(rep.energies[k], dtype=np.float64),
                    sigma=np.asarray(rep.best_sigma[k], dtype=np.int8),
                    solver=name, degraded=tier > 0,
                    rescued=rescued or bool(bad), attempts=attempts)
        if bad:
            bad_items = [items[k] for k in bad]
            if vdepth < self.policy.max_retries:
                # same tier gets another chance (transient corruption)
                self._run(bad_items, tier, True, vdepth + 1,
                          outcomes, partials, dispatches)
            else:
                # persistent corruption: this tier cannot be trusted with
                # these requests — escalate
                self._run(bad_items, tier + 1, True, 0,
                          outcomes, partials, dispatches)

    def _fail_items(self, items, outcomes, err) -> None:
        with self._lock:
            self.failed_requests += len(items)
        for pos, _ in items:
            outcomes[pos] = FlushOutcome(ok=False, error=err)

    # -- one solver tier: bounded retry with backoff -----------------------
    def _attempt(self, solver, name, reqs, tier):
        suite = ProblemSuite([r.problem for r in reqs])
        budgets = [r.budget for r in reqs if r.budget is not None]
        budget = min(budgets) if budgets else None
        breaker = self._breakers[name]
        last: Optional[BaseException] = None
        for attempt in range(self.policy.max_retries + 1):
            if attempt:
                time.sleep(self._backoff(attempt))
                with self._lock:
                    self.retries += 1
            timeout = self._flush_timeout(reqs)
            t0 = time.monotonic()
            try:
                rep = self._timed_solve(solver, suite, budget, timeout)
            except SolverCrash:
                breaker.trip()
                raise
            except ValueError:           # not the solver's health: no retry,
                raise                    # no breaker count
            except Exception as e:       # noqa: BLE001 — supervised retry
                last = e
                log.warning("flush dispatch failed on %r "
                            "(attempt %d/%d): %r", name, attempt + 1,
                            self.policy.max_retries + 1, e)
                continue
            if tier == 0:
                with self._lock:
                    self.detector.observe(time.monotonic() - t0)
            breaker.record_success()
            return rep, attempt + 1
        breaker.record_failure()
        raise last

    def _backoff(self, attempt: int) -> float:
        base = min(self.policy.backoff_max_s,
                   self.policy.backoff_base_s *
                   self.policy.backoff_factor ** (attempt - 1))
        return base * (1.0 + self.policy.backoff_jitter * self._rng.random())

    # -- watchdog + hedged re-dispatch -------------------------------------
    def _flush_timeout(self, reqs) -> Optional[float]:
        """Deadline-derived watchdog for one flush: the tightest of the
        policy timeout, every member's remaining deadline, and the
        straggler detector's EWMA-scaled expectation — floored at
        ``min_timeout_s`` so a warm-path flush (or a first-dispatch kernel
        build) is never hedged spuriously."""
        p = self.policy
        cands = []
        if p.flush_timeout_s is not None:
            cands.append(p.flush_timeout_s)
        now = time.monotonic()
        for r in reqs:
            if r.deadline_s is not None:
                cands.append(r.submitted + r.deadline_s - now)
        with self._lock:
            det = self.detector
            if det.count > det.warmup and det.mean > 0:
                cands.append(p.straggler_factor * det.mean)
        if not cands:
            return None
        return max(p.min_timeout_s, min(cands))

    def _timed_solve(self, solver, suite, budget, timeout):
        kw = dict(runs=self.runs, seed=self.seed, budget=budget,
                  block=self.block)
        if timeout is None:
            return solver.solve(suite, **kw)
        q: queue_mod.Queue = queue_mod.Queue()

        def work():
            try:
                q.put(("ok", solver.solve(suite, **kw)))
            except BaseException as e:   # noqa: BLE001 — relayed to waiter
                q.put(("err", e))

        threading.Thread(target=work, daemon=True,
                         name="flush-dispatch").start()
        try:
            kind, val = q.get(timeout=timeout)
        except queue_mod.Empty:
            with self._lock:
                self.timeouts += 1
            if not self.policy.hedge:
                raise FlushTimeout(
                    f"flush exceeded {timeout:.3f}s watchdog") from None
            # straggler: hedge an identical dispatch (same seeds — the
            # winner is bit-identical either way); first completion wins
            with self._lock:
                self.hedges += 1
            threading.Thread(target=work, daemon=True,
                             name="flush-hedge").start()
            outstanding = 2
            hard = time.monotonic() + timeout * self.policy.hedge_grace
            last_err: Optional[BaseException] = None
            while outstanding:
                remaining = hard - time.monotonic()
                if remaining <= 0:
                    raise FlushTimeout(
                        f"flush and hedge both exceeded "
                        f"{timeout:.3f}s watchdog") from None
                try:
                    kind, val = q.get(timeout=remaining)
                except queue_mod.Empty:
                    raise FlushTimeout(
                        f"flush and hedge both exceeded "
                        f"{timeout:.3f}s watchdog") from None
                if kind == "ok":
                    return val
                outstanding -= 1
                last_err = val
            raise last_err
        if kind == "ok":
            return val
        raise val

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "retries": self.retries,
                "bisections": self.bisections,
                "hedges": self.hedges,
                "flush_timeouts": self.timeouts,
                "validation_failures": self.validation_failures,
                "fallback_solves": self.fallback_solves,
                "failed_requests": self.failed_requests,
                "breaker_trips": sum(b.trips
                                     for b in self._breakers.values()),
                "breaker_open": [n for n, b in self._breakers.items()
                                 if b.open],
                "flush_time_ewma_s": self.detector.mean,
            }
