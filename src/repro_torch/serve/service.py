"""``IsingService`` — request queue + dynamic batcher over one solve path.

The offline path (``solve_suite``) blocks per call and owns the whole
suite up front. A service sees the opposite regime — many small
heterogeneous instances arriving as a stream — and sustains throughput the
way the chip sustains its energy-to-solution: never let the array idle
between problems. Three mechanisms, all riding the shared
``api.batching`` planner:

* **Dynamic batching.** Submitted requests queue per coalescing group
  (padded size x budget tier). A group flushes when it holds ``max_batch``
  requests, or when its oldest request has waited ``max_wait_s`` (tight
  per-request deadlines shrink that wait — a request never queues longer
  than half its deadline). Each flush is ONE suite solve whose problems
  all share a pad bucket, so a batched solver issues exactly one device
  dispatch per flush — requests that arrive while a dispatch is in flight
  coalesce into the next one (continuous batching, not stop-and-wait).

* **Deadline -> budget.** A per-request ``deadline_s`` maps through
  ``api.budget.deadline_to_budget`` onto the same uniform effort
  multiplier every solver understands, then through ``search_effort``
  inside the solver. Requests batch with others in the same power-of-two
  budget tier, and the flushed dispatch runs at the tier's TIGHTEST
  budget, so no member's deadline is blown by a looser neighbor.

* **Content-hash result cache.** Results are cached under
  ``Problem.content_hash`` (plus solver/runs/seed identity); a repeated
  problem is answered without any dispatch, as long as the cached entry
  was computed at >= the requested effort. The cache persists through the
  same merge-on-store JSON machinery as the oracle cache, so parallel
  service workers union their entries instead of clobbering.

Flushes do not hit the solver registry directly: every dispatch runs
under the supervision layer in ``serve.resilience`` (bounded retry,
failure isolation by bisection, circuit breaker + fallback chain,
watchdog + hedged re-dispatch, float64 result validation), configured by
the service's :class:`~repro_torch.serve.resilience.ResiliencePolicy`. Under
queue pressure the service degrades request budgets down the
``api.budget.degrade_budget`` ladder before shedding anything, and sheds
with a typed :class:`~repro_torch.serve.resilience.Overloaded`. A
:class:`~repro_torch.serve.faults.FaultPlan` injects a deterministic fault
schedule under the same supervision — the chaos tests
(``tests/test_torch_resilience.py``) hold the gate that no faults lose
tickets or corrupt results.

Every flushed dispatch produces a per-bucket partial ``SolveReport``;
``report()`` returns the streamed ``merge`` of all of them, so the service
exposes the exact same metrics surface (SR/TTS/ETS, dispatch counts,
wall/compile split) as an offline solve.

The service, its fallback tiers and every solver it builds run on
``torch_device`` (default ``"cuda"``; without CUDA the constructor raises
unless given ``"cpu"``). The device's type is part of the result-cache
key's configuration digest: seeded draws are the same on every device
(``rng``), but the card's ``exp``, ``tanh`` and normals may differ from
the host's by an ULP, so a cache persisted through ``cache_path`` never
answers one device's request with the other's result. As in the
reference, the cache is in memory unless a ``cache_path`` is given.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
import threading
import time
from typing import Optional

import numpy as np

from ..api.batching import CHIP_BLOCK, padded_size
from ..api.budget import deadline_to_budget, degrade_budget
from ..api.problem import Problem
from ..api.registry import get_solver
from ..api.report import SolveReport
from ..device import resolve_device
from ..utils import (load_json_cache, load_sharded_json_cache,
                     store_json_cache, store_sharded_json_cache)
from .faults import FaultInjector, FaultPlan, FaultySolver, corrupt_cache_entry
from .qos import DEFAULT_QOS, QoSClass, resolve_qos
from .resilience import (FlushExecutor, Overloaded, RequestCancelled,
                         ResiliencePolicy, validate_row)


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """What one request gets back — the per-problem slice of the dispatch."""
    problem_hash: str
    energies: np.ndarray          # (R,) level-space per-run energies
    sigma: np.ndarray             # (n,) int8 best configuration
    latency_s: float              # submit -> resolve
    batch_size: int               # problems coalesced into the dispatch
    cached: bool                  # served from the result cache (no dispatch)
    budget: Optional[float]       # effective effort multiplier applied
    degraded: bool = False        # solved below the primary solver tier
    rescued: bool = False         # a recovery path (retry-after-validation,
    #                               bisection, tier escalation) re-composed
    #                               the flush that produced this result
    solver: str = ""              # tier that actually produced the answer
    attempts: int = 1             # dispatch attempts of the producing flush

    @property
    def best_energy(self) -> float:
        return float(np.min(self.energies))


class ServeTicket:
    """Handle for one in-flight request; ``result()`` blocks until solved."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Optional[ServeResult] = None
        self._error: Optional[BaseException] = None
        self._service: Optional["IsingService"] = None
        self._request: Optional["_Request"] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError("request not resolved within timeout")
        if self._error is not None:
            raise self._error
        return self._value

    def cancel(self) -> bool:
        """Withdraw this request (e.g. its caller timed out and nobody will
        read the result). Returns True if the cancellation took effect —
        the request was dequeued before dispatch, or marked for discard
        while in flight (its slot in the running flush still computes, but
        the result is dropped, never resolved and never cached under a
        caller that gave up). Returns False if the ticket had already
        resolved or failed. After a successful cancel, ``result()`` raises
        :class:`~repro_torch.serve.resilience.RequestCancelled`."""
        svc, req = self._service, self._request
        if svc is None or req is None or self._event.is_set():
            return False
        with svc._lock:
            if self._event.is_set():
                return False
            req.cancelled = True
            reqs = svc._pending.get(req.key)
            dequeued = False
            if reqs and req in reqs:
                reqs.remove(req)
                dequeued = True
                if not reqs:
                    del svc._pending[req.key]
            svc._cancelled += 1
        self._fail(RequestCancelled(
            "request cancelled " +
            ("before dispatch" if dequeued else "while in flight")))
        return True

    # -- service side ------------------------------------------------------
    def _bind(self, service: "IsingService", request: "_Request") -> None:
        self._service = service
        self._request = request

    def _resolve(self, value: ServeResult) -> None:
        if self._event.is_set():          # lost a race with cancel()
            return
        self._value = value
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        if self._event.is_set():
            return
        self._error = error
        self._event.set()


@dataclasses.dataclass
class _Request:
    problem: Problem
    budget: Optional[float]       # effort multiplier (deadline-mapped)
    deadline_s: Optional[float]
    submitted: float              # monotonic
    ticket: ServeTicket
    key: tuple = ()               # coalescing-group key (set at enqueue)
    cancelled: bool = False
    qos: str = DEFAULT_QOS


def budget_tier(budget: Optional[float]) -> Optional[int]:
    """Power-of-two coalescing tier: requests whose effort multipliers are
    within 2x batch together (the flush runs at the tier minimum)."""
    if budget is None:
        return None
    return int(round(math.log2(budget)))


# internal alias kept for existing callers/tests
_budget_tier = budget_tier


def batch_key(problem: Problem, budget: Optional[float],
              block: int = CHIP_BLOCK) -> tuple:
    """The coalescing-group key — (padded size, budget tier). The fleet
    router routes on THIS key, so requests that would batch together in a
    single service land on the same worker and still batch together."""
    return (padded_size(problem.n, block), budget_tier(budget))


def config_digest(solver_opts: dict, block: int, device: str) -> str:
    """Solver-configuration digest for the result-cache key: differently
    configured services sharing a persistent cache must never serve each
    other's results as equivalent (n_sweeps=20 vs 2000 is not the same
    answer, nor is a card's answer always the host's bit for bit)."""
    cfg = repr((sorted(solver_opts.items()), block, device))
    return hashlib.sha1(cfg.encode()).hexdigest()[:12]


def result_cache_key(solver_name: str, runs: int, seed: int,
                     cfg_digest: str, problem: Problem) -> str:
    """The result-cache key shape shared by :class:`IsingService` and the
    fleet's shared store. Ends in the content hash, which is also what
    the 16-way store sharding keys on (`utils.shard_of`)."""
    return f"{solver_name}:{runs}:{seed}:{cfg_digest}:{problem.content_hash}"


#: The serve tier's degrade ladder: every rung is a registered solver that
#: rides the same pad buckets. Device tiers first — sb-jax (simulated
#: bifurcation, one fused dispatch per bucket) then tabu-jax (the
#: near-exact searcher) — with the host SA loop last: it makes ZERO device
#: dispatches, so a service that has degraded all the way down still
#: answers without touching the accelerator the breaker just gave up on.
#: On a service whose ``torch_device`` is the card that rung is the one
#: place the port answers on the host after the card's tiers failed: it is
#: the reference's design, kept on purpose, and its answers are marked
#: ``degraded``. No kernel wrapper falls back to its plain version.
DEFAULT_FALLBACK_CHAIN = ("sb-jax", "tabu-jax", "sa-numpy")


def solver_for_deadline(deadline_s: Optional[float],
                        reference_s: float = 1.0) -> str:
    """Deadline -> solver tier, for ``IsingService(solver="auto")``.

    * ``None`` (no deadline): the paper's ``engine`` — the nominal tier
      every benchmark characterizes.
    * tight (``< reference_s``): ``sb-jax`` — simulated bifurcation
      converges in a few hundred fused-kernel steps at SR at or above the
      engine on dense instances, the best answer one fast dispatch buys.
    * loose (``>= 4 * reference_s``): ``tabu-jax`` — the slack is best
      spent on the near-exact search tier.
    * in between: ``engine``.

    The same ``reference_s`` scale feeds ``deadline_to_budget``, so the
    solver choice and the effort budget move together.
    """
    if deadline_s is None:
        return "engine"
    if deadline_s < reference_s:
        return "sb-jax"
    if deadline_s >= 4.0 * reference_s:
        return "tabu-jax"
    return "engine"


class IsingService:
    """Continuous-batching solve service over one registered solver.

    Parameters mirror the offline path (``solver``/``runs``/``seed``/
    ``block`` mean exactly what they mean in ``solve_suite``) plus the
    admission policy: ``max_batch`` problems per coalesced bucket,
    ``max_wait_s`` queueing time before a non-full bucket flushes anyway.
    ``cache_path=None`` keeps the result cache in-memory only;
    ``cache=False`` disables it entirely (every request dispatches).

    ``resilience`` is the :class:`ResiliencePolicy` for the supervision
    layer (default: validation + retry on, everything else off — the
    fault-free path is bit-identical to an unsupervised service).
    ``fault_plan`` arms deterministic fault injection for chaos runs.
    ``torch_device`` is where every tier solves (default ``"cuda"``).

    ``solver="auto"`` picks the tier from the service's target deadline
    via :func:`solver_for_deadline`: ``auto_deadline_s`` (sharing
    ``deadline_reference_s`` as its scale) names the latency the service
    is being provisioned for — tight deadlines resolve to ``sb-jax``,
    loose ones to ``tabu-jax``, none to the paper's ``engine``.
    """

    def __init__(self, solver: str = "engine", runs: int = 64,
                 seed: int = 0, block: int = CHIP_BLOCK,
                 torch_device: str = "cuda",
                 max_batch: int = 64, max_wait_s: float = 0.02,
                 cache: bool = True, cache_path: Optional[str] = None,
                 cache_shards: bool = False,
                 deadline_reference_s: float = 1.0,
                 auto_deadline_s: Optional[float] = None,
                 resilience: Optional[ResiliencePolicy] = None,
                 fault_plan: Optional[FaultPlan] = None, **solver_opts):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if solver == "auto":
            solver = solver_for_deadline(auto_deadline_s,
                                         reference_s=deadline_reference_s)
        self.solver_name = solver
        self.runs = int(runs)
        self.seed = int(seed)
        self.block = int(block)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.deadline_reference_s = float(deadline_reference_s)
        self.torch_device = resolve_device(torch_device)
        self.policy = resilience if resilience is not None \
            else ResiliencePolicy()
        self._injector = FaultInjector(fault_plan)
        self._solver = get_solver(solver, torch_device=self.torch_device,
                                  **solver_opts)
        if fault_plan is not None:
            self._solver = FaultySolver(self._solver, self._injector)
        # late-bound primary: tests (and hot solver swaps) may replace
        # self._solver after construction; the executor always dispatches
        # to the CURRENT one
        self._executor = FlushExecutor(
            self.policy, primary=lambda: self._solver,
            solver_name=solver, runs=self.runs, seed=self.seed,
            block=self.block, torch_device=self.torch_device)
        self._config_digest = config_digest(solver_opts, self.block,
                                            self.torch_device.type)

        self._cache_enabled = bool(cache)
        self._cache_path = cache_path
        # sharded layout (16 shards by content-hash prefix) is opt-in for a
        # standalone service and always-on under the fleet: one worker per
        # file-wide flock is fine, N workers contending on one inode is not
        self._cache_shards = bool(cache_shards)
        load = load_sharded_json_cache if cache_shards else load_json_cache
        self._cache: dict[str, dict] = (
            load(cache_path) if cache and cache_path else {})
        self._quarantined: set[str] = set()

        self._lock = threading.Condition()
        self._pending: dict[tuple, list[_Request]] = {}
        # per-flush partial reports; merged lazily in report() so the hot
        # path appends O(1) instead of re-concatenating the whole history
        # under the lock on every flush
        self._partials: list[SolveReport] = []
        self._running = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None
        # counters (under _lock); latency/batch windows are bounded so a
        # long-running service's stats() stays O(window), not O(lifetime)
        self._submitted = 0
        self._completed = 0
        self._cache_hits = 0
        self._flushes = 0            # coalesced pad buckets dispatched
        self._dispatches = 0         # device dispatches the solver issued
        self._errors = 0
        self._cancelled = 0
        self._shed = 0               # rejected with Overloaded at admission
        self._shed_by_qos: collections.Counter = collections.Counter()
        self._degraded_admissions = 0
        self._cache_quarantined = 0
        self._latencies: collections.deque = collections.deque(maxlen=100_000)
        self._batch_sizes: collections.deque = collections.deque(maxlen=10_000)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "IsingService":
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._draining = False
            self._started_at = time.monotonic()
            # a restart is a fresh serving run: counters, latency windows
            # and the streamed report all reset (rates would otherwise mix
            # the previous run's completions with this run's clock)
            self._submitted = self._completed = self._cache_hits = 0
            self._flushes = self._dispatches = self._errors = 0
            self._cancelled = self._shed = 0
            self._shed_by_qos.clear()
            self._degraded_admissions = self._cache_quarantined = 0
            self._latencies.clear()
            self._batch_sizes.clear()
            self._partials = []
        self._thread = threading.Thread(target=self._worker,
                                        name="ising-serve", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the worker. ``drain`` (default) flushes and resolves every
        queued request first; otherwise queued requests fail."""
        with self._lock:
            if not self._running:
                return
            self._draining = drain
            self._running = False
            self._lock.notify_all()
        self._thread.join()
        self._thread = None
        if not drain:
            with self._lock:
                for reqs in self._pending.values():
                    for r in reqs:
                        r.ticket._fail(RuntimeError("service stopped"))
                self._pending.clear()
        self._persist_cache()

    def __enter__(self) -> "IsingService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface ----------------------------------------------------
    def submit(self, problem: Problem, deadline_s: Optional[float] = None,
               budget: Optional[float] = None,
               qos: str = DEFAULT_QOS) -> ServeTicket:
        """Queue one problem; returns immediately with a ticket.

        ``deadline_s`` maps to an effort budget via ``deadline_to_budget``
        (an explicit ``budget`` overrides the mapping) and also bounds the
        request's queueing time at ``deadline_s / 2``.

        Under queue pressure (``policy.degrade_pending`` /
        ``policy.shed_pending``) admission degrades the effort budget down
        the ``degrade_budget`` ladder first, and only past the shed
        threshold rejects with :class:`Overloaded` — a degraded answer
        beats no answer, and a typed early rejection beats a timeout.
        ``qos`` (``interactive``/``normal``/``batch``) scales those
        thresholds per request, so batch traffic degrades and sheds first
        while interactive traffic holds out longest.
        """
        with self._lock:
            if not self._running:
                raise RuntimeError("service is not running; use "
                                   "`with IsingService(...) as svc:` or "
                                   "call start()")
        if not isinstance(problem, Problem):
            problem = Problem.from_couplings(problem)
        caps = self._solver.caps
        if caps.max_n is not None and problem.n > caps.max_n:
            raise ValueError(
                f"solver {self.solver_name!r} takes N <= {caps.max_n}; "
                f"got N={problem.n} (serve larger instances through a "
                f"'chip-lns' service)")
        qcls = resolve_qos(qos)
        if budget is None:
            budget = deadline_to_budget(
                deadline_s, reference_s=self.deadline_reference_s)
        elif budget <= 0:
            raise ValueError(f"budget must be positive, got {budget}")
        budget = self._admit(budget, qcls)

        ticket = ServeTicket()
        req = _Request(problem=problem, budget=budget, deadline_s=deadline_s,
                       submitted=time.monotonic(), ticket=ticket,
                       qos=qcls.name)
        ticket._bind(self, req)

        hit = self._cache_lookup(req)
        if hit is not None:
            ticket._resolve(hit)
            with self._lock:
                self._submitted += 1
                self._completed += 1
                self._cache_hits += 1
                self._latencies.append(hit.latency_s)
            return ticket

        key = batch_key(problem, budget, self.block)
        req.key = key
        with self._lock:
            if not self._running:
                raise RuntimeError("service is not running; use "
                                   "`with IsingService(...) as svc:` or "
                                   "call start()")
            self._submitted += 1
            self._pending.setdefault(key, []).append(req)
            self._lock.notify_all()
        return ticket

    def _admit(self, budget: Optional[float],
               qcls: Optional[QoSClass] = None) -> Optional[float]:
        """Overload admission control: shed past ``shed_pending`` queued
        requests, degrade the effort budget one ladder rung per
        ``degrade_pending`` of queue depth before that. A request's QoS
        class scales both thresholds (batch: 0.5x — first to suffer;
        interactive: 1.5–2x — last), so overload lands on low-priority
        work first without a separate queue per class."""
        p = self.policy
        if p.degrade_pending is None and p.shed_pending is None:
            return budget
        dfac = qcls.degrade_factor if qcls is not None else 1.0
        sfac = qcls.shed_factor if qcls is not None else 1.0
        with self._lock:
            depth = sum(len(v) for v in self._pending.values())
            if p.shed_pending is not None and depth >= p.shed_pending * sfac:
                self._shed += 1
                if qcls is not None:
                    self._shed_by_qos[qcls.name] += 1
                raise Overloaded(
                    f"service overloaded: {depth} requests queued "
                    f"(shed threshold {p.shed_pending * sfac:g}); retry "
                    f"with backoff")
            degrade_at = (p.degrade_pending * dfac
                          if p.degrade_pending is not None else None)
            if degrade_at is not None and depth >= degrade_at:
                level = 1 + int((depth - degrade_at) // degrade_at)
                degraded = degrade_budget(budget, level)
                if degraded != (budget if budget is not None else 1.0):
                    self._degraded_admissions += 1
                    return degraded
        return budget

    def submit_many(self, problems, **kw) -> list[ServeTicket]:
        return [self.submit(p, **kw) for p in problems]

    def report(self) -> Optional[SolveReport]:
        """Streamed merge of every flushed bucket's partial SolveReport —
        the same schema the offline path returns for a whole suite. The
        merge happens here, on demand, not per flush; its size (and the
        service's report memory) grows with the number of problems
        dispatched, so long-running deployments that only need counters
        should read ``stats()`` instead. Flushes rescued down the fallback
        chain mix solvers — ``meta["solver_by_problem"]`` and
        ``meta["degraded"]`` carry per-problem provenance."""
        with self._lock:
            partials = list(self._partials)
        if not partials:
            return None
        return SolveReport.merge_many(partials, mixed_ok=True)

    def stats(self) -> dict:
        """Live service counters: latency percentiles, throughput, cache
        hit rate, the coalescing/dispatch ledger, and the resilience
        layer's supervision/fault ledgers."""
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
            elapsed = (time.monotonic() - self._started_at
                       if self._started_at else 0.0)
            out = {
                "submitted": self._submitted,
                "completed": self._completed,
                "pending": sum(len(v) for v in self._pending.values()),
                "errors": self._errors,
                "cancelled": self._cancelled,
                "shed": self._shed,
                "shed_by_qos": dict(self._shed_by_qos),
                "degraded_admissions": self._degraded_admissions,
                "cache_hits": self._cache_hits,
                "cache_hit_rate": (self._cache_hits / self._submitted
                                   if self._submitted else 0.0),
                "cache_quarantined": self._cache_quarantined,
                "flushes": self._flushes,
                "dispatches": self._dispatches,
                "mean_batch": (float(np.mean(self._batch_sizes))
                               if self._batch_sizes else 0.0),
                "p50_latency_s": (float(np.percentile(lat, 50))
                                  if lat.size else 0.0),
                "p95_latency_s": (float(np.percentile(lat, 95))
                                  if lat.size else 0.0),
                "elapsed_s": elapsed,
                "problems_per_s": (self._completed / elapsed
                                   if elapsed > 0 else 0.0),
            }
        out["resilience"] = self._executor.stats()
        out["faults"] = self._injector.stats()
        return out

    # -- batcher -----------------------------------------------------------
    def _wait_allowance(self, req: _Request) -> float:
        """How long this request may queue: the service's max wait, capped
        at half the request's own deadline (the other half is for the
        dispatch itself)."""
        if req.deadline_s is None:
            return self.max_wait_s
        return min(self.max_wait_s, 0.5 * req.deadline_s)

    def _due_keys(self, now: float):
        """(keys ready to flush, seconds until the next one becomes due)."""
        due, next_due = [], None
        for key, reqs in self._pending.items():
            if not reqs:
                continue
            if len(reqs) >= self.max_batch or self._draining:
                due.append(key)
                continue
            fire_at = min(r.submitted + self._wait_allowance(r)
                          for r in reqs)
            if fire_at <= now:
                due.append(key)
            elif next_due is None or fire_at < next_due:
                next_due = fire_at
        return due, next_due

    def _worker(self) -> None:
        while True:
            with self._lock:
                if not self._running and not self._draining:
                    return                 # stop(drain=False): leave the
                now = time.monotonic()     # queue for stop() to fail
                due, next_due = self._due_keys(now)
                if not due:
                    if not self._running:
                        return
                    timeout = (None if next_due is None
                               else max(0.0, next_due - now))
                    self._lock.wait(timeout)
                    continue
                batches = []
                for key in due:
                    reqs = self._pending.pop(key)
                    # honor max_batch even on a burst: split oversize groups
                    for i in range(0, len(reqs), self.max_batch):
                        batches.append(reqs[i:i + self.max_batch])
            for reqs in batches:           # dispatch OUTSIDE the lock —
                self._solve_batch(reqs)    # new submits keep coalescing

    def _solve_batch(self, reqs: list[_Request]) -> None:
        with self._lock:
            # requests cancelled after being popped from the queue are
            # discarded here, before the dispatch is sized
            live = [r for r in reqs if not r.cancelled]
        if not live:
            return
        outcomes, partials, dispatches = self._executor.execute(live)
        now = time.monotonic()
        results: list[Optional[ServeResult]] = []
        for r, o in zip(live, outcomes):
            if not o.ok:
                results.append(None)
                continue
            results.append(ServeResult(
                problem_hash=r.problem.content_hash,
                energies=o.energies, sigma=o.sigma,
                latency_s=now - r.submitted, batch_size=len(live),
                cached=False, budget=r.budget, degraded=o.degraded,
                rescued=o.rescued, solver=o.solver, attempts=o.attempts))
        for r, res in zip(live, results):
            # degraded results answer the caller but never poison the
            # cache: they were produced below the primary tier, and the
            # cache key promises the primary solver's answer
            if res is not None and not res.degraded and not r.cancelled:
                self._cache_store(r, res)
        with self._lock:
            self._partials.extend(partials)
            self._flushes += 1
            self._dispatches += dispatches
            self._batch_sizes.append(len(live))
            for r, res in zip(live, results):
                if r.cancelled:
                    continue
                if res is None:
                    self._errors += 1
                else:
                    self._completed += 1
                    self._latencies.append(res.latency_s)
        for r, o, res in zip(live, outcomes, results):
            if r.cancelled:
                continue
            self._deliver(r, o, res)

    def _deliver(self, r: _Request, o, res: Optional[ServeResult]) -> None:
        """Hand one flushed request's outcome to its ticket. Subclasses
        (the fleet worker) interpose here — a fleet delivery must pass the
        work ledger's epoch check first, so a flush whose lease was
        reclaimed mid-solve is discarded instead of double-resolving."""
        if res is None:
            r.ticket._fail(o.error)
        else:
            r.ticket._resolve(res)

    # -- result cache ------------------------------------------------------
    def _cache_key(self, problem: Problem) -> str:
        return result_cache_key(self.solver_name, self.runs, self.seed,
                                self._config_digest, problem)

    def _cache_lookup(self, req: _Request) -> Optional[ServeResult]:
        if not self._cache_enabled:
            return None
        key = self._cache_key(req.problem)
        with self._lock:
            entry = self._cache.get(key)
        if entry is None:
            return None
        # an entry only serves requests asking for <= its effort
        have = entry.get("budget") or 1.0
        want = req.budget if req.budget is not None else 1.0
        if have < want - 1e-9:
            return None
        energies = np.asarray(entry.get("energies", ()), dtype=np.float64)
        sigma = np.asarray(entry.get("sigma", ()), dtype=np.int8)
        if self.policy.validate and not validate_row(
                req.problem, energies, sigma,
                self.policy.validate_atol, self.policy.validate_rtol):
            # corrupt entry (torn write, bit rot, injected fault): quarantine
            # — evict from memory AND remember the key so _persist_cache
            # drops it from disk instead of merge-resurrecting it
            with self._lock:
                self._cache.pop(key, None)
                self._quarantined.add(key)
                self._cache_quarantined += 1
            return None
        return ServeResult(
            problem_hash=req.problem.content_hash,
            energies=energies, sigma=sigma,
            latency_s=time.monotonic() - req.submitted,
            batch_size=0, cached=True, budget=entry.get("budget"))

    def _cache_store(self, req: _Request, res: ServeResult) -> None:
        if not self._cache_enabled:
            return
        key = self._cache_key(req.problem)
        new = {"budget": res.budget,
               "energies": [float(e) for e in res.energies],
               "sigma": [int(s) for s in res.sigma],
               "n": req.problem.n}
        if self._injector.draw("cache") == "corrupt_cache_write":
            new = corrupt_cache_entry(
                new, self._injector.injected["corrupt_cache_write"])
        with self._lock:
            old = self._cache.get(key)
            self._cache[key] = _higher_effort(old, new) if old else new

    def _persist_cache(self) -> None:
        if not (self._cache_enabled and self._cache_path):
            return
        with self._lock:
            cache = dict(self._cache)
            drop = tuple(self._quarantined)
        if cache or drop:
            store = (store_sharded_json_cache if self._cache_shards
                     else store_json_cache)
            store(self._cache_path, cache, resolve=_higher_effort, drop=drop)


def _higher_effort(old: dict, new: dict) -> dict:
    """Concurrent-writer conflict rule for the result cache: keep the entry
    computed at the higher effort budget (it serves every request the
    lower-effort one could, and more)."""
    try:
        return new if (new.get("budget") or 1.0) >= (old.get("budget") or 1.0) \
            else old
    except AttributeError:
        return new
