"""``repro_torch.serve.fleet`` — a crash-tolerant multi-worker IsingService.

One :class:`~repro_torch.serve.service.IsingService` is one failure domain: a
crash loses every queued ticket, and its flock-serialized JSON cache
makes N processes contend on one inode. The fleet splits the roles the
way a scale-out serving stack does, while keeping every solve-path
invariant the single service already gates (one device dispatch per
flush, float64 validation, degrade-before-shed):

* **FleetRouter front-end** (the :class:`IsingFleet` object itself):
  admission control + shared result cache + routing. Routing is by the
  SAME coalescing key the single service batches on — ``(padded size,
  budget tier)`` via :func:`~repro_torch.serve.service.batch_key` — through
  rendezvous hashing over the live worker set
  (:func:`~repro_torch.distributed.elastic.rendezvous_route`). All requests
  sharing a batch key land on one worker, so cross-worker coalescing is
  preserved: the fleet never splits a batchable group across workers,
  and a worker leaving moves only the keys it owned.

* **N FleetWorkers**, each the service's supervised solve loop — a
  :class:`IsingService` subclass running its own batcher thread and
  :class:`~repro_torch.serve.resilience.FlushExecutor` (retry, bisection,
  breaker + fallback, hedging, float64 validation) — modeling worker
  *processes*: a worker can die mid-flush and takes nothing down with it.

* **WorkLedger** — crash-tolerant work ownership. Every ticket is
  registered before it is routed; a worker takes a *lease* (epoch-bumped,
  wall-clock expiry) on the tickets of each flush it dispatches; a
  resolution is accepted only if it carries the item's CURRENT epoch.
  The reaper thread reclaims items whose lease expired, whose owner
  died, or which a faulty router never enqueued (``router_drop``), bumps
  their epoch (instantly invalidating any in-flight resolution by the
  old owner — no double resolution), and re-routes them to a survivor.
  Zero lost tickets: every registered item terminates in exactly one
  accepted resolution.

* **Sharded shared stores** — the fleet result cache persists through
  ``utils.store_sharded_json_cache`` (16 shards by content-hash prefix),
  so concurrent writers flock per shard, not per store.

Determinism contract (held by ``tests/test_torch_fleet.py``): routing
is a pure function of (batch key, live member set) and each worker's
executor seed is fixed, so for a burst-submitted stream a seeded
``FaultPlan.for_fleet`` worker kill leaves every row not owned by the
dead worker bit-identical to the fault-free run, and the reclaimed rows
re-solve on a survivor under the same executor seed and flush
composition.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api.batching import CHIP_BLOCK
from ..api.budget import deadline_to_budget, degrade_budget
from ..api.problem import Problem
from ..device import resolve_device
from ..distributed.elastic import WorkerSet, rendezvous_route
from ..utils import load_sharded_json_cache, store_sharded_json_cache
from .faults import FaultInjector, FaultPlan
from .qos import DEFAULT_QOS, QoSClass, resolve_qos
from .resilience import Overloaded, ResiliencePolicy, validate_row
from .service import (IsingService, ServeResult, ServeTicket, _higher_effort,
                      _Request, batch_key, config_digest, result_cache_key)


class WorkerKilled(BaseException):
    """Raised inside a FleetWorker's batcher thread by an injected
    ``worker_crash`` — derives from BaseException so no supervised-solve
    ``except Exception`` handler can accidentally 'rescue' a process
    death; the thread unwinds without releasing its leases, exactly like
    a SIGKILLed process."""


@dataclasses.dataclass
class _FleetRequest(_Request):
    """A ledger-tracked request. ``item_id`` is its WorkLedger identity;
    the lease epoch is NOT stored here — it is thread-confined to the
    flushing worker (two workers may hold the same request object during
    a lease-expiry race, and the ledger's epoch check is the arbiter)."""
    item_id: int = -1


# ledger item states
_PENDING, _LEASED, _RESOLVED = "pending", "leased", "resolved"


@dataclasses.dataclass
class _WorkItem:
    item_id: int
    req: _FleetRequest
    state: str = _PENDING
    worker: Optional[str] = None      # current assignee (router or lease)
    epoch: int = 0                    # bumped by lease() and reclaim
    lease_deadline: Optional[float] = None  # monotonic; None = not leased
    registered_at: float = 0.0
    reclaims: int = 0


class WorkLedger:
    """Crash-tolerant work ownership: register → assign → lease → resolve,
    with epoch-checked resolution and reaper-driven reclaim.

    The epoch is the whole correctness story. ``lease()`` bumps it and
    ``resolve()`` only accepts the current value, so after a reclaim
    (which also bumps it) the previous owner's in-flight flush resolves
    into a stale epoch and is discarded — a ticket can never be answered
    twice, no matter how late a presumed-dead worker's result arrives.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: Dict[int, _WorkItem] = {}
        self._next_id = 0
        # counters (monotonic, under _lock)
        self.registered = 0
        self.resolved_ok = 0
        self.resolved_err = 0
        self.reclaimed = 0
        self.reclaims_by_reason: collections.Counter = collections.Counter()
        self.stale_resolves = 0

    def register(self, req: _FleetRequest) -> int:
        with self._lock:
            item_id = self._next_id
            self._next_id += 1
            req.item_id = item_id
            self._items[item_id] = _WorkItem(
                item_id=item_id, req=req, registered_at=time.monotonic())
            self.registered += 1
            return item_id

    def assign(self, item_id: int, worker: str) -> None:
        with self._lock:
            item = self._items[item_id]
            if item.state != _RESOLVED:
                item.worker = worker

    def lease(self, item_ids: List[int], worker: str,
              duration_s: float) -> Dict[int, int]:
        """Take ownership of a flush's items; returns item -> epoch. The
        returned epochs are what the flusher must present to resolve()."""
        now = time.monotonic()
        epochs: Dict[int, int] = {}
        with self._lock:
            for item_id in item_ids:
                item = self._items[item_id]
                if item.state == _RESOLVED:
                    continue               # raced a reclaim that resolved it
                item.state = _LEASED
                item.worker = worker
                item.epoch += 1
                item.lease_deadline = now + duration_s
                epochs[item_id] = item.epoch
        return epochs

    def resolve(self, item_id: int, epoch: int, ok: bool = True) -> bool:
        """Accept a resolution iff ``epoch`` is the item's current epoch
        and it has not already resolved. Returns False (and counts a
        stale resolve) otherwise — the caller must then DISCARD its
        result rather than touch the ticket."""
        with self._lock:
            item = self._items.get(item_id)
            if item is None or item.state == _RESOLVED or item.epoch != epoch:
                self.stale_resolves += 1
                return False
            item.state = _RESOLVED
            item.lease_deadline = None
            if ok:
                self.resolved_ok += 1
            else:
                self.resolved_err += 1
            return True

    def reclaim(self, dead_workers, orphan_after_s: float,
                now: Optional[float] = None,
                stuck_after_s: Optional[float] = None,
                ) -> List[Tuple[str, _FleetRequest]]:
        """Find and take back every unresolved item that (a) is owned by a
        dead worker, (b) has an expired lease, or (c) was registered but
        never assigned for longer than ``orphan_after_s`` (a router
        drop). Bumps each reclaimed item's epoch — any in-flight flush by
        the old owner is invalidated BEFORE the item is re-dispatched —
        and returns (reason, request) pairs for the caller to re-route.

        ``stuck_after_s`` is a backstop for the assigned-but-never-leased
        crack (the router picked a worker that died between membership
        check and enqueue): a pending item that has sat assigned for that
        long is re-routed too. Harmless if it was merely queued — the
        epoch bump makes whichever copy flushes second resolve stale."""
        now = time.monotonic() if now is None else now
        dead = set(dead_workers)
        out: List[Tuple[str, _FleetRequest]] = []
        with self._lock:
            for item in self._items.values():
                if item.state == _RESOLVED:
                    continue
                age = now - item.registered_at
                if item.worker is not None and item.worker in dead:
                    reason = "worker_dead"
                elif (item.state == _LEASED and item.lease_deadline is not None
                        and item.lease_deadline <= now):
                    reason = "lease_expired"
                elif (item.state == _PENDING and item.worker is None
                        and age >= orphan_after_s):
                    reason = "router_drop"
                elif (item.state == _PENDING and item.worker is not None
                        and stuck_after_s is not None
                        and age >= stuck_after_s):
                    reason = "stuck_pending"
                else:
                    continue
                item.state = _PENDING
                item.worker = None
                item.epoch += 1
                item.lease_deadline = None
                item.reclaims += 1
                self.reclaimed += 1
                self.reclaims_by_reason[reason] += 1
                out.append((reason, item.req))
        return out

    def open_count(self) -> int:
        with self._lock:
            return sum(1 for i in self._items.values()
                       if i.state != _RESOLVED)

    def stats(self) -> dict:
        with self._lock:
            return {
                "registered": self.registered,
                "resolved_ok": self.resolved_ok,
                "resolved_err": self.resolved_err,
                "open": sum(1 for i in self._items.values()
                            if i.state != _RESOLVED),
                "reclaimed": self.reclaimed,
                "reclaims_by_reason": dict(self.reclaims_by_reason),
                "stale_resolves": self.stale_resolves,
            }


class FleetWorker(IsingService):
    """One fleet worker: the service's full supervised solve loop, with the
    flush path wrapped in lease-take / epoch-checked delivery, and crash
    faults modeled as the batcher thread dying mid-flush without
    releasing anything. Its result cache is the FLEET's shared store;
    the worker-local cache machinery is disabled."""

    def __init__(self, worker_id: str, fleet: "IsingFleet", **service_kw):
        super().__init__(cache=False, **service_kw)
        self.worker_id = worker_id
        self.fleet = fleet
        self.crashed = False
        # thread-confined: written and read only by this worker's batcher
        # thread, between lease() in _solve_batch and the _deliver calls
        # of the same flush
        self._flush_epochs: Dict[int, int] = {}

    # the fleet routes; clients must not submit to a worker directly
    def submit(self, *a, **kw):  # pragma: no cover - guard
        raise RuntimeError("submit to the IsingFleet, not a FleetWorker")

    def enqueue(self, req: _FleetRequest) -> None:
        """Router-side: queue an already-registered, already-routed
        request into this worker's batcher."""
        with self._lock:
            if not self._running:
                raise RuntimeError(f"worker {self.worker_id} is not running")
            self._submitted += 1
            self._pending.setdefault(req.key, []).append(req)
            self._lock.notify_all()

    def _worker(self) -> None:
        try:
            super()._worker()
        except WorkerKilled:
            # modeled process death: the batcher thread unwinds holding
            # every lease it took — silently, like a SIGKILL (the default
            # threading excepthook would print a traceback for what the
            # chaos plan did on purpose)
            pass

    def _solve_batch(self, reqs) -> None:
        fleet = self.fleet
        # one fault draw per flush at this worker's namespaced site —
        # deterministic in (worker, flush index) under a seeded plan
        kind = fleet._injector.draw(f"worker:{self.worker_id}")
        lease_s = 0.0 if kind == "lease_expiry" else fleet.lease_s
        self._flush_epochs = fleet.ledger.lease(
            [r.item_id for r in reqs], self.worker_id, lease_s)
        if kind == "worker_crash":
            # process death: mark the corpse (heartbeat loss, modeled
            # synchronously so chaos runs are deterministic) and unwind
            # the batcher thread holding every lease it just took
            self.crashed = True
            with self._lock:
                self._running = False
                self._draining = False
            fleet._note_worker_crash(self.worker_id)
            raise WorkerKilled(self.worker_id)
        super()._solve_batch(reqs)

    def _deliver(self, r: _FleetRequest, o, res) -> None:
        accepted = self.fleet.ledger.resolve(
            r.item_id, self._flush_epochs.get(r.item_id, -1),
            ok=res is not None)
        if not accepted:
            return          # lease reclaimed mid-solve: discard, the new
        if res is None:     # owner answers the ticket (no double resolve)
            self.fleet._note_resolved(None)
            r.ticket._fail(o.error)
        else:
            self.fleet._note_resolved(res.latency_s)
            r.ticket._resolve(res)

    def _cache_store(self, req: _FleetRequest, res: ServeResult) -> None:
        self.fleet._shared_cache_put(req, res)


class IsingFleet:
    """Front-end router + worker fleet + work ledger, presenting the same
    client surface as :class:`IsingService` (``submit``/``stats``/
    context manager) with crash tolerance across N workers.

    ``workers`` names the starting fleet size; workers join/leave
    elastically at runtime via :meth:`add_worker`/:meth:`remove_worker`.
    ``torch_device`` is every worker's (default ``"cuda"``, which raises
    without a card). ``fault_plan`` arms fleet-level deterministic chaos
    (:meth:`FaultPlan.for_fleet` sites: ``worker:<i>`` per flush,
    ``router`` per registration). Solver-level configuration kwargs are
    forwarded verbatim to every worker, so each worker's FlushExecutor is
    seeded identically — the root of the bit-identical reclaim contract.
    """

    def __init__(self, workers: int = 2, solver: str = "engine",
                 runs: int = 64, seed: int = 0, block: int = CHIP_BLOCK,
                 torch_device: str = "cuda",
                 max_batch: int = 64, max_wait_s: float = 0.02,
                 cache: bool = True, cache_path: Optional[str] = None,
                 deadline_reference_s: float = 1.0,
                 resilience: Optional[ResiliencePolicy] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 lease_s: float = 30.0,
                 reaper_interval_s: float = 0.02,
                 orphan_after_s: Optional[float] = None, **solver_opts):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.solver_name = solver
        self.runs = int(runs)
        self.seed = int(seed)
        self.block = int(block)
        self.deadline_reference_s = float(deadline_reference_s)
        self.policy = resilience if resilience is not None \
            else ResiliencePolicy()
        self.lease_s = float(lease_s)
        self.reaper_interval_s = float(reaper_interval_s)
        # router drops surface as registered-but-never-assigned items; give
        # the router 2 batching windows before calling it a drop
        self.orphan_after_s = (2.0 * max_wait_s if orphan_after_s is None
                               else float(orphan_after_s))
        self._injector = FaultInjector(fault_plan)
        self.ledger = WorkLedger()
        self.members = WorkerSet()
        self._worker_kw = dict(
            solver=solver, runs=runs, seed=seed, block=block,
            torch_device=resolve_device(torch_device),
            max_batch=max_batch, max_wait_s=max_wait_s,
            deadline_reference_s=deadline_reference_s,
            resilience=self.policy, **solver_opts)
        self._workers: Dict[str, FleetWorker] = {}
        self._n_started = int(workers)

        self._config_digest = config_digest(
            solver_opts, self.block, self._worker_kw["torch_device"].type)
        self._cache_enabled = bool(cache)
        self._cache_path = cache_path
        self._cache: Dict[str, dict] = {}
        self._quarantined: set = set()

        self._lock = threading.Lock()
        self._running = False
        self._started_at: Optional[float] = None
        self._reaper: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._submitted = 0
        self._completed = 0
        self._errors = 0
        self._cache_hits = 0
        self._shed = 0
        self._shed_by_qos: collections.Counter = collections.Counter()
        self._degraded_admissions = 0
        self._router_drops = 0
        self._worker_crashes = 0
        self._cache_quarantined = 0
        self._latencies: collections.deque = collections.deque(maxlen=100_000)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "IsingFleet":
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._started_at = time.monotonic()
            self._stop_evt.clear()
        if self._cache_enabled and self._cache_path:
            self._cache = load_sharded_json_cache(self._cache_path)
        for i in range(self._n_started):
            self.add_worker()
        self._reaper = threading.Thread(target=self._reap_loop,
                                        name="fleet-reaper", daemon=True)
        self._reaper.start()
        return self

    def stop(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop the fleet. ``drain`` (default) blocks until every
        registered ticket has resolved — the reaper keeps reclaiming
        through the drain, so even tickets stranded on a crashed worker
        terminate before teardown."""
        with self._lock:
            if not self._running:
                return
        if drain:
            self._drain(timeout_s)
        with self._lock:
            self._running = False
        self._stop_evt.set()
        if self._reaper is not None:
            self._reaper.join()
            self._reaper = None
        for w in list(self._workers.values()):
            if not w.crashed:
                w.stop(drain=drain)
        self._persist_cache()

    def _drain(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while self.ledger.open_count() > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet drain timed out with "
                    f"{self.ledger.open_count()} tickets open")
            time.sleep(0.005)

    def join(self, timeout_s: float = 60.0) -> None:
        """Block until every registered ticket has resolved."""
        self._drain(timeout_s)

    def __enter__(self) -> "IsingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- elastic membership ------------------------------------------------
    def add_worker(self) -> str:
        """Join one worker to the fleet; routing picks it up immediately
        (rendezvous hashing moves only the keys it now wins)."""
        with self._lock:
            worker_id = f"w{len(self._workers)}"
            while worker_id in self._workers:
                worker_id = f"w{int(worker_id[1:]) + 1}"
            w = FleetWorker(worker_id, self, **self._worker_kw)
            self._workers[worker_id] = w
        w.start()
        self.members.join(worker_id)
        return worker_id

    def remove_worker(self, worker_id: str, drain: bool = True) -> None:
        """Gracefully leave: unroute first (new work stops arriving), then
        drain the worker's queue — its in-flight leases resolve normally,
        so nothing is reclaimed or lost on a planned departure."""
        self.members.leave(worker_id)
        w = self._workers.pop(worker_id, None)
        if w is not None and not w.crashed:
            w.stop(drain=drain)

    def _note_worker_crash(self, worker_id: str) -> None:
        self.members.mark_dead(worker_id)
        with self._lock:
            self._worker_crashes += 1

    # -- client surface ----------------------------------------------------
    def submit(self, problem: Problem, deadline_s: Optional[float] = None,
               budget: Optional[float] = None,
               qos: str = DEFAULT_QOS) -> ServeTicket:
        """Queue one problem fleet-wide; returns a ticket whose result may
        be produced by any worker (or by a survivor after a crash)."""
        with self._lock:
            if not self._running:
                raise RuntimeError("fleet is not running; use "
                                   "`with IsingFleet(...) as fleet:` or "
                                   "call start()")
        if not isinstance(problem, Problem):
            problem = Problem.from_couplings(problem)
        qcls = resolve_qos(qos)
        if budget is None:
            budget = deadline_to_budget(
                deadline_s, reference_s=self.deadline_reference_s)
        elif budget <= 0:
            raise ValueError(f"budget must be positive, got {budget}")
        budget = self._admit(budget, qcls)

        ticket = ServeTicket()
        req = _FleetRequest(problem=problem, budget=budget,
                            deadline_s=deadline_s,
                            submitted=time.monotonic(), ticket=ticket,
                            qos=qcls.name)
        req.key = batch_key(problem, budget, self.block)
        with self._lock:
            self._submitted += 1

        hit = self._cache_lookup(req)
        if hit is not None:
            with self._lock:
                self._completed += 1
                self._cache_hits += 1
                self._latencies.append(hit.latency_s)
            ticket._resolve(hit)
            return ticket

        self.ledger.register(req)
        if self._injector.draw("router") == "router_drop":
            # the router 'loses' the ticket after registration — the
            # reaper finds the orphaned ledger item and re-routes it
            with self._lock:
                self._router_drops += 1
            return ticket
        self._route(req)
        return ticket

    def submit_many(self, problems, **kw) -> List[ServeTicket]:
        return [self.submit(p, **kw) for p in problems]

    def _route(self, req: _FleetRequest) -> None:
        """Assign + enqueue on the batch key's rendezvous owner. All
        requests sharing a key pick the same worker, so the fleet batches
        exactly as wide as one service would."""
        live = self.members.live()
        if not live:
            return                   # total outage: reaper retries later
        worker_id = rendezvous_route(repr(req.key), live)
        self.ledger.assign(req.item_id, worker_id)
        worker = self._workers.get(worker_id)
        try:
            worker.enqueue(req)
        except (RuntimeError, AttributeError):
            # chose a worker that died between live() and enqueue — the
            # assignment marks it reclaimable the moment the reaper sees
            # the dead worker, so nothing is lost; don't retry inline
            pass

    def _admit(self, budget: Optional[float],
               qcls: QoSClass) -> Optional[float]:
        """Fleet-wide admission: depth is the ledger's open count (every
        unresolved ticket anywhere in the fleet), thresholds scaled by
        the request's QoS class — batch work degrades and sheds first."""
        p = self.policy
        if p.degrade_pending is None and p.shed_pending is None:
            return budget
        depth = self.ledger.open_count()
        if (p.shed_pending is not None
                and depth >= p.shed_pending * qcls.shed_factor):
            with self._lock:
                self._shed += 1
                self._shed_by_qos[qcls.name] += 1
            raise Overloaded(
                f"fleet overloaded: {depth} tickets open (shed threshold "
                f"{p.shed_pending * qcls.shed_factor:g} for QoS "
                f"{qcls.name!r}); retry with backoff")
        degrade_at = (p.degrade_pending * qcls.degrade_factor
                      if p.degrade_pending is not None else None)
        if degrade_at is not None and depth >= degrade_at:
            level = 1 + int((depth - degrade_at) // degrade_at)
            degraded = degrade_budget(budget, level)
            if degraded != (budget if budget is not None else 1.0):
                with self._lock:
                    self._degraded_admissions += 1
                return degraded
        return budget

    # -- reaper ------------------------------------------------------------
    def _reap_loop(self) -> None:
        while not self._stop_evt.wait(self.reaper_interval_s):
            with self._lock:
                if not self._running:
                    return
            self.reap_once()

    def reap_once(self) -> int:
        """One reclaim pass (the reaper thread's body; callable directly
        by tests for deterministic stepping). Detects dead workers, takes
        back their items plus expired leases and router orphans, and
        re-routes each to a live worker. Returns the number reclaimed."""
        # belt-and-braces heartbeat: a worker whose batcher thread died
        # without marking itself (a bug, not a modeled crash) is dead too
        for worker_id in self.members.live():
            w = self._workers.get(worker_id)
            if w is not None and w._thread is not None \
                    and not w._thread.is_alive():
                self._note_worker_crash(worker_id)
        reclaimed = self.ledger.reclaim(self.members.dead(),
                                        self.orphan_after_s,
                                        stuck_after_s=self.lease_s)
        for _reason, req in reclaimed:
            self._route(req)
        return len(reclaimed)

    # -- delivery / cache --------------------------------------------------
    def _note_resolved(self, latency_s: Optional[float]) -> None:
        with self._lock:
            if latency_s is None:
                self._errors += 1
            else:
                self._completed += 1
                self._latencies.append(latency_s)

    def _cache_key(self, problem: Problem) -> str:
        return result_cache_key(self.solver_name, self.runs, self.seed,
                                self._config_digest, problem)

    def _cache_lookup(self, req: _FleetRequest) -> Optional[ServeResult]:
        if not self._cache_enabled:
            return None
        key = self._cache_key(req.problem)
        with self._lock:
            entry = self._cache.get(key)
        if entry is None:
            return None
        have = entry.get("budget") or 1.0
        want = req.budget if req.budget is not None else 1.0
        if have < want - 1e-9:
            return None
        energies = np.asarray(entry.get("energies", ()), dtype=np.float64)
        sigma = np.asarray(entry.get("sigma", ()), dtype=np.int8)
        if self.policy.validate and not validate_row(
                req.problem, energies, sigma,
                self.policy.validate_atol, self.policy.validate_rtol):
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

    def _shared_cache_put(self, req: _FleetRequest, res: ServeResult) -> None:
        if not self._cache_enabled:
            return
        key = self._cache_key(req.problem)
        new = {"budget": res.budget,
               "energies": [float(e) for e in res.energies],
               "sigma": [int(s) for s in res.sigma],
               "n": req.problem.n}
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
            store_sharded_json_cache(self._cache_path, cache,
                                     resolve=_higher_effort, drop=drop)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """Fleet-aggregate counters plus each worker's full per-worker
        ledger (the same ``IsingService.stats()`` schema, including its
        resilience/breaker counters), plus the work ledger's ownership
        accounting — ``lost`` is the invariant the chaos gate holds at 0."""
        per_worker = {wid: w.stats() for wid, w in self._workers.items()}
        ledger = self.ledger.stats()
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
            elapsed = (time.monotonic() - self._started_at
                       if self._started_at else 0.0)
            fleet = {
                "workers_live": len(self.members.live()),
                "workers_dead": len(self.members.dead()),
                "worker_crashes": self._worker_crashes,
                "submitted": self._submitted,
                "completed": self._completed,
                "errors": self._errors,
                "cache_hits": self._cache_hits,
                "cache_hit_rate": (self._cache_hits / self._submitted
                                   if self._submitted else 0.0),
                "cache_quarantined": self._cache_quarantined,
                "shed": self._shed,
                "shed_by_qos": dict(self._shed_by_qos),
                "degraded_admissions": self._degraded_admissions,
                "router_drops": self._router_drops,
                "flushes": sum(w["flushes"] for w in per_worker.values()),
                "dispatches": sum(w["dispatches"]
                                  for w in per_worker.values()),
                "p50_latency_s": (float(np.percentile(lat, 50))
                                  if lat.size else 0.0),
                "p95_latency_s": (float(np.percentile(lat, 95))
                                  if lat.size else 0.0),
                "elapsed_s": elapsed,
                "problems_per_s": (self._completed / elapsed
                                   if elapsed > 0 else 0.0),
                # every admitted submit must end up completed, errored, or
                # still open in the ledger; anything else fell through a
                # crack — the chaos gate holds this at exactly 0
                "lost": (self._submitted - self._completed - self._errors
                         - ledger["open"]),
            }
        fleet["ledger"] = ledger
        fleet["faults"] = self._injector.stats()
        return {"fleet": fleet, "workers": per_worker}
