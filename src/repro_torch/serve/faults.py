"""``repro_torch.serve.faults`` — deterministic fault injection for the serve tier.

Chaos testing is only useful if a failing run can be replayed: a fault
schedule here is a pure function of its seed, precomputed as a mapping
``(site, call_index) -> fault kind``. The service's flush worker is a
single thread dispatching flushes sequentially, so call indices — and
therefore the whole chaos run — are reproducible bit-for-bit. Two
injection sites cover the failure surface:

* ``"solve"`` — every solver dispatch, via :class:`FaultySolver`, a
  :class:`~repro_torch.api.registry.SolverWrapper` that consults the plan
  before delegating. Kinds: ``flush_error`` (dispatch raises),
  ``worker_crash`` (raises a :class:`SolverCrash` — breaker trips
  immediately), ``straggler_delay`` (sleeps past the watchdog, then
  answers normally — exercises hedging), ``nan_energy`` (answers with one
  problem's energies corrupted — exercises the validation guardrail).

* ``"cache"`` — every result-cache store, via
  :func:`corrupt_cache_entry`. Kind: ``corrupt_cache_write`` (the stored
  entry's payload is garbled — exercises cache-hit validation and
  quarantine).

The injected counters (:attr:`FaultInjector.injected`) let a chaos
harness assert the schedule actually fired, not just that nothing broke.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time
from types import MappingProxyType
from typing import Mapping, Optional

import numpy as np

from ..api.registry import SolverWrapper
from .resilience import SolverCrash

FAULT_KINDS = ("flush_error", "straggler_delay", "nan_energy",
               "corrupt_cache_write", "worker_crash")
_SOLVE_KINDS = ("flush_error", "straggler_delay", "nan_energy",
                "worker_crash")
FAULT_SITES = ("solve", "cache")

# Fleet-level kinds fire at worker-namespaced sites ("worker:<id>", drawn
# once per flush a worker dispatches) and the router site ("router", drawn
# once per ticket registration). At a worker site, ``worker_crash`` now
# means the PROCESS: the worker dies mid-flush without releasing its
# leases, and a survivor must reclaim them. ``lease_expiry`` forces that
# flush's lease to expire immediately (the reaper reclaims it while the
# original worker is still solving — its late resolve must be discarded
# as stale). ``router_drop`` loses a ticket between ledger registration
# and worker enqueue (the reaper finds the orphaned lease and re-routes).
FLEET_FAULT_KINDS = ("worker_crash", "lease_expiry", "router_drop")
_WORKER_KINDS = ("worker_crash", "lease_expiry")


class InjectedFault(RuntimeError):
    """A scheduled ``flush_error`` — transient, retryable."""


class InjectedWorkerCrash(SolverCrash):
    """A scheduled ``worker_crash`` — the solver backend 'died'; typed as
    :class:`SolverCrash` so the supervision layer trips the breaker."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative fault schedule.

    ``schedule`` maps ``(site, call_index)`` to a fault kind; calls not in
    the mapping pass through clean. Built via :meth:`from_rates` — never
    by sampling at injection time, so the same plan replays identically.
    """
    seed: int
    schedule: Mapping  # (site, idx) -> kind
    straggler_delay_s: float = 0.6

    @classmethod
    def from_rates(cls, seed: int = 0, rate: float = 0.1,
                   horizon: int = 10_000,
                   kinds=FAULT_KINDS,
                   straggler_delay_s: float = 0.6) -> "FaultPlan":
        """Precompute a schedule where each call at each site draws a
        fault with probability ``rate``, kind uniform over the ``kinds``
        applicable to that site. ``horizon`` bounds the precomputed call
        range; calls beyond it are clean (pick it >> the expected flush
        count of the run)."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        unknown = set(kinds) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds: {sorted(unknown)}")
        solve_kinds = [k for k in kinds if k in _SOLVE_KINDS]
        cache_kinds = [k for k in kinds if k == "corrupt_cache_write"]
        rng = random.Random(seed)
        schedule: dict = {}
        for site, site_kinds in (("solve", solve_kinds),
                                 ("cache", cache_kinds)):
            for idx in range(horizon):
                # draw unconditionally so each site's stream is independent
                # of which kinds are enabled at the other site
                u, pick = rng.random(), rng.random()
                if site_kinds and u < rate:
                    schedule[(site, idx)] = site_kinds[
                        int(pick * len(site_kinds)) % len(site_kinds)]
        return cls(seed=seed, schedule=MappingProxyType(schedule),
                   straggler_delay_s=straggler_delay_s)

    @classmethod
    def for_fleet(cls, seed: int = 0, rate: float = 0.05,
                  n_workers: int = 4, horizon: int = 1_000,
                  kinds=FLEET_FAULT_KINDS,
                  straggler_delay_s: float = 0.6) -> "FaultPlan":
        """Precompute a fleet-level schedule over worker-namespaced sites.

        Each worker site ``worker:<i>`` draws per flush it dispatches;
        the ``router`` site draws per ticket registration. Same replay
        contract as :meth:`from_rates`: the schedule is a pure function
        of the seed, so a chaos run that kills worker 2 on its 3rd flush
        kills worker 2 on its 3rd flush every time.
        """
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        unknown = set(kinds) - set(FLEET_FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fleet fault kinds: {sorted(unknown)}")
        worker_kinds = [k for k in kinds if k in _WORKER_KINDS]
        router_kinds = [k for k in kinds if k == "router_drop"]
        rng = random.Random(seed)
        schedule: dict = {}
        # site names match IsingFleet's worker ids ("w0", "w1", ...)
        sites = [(f"worker:w{i}", worker_kinds) for i in range(n_workers)]
        sites.append(("router", router_kinds))
        for site, site_kinds in sites:
            for idx in range(horizon):
                u, pick = rng.random(), rng.random()
                if site_kinds and u < rate:
                    schedule[(site, idx)] = site_kinds[
                        int(pick * len(site_kinds)) % len(site_kinds)]
        return cls(seed=seed, schedule=MappingProxyType(schedule),
                   straggler_delay_s=straggler_delay_s)

    def counts(self) -> dict:
        """Scheduled fault totals by kind (what a full run would inject)."""
        c: collections.Counter = collections.Counter(self.schedule.values())
        return dict(c)


class FaultInjector:
    """Runtime side of a :class:`FaultPlan`: per-site call counters plus a
    ledger of what actually fired. Thread-safe; a ``None`` plan is a
    permanent no-op (the service wires an injector unconditionally and
    pays one ``None`` check per call)."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan
        self._lock = threading.Lock()
        self._calls: collections.Counter = collections.Counter()
        self.injected: collections.Counter = collections.Counter()

    def draw(self, site: str) -> Optional[str]:
        """Advance ``site``'s call counter; return the scheduled fault kind
        for this call (or None). Exactly one draw per supervised call —
        retries and hedges draw again, so a retried dispatch can hit a
        fresh fault (or pass clean) per the schedule, deterministically."""
        if self.plan is None:
            return None
        with self._lock:
            idx = self._calls[site]
            self._calls[site] += 1
            kind = self.plan.schedule.get((site, idx))
            if kind is not None:
                self.injected[kind] += 1
            return kind

    def stats(self) -> dict:
        with self._lock:
            return {"calls": dict(self._calls),
                    "injected": dict(self.injected)}


class FaultySolver(SolverWrapper):
    """Registry wrapper injecting the plan's ``"solve"``-site faults."""

    def __init__(self, inner, injector: FaultInjector):
        super().__init__(inner)
        self.injector = injector

    def solve(self, suite, runs=64, seed=0, budget=None, block=64):
        kind = self.injector.draw("solve")
        if kind == "flush_error":
            raise InjectedFault("injected flush error")
        if kind == "worker_crash":
            raise InjectedWorkerCrash("injected worker crash")
        if kind == "straggler_delay":
            delay = (self.injector.plan.straggler_delay_s
                     if self.injector.plan else 0.0)
            time.sleep(delay)
        rep = self.inner.solve(suite, runs=runs, seed=seed, budget=budget,
                               block=block)
        if kind == "nan_energy":
            # corrupt ONE problem's energies in a copied column — never
            # in-place, the inner report's arrays may be cached elsewhere.
            # Alternate NaN / plausible-garbage so the guardrail is tested
            # against both non-finite and finite-but-wrong corruption.
            count = self.injector.injected["nan_energy"]
            p = count % rep.num_problems
            bad = np.array(rep.energies[p], dtype=np.float64, copy=True)
            if count % 2:
                bad[0] = -1e30
            else:
                bad[0] = np.nan
            rep.energies = list(rep.energies)
            rep.energies[p] = bad
            rep.meta = dict(rep.meta, injected_nan_problem=p)
        return rep


def corrupt_cache_entry(entry: dict, count: int) -> dict:
    """The ``"cache"`` site's corruption: return a garbled copy of a
    result-cache entry (the original is never mutated). Rotates through
    the corruption shapes a real store can produce — a non-finite energy,
    a wrong-length truncated payload, and a zeroed (non-±1) spin vector —
    all of which cache-hit validation must catch."""
    bad = {k: (list(v) if isinstance(v, list) else v)
           for k, v in entry.items()}
    mode = count % 3
    if mode == 0 and bad.get("energies"):
        bad["energies"][0] = float("nan")
    elif mode == 1 and bad.get("sigma"):
        bad["sigma"] = bad["sigma"][:-1]           # truncated write
    elif bad.get("sigma"):
        bad["sigma"] = [0] * len(bad["sigma"])     # zeroed page
    return bad
