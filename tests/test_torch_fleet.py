"""repro_torch.serve.fleet — the mirror of ``tests/test_fleet.py`` on the
CPU: multi-worker serving, routing, work-ownership ledger, crash reclaim,
QoS, elastic membership, sharded stores. Every fleet and service here runs
with ``torch_device="cpu"``."""
import functools
import json
import multiprocessing
import os
import threading
import time
from types import MappingProxyType

import numpy as np
import pytest

from repro_torch.api.suite import ProblemSuite
from repro_torch.distributed.elastic import WorkerSet, rendezvous_route
import repro_torch.serve as tserve
from repro_torch.serve import (FaultPlan, IsingFleet, Overloaded,
                               ResiliencePolicy, resolve_qos, validate_row)
from repro_torch.serve.fleet import WorkLedger, _FleetRequest
from repro_torch.serve.service import batch_key
from repro_torch.utils import (load_sharded_json_cache, shard_of,
                               store_sharded_json_cache)

SIZES = [10, 12, 14, 18, 20, 22]


def _problems(count=18, seed=0):
    return [ProblemSuite.random(SIZES[i % len(SIZES)], 0.5, 1,
                                seed=seed + i)[0]
            for i in range(count)]


FLEET_KW = dict(solver="sa-numpy", runs=2, seed=0, block=4,
                max_batch=64, max_wait_s=0.25, cache=False, n_sweeps=20,
                torch_device="cpu")
IsingService = functools.partial(tserve.IsingService, torch_device="cpu")


def _run_fleet(problems, workers=4, fault_plan=None, **over):
    kw = dict(FLEET_KW, **over)
    with IsingFleet(workers=workers, fault_plan=fault_plan, **kw) as fleet:
        tickets = [fleet.submit(p, budget=1.0) for p in problems]
        results = [t.result(timeout=60) for t in tickets]
        stats = fleet.stats()
    return results, stats


# -- routing / membership ----------------------------------------------------

def test_rendezvous_route_moves_only_departed_keys():
    keys = [repr((pad, tier)) for pad in (12, 16, 20, 24, 64)
            for tier in (-1, 0, 1)]
    members = ["w0", "w1", "w2", "w3"]
    before = {k: rendezvous_route(k, members) for k in keys}
    # member order must not matter (every router replica agrees)
    assert before == {k: rendezvous_route(k, list(reversed(members)))
                      for k in keys}
    after = {k: rendezvous_route(k, [m for m in members if m != "w1"])
             for k in keys}
    for k in keys:
        if before[k] != "w1":
            assert after[k] == before[k]     # survivors keep their keys
        else:
            assert after[k] != "w1"


def test_worker_set_membership_and_death():
    ws = WorkerSet()
    ws.join("w0"); ws.join("w1")
    assert ws.live() == ["w0", "w1"] and ws.version == 2
    ws.mark_dead("w0")
    assert ws.live() == ["w1"] and ws.dead() == ["w0"]
    ws.leave("w1")
    assert ws.live() == [] and ws.dead() == ["w0"]
    ws.join("w0")                            # a dead id can rejoin (restart)
    assert ws.live() == ["w0"] and ws.dead() == []


# -- work ledger -------------------------------------------------------------

def _dummy_req():
    return _FleetRequest(problem=None, budget=1.0, deadline_s=None,
                         submitted=time.monotonic(), ticket=None)


def test_ledger_epoch_rejects_stale_resolution():
    led = WorkLedger()
    i = led.register(_dummy_req())
    epochs = led.lease([i], "w0", duration_s=30.0)
    # reclaim mid-solve (as if w0's lease expired / w0 died): epoch bumps
    led.reclaim(["w0"], orphan_after_s=99.0)
    assert not led.resolve(i, epochs[i])     # w0's late answer: discarded
    assert led.stale_resolves == 1
    e2 = led.lease([i], "w1", duration_s=30.0)
    assert led.resolve(i, e2[i])             # the new owner's answer lands
    assert not led.resolve(i, e2[i])         # exactly-once: replays bounce
    s = led.stats()
    assert s["resolved_ok"] == 1 and s["open"] == 0
    assert s["stale_resolves"] == 2


def test_ledger_reclaims_expired_lease_and_orphans():
    led = WorkLedger()
    a = led.register(_dummy_req())           # leased with duration 0
    b = led.register(_dummy_req())           # never assigned (router drop)
    led.lease([a], "w0", duration_s=0.0)
    out = led.reclaim([], orphan_after_s=0.0)
    reasons = sorted(r for r, _ in out)
    assert reasons == ["lease_expired", "router_drop"]
    assert led.reclaims_by_reason == {"lease_expired": 1, "router_drop": 1}


# -- fleet solve paths -------------------------------------------------------

def test_fleet_matches_single_service_bit_identical():
    probs = _problems()
    single_kw = {k: v for k, v in FLEET_KW.items() if k != "cache"}
    with IsingService(cache=False, **single_kw) as svc:
        base = [t.result(timeout=60)
                for t in [svc.submit(p, budget=1.0) for p in probs]]
    fleet_res, stats = _run_fleet(probs, workers=3)
    for b, f in zip(base, fleet_res):
        np.testing.assert_array_equal(b.energies, f.energies)
        np.testing.assert_array_equal(b.sigma, f.sigma)
    f = stats["fleet"]
    assert f["lost"] == 0 and f["ledger"]["open"] == 0
    # routing kept coalescing: total flushes == number of distinct keys,
    # exactly what the single service would have dispatched
    keys = {batch_key(p, 1.0, FLEET_KW["block"]) for p in probs}
    assert f["flushes"] == len(keys)
    # every worker holds the per-worker invariant: dispatches <= flushes
    for w in stats["workers"].values():
        assert w["dispatches"] <= w["flushes"]


def test_worker_crash_mid_flush_reclaimed_bit_identical():
    """The fleet chaos contract: kill 1 of 4 workers on its first flush —
    zero lost tickets, every reclaimed ticket re-resolves via a survivor,
    untouched rows bit-identical to the fault-free run, and no ticket
    resolves twice."""
    probs = _problems(24)
    base, base_stats = _run_fleet(probs, workers=4)
    plan = FaultPlan(seed=0, schedule=MappingProxyType(
        {("worker:w1", 0): "worker_crash"}))
    chaos, stats = _run_fleet(probs, workers=4, fault_plan=plan)

    f = stats["fleet"]
    assert f["worker_crashes"] == 1
    assert f["lost"] == 0 and f["errors"] == 0
    assert f["ledger"]["open"] == 0
    assert f["ledger"]["reclaimed"] >= 1     # the dead worker's tickets
    assert f["ledger"]["reclaims_by_reason"].get("worker_dead", 0) >= 1
    # exactly-once: ok-resolutions == tickets, nothing double-counted
    assert f["ledger"]["resolved_ok"] == len(probs)

    members = ["w0", "w1", "w2", "w3"]
    touched = {p.content_hash for p in probs
               if rendezvous_route(repr(batch_key(p, 1.0, FLEET_KW["block"])),
                                   members) == "w1"}
    assert touched                            # w1 owned some keys
    for p, b, c in zip(probs, base, chaos):
        if p.content_hash in touched:
            # reclaimed rows re-solved by a survivor, float64-revalidated
            assert validate_row(p, c.energies, c.sigma)
        else:
            np.testing.assert_array_equal(b.energies, c.energies)
            np.testing.assert_array_equal(b.sigma, c.sigma)


class _GateSolver:
    """Solver wrapper that parks the first dispatch on an event — lets the
    test hold a worker provably mid-solve while the reaper reclaims its
    expired lease, with no timing assumptions."""

    def __init__(self, inner, gate, entered):
        self.inner = inner
        self.gate, self.entered = gate, entered

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def solve(self, suite, **kw):
        self.entered.set()
        assert self.gate.wait(timeout=30)
        return self.inner.solve(suite, **kw)


def test_lease_expiry_mid_solve_discards_stale_resolution():
    """An injected lease_expiry leases the flush with duration 0: the
    reaper reclaims and re-dispatches while the original worker is still
    solving, and the ledger discards the original (stale-epoch)
    resolution — the ticket resolves exactly once."""
    # one batch key (same n, same budget) so all tickets ride one flush
    probs = [ProblemSuite.random(12, 0.5, 1, seed=100 + i)[0]
             for i in range(4)]
    target = rendezvous_route(repr(batch_key(probs[0], 1.0,
                                             FLEET_KW["block"])),
                              ["w0", "w1"])
    plan = FaultPlan(seed=0, schedule=MappingProxyType(
        {(f"worker:{target}", 0): "lease_expiry"}))
    fleet = IsingFleet(workers=2, fault_plan=plan,
                       reaper_interval_s=3600.0,   # reaper stepped manually
                       lease_s=10.0, **FLEET_KW)
    with fleet:
        gate, entered = threading.Event(), threading.Event()
        w = fleet._workers[target]
        w._solver = _GateSolver(w._solver, gate, entered)
        tickets = [fleet.submit(p, budget=1.0) for p in probs]
        assert entered.wait(timeout=10)  # target holds the 0s lease, parked
        assert fleet.reap_once() == len(probs)  # expired -> reclaim + bump
        gate.set()                            # original flush now finishes...
        res = [t.result(timeout=60) for t in tickets]
        fleet.join()
        stats = fleet.stats()
    f = stats["fleet"]
    assert f["lost"] == 0 and f["ledger"]["open"] == 0
    assert f["ledger"]["resolved_ok"] == len(probs)   # exactly once each
    assert f["ledger"]["reclaims_by_reason"] == {"lease_expired": len(probs)}
    # ...and every original resolution was discarded as stale
    assert f["ledger"]["stale_resolves"] >= len(probs)
    for p, r in zip(probs, res):
        assert validate_row(p, r.energies, r.sigma)


def test_router_drop_rescued_by_reaper():
    probs = _problems(6)
    plan = FaultPlan(seed=0, schedule=MappingProxyType(
        {("router", 0): "router_drop", ("router", 3): "router_drop"}))
    res, stats = _run_fleet(probs, workers=2, fault_plan=plan,
                            orphan_after_s=0.02, reaper_interval_s=0.01)
    f = stats["fleet"]
    assert f["router_drops"] == 2
    assert f["ledger"]["reclaims_by_reason"].get("router_drop", 0) == 2
    assert f["lost"] == 0 and f["ledger"]["resolved_ok"] == len(probs)
    for p, r in zip(probs, res):
        assert validate_row(p, r.energies, r.sigma)


def test_elastic_join_leave_loses_nothing():
    probs = _problems(18)
    with IsingFleet(workers=1, **FLEET_KW) as fleet:
        t1 = [fleet.submit(p, budget=1.0) for p in probs[:6]]
        fleet.add_worker()                    # scale out
        t2 = [fleet.submit(p, budget=1.0) for p in probs[6:12]]
        [t.result(timeout=60) for t in t1 + t2]
        fleet.remove_worker("w0")             # graceful drain + leave
        t3 = [fleet.submit(p, budget=1.0) for p in probs[12:]]
        res = [t.result(timeout=60) for t in t3]
        stats = fleet.stats()
    f = stats["fleet"]
    assert f["workers_live"] == 1 and f["workers_dead"] == 0
    assert f["lost"] == 0 and f["ledger"]["open"] == 0
    # graceful departure reclaims nothing — the drain resolved its queue
    assert f["ledger"]["reclaims_by_reason"].get("worker_dead", 0) == 0
    for p, r in zip(probs[12:], res):
        assert validate_row(p, r.energies, r.sigma)


def test_fleet_shared_cache_hits_and_persists(tmp_path):
    path = str(tmp_path / "fleet_cache.json")
    p = _problems(1)[0]
    kw = dict(FLEET_KW, cache=True)
    with IsingFleet(workers=2, cache_path=path, **kw) as fleet:
        r1 = fleet.submit(p, budget=1.0).result(timeout=60)
        r2 = fleet.submit(p, budget=1.0).result(timeout=60)
        assert not r1.cached and r2.cached
        np.testing.assert_array_equal(r1.energies, r2.energies)
    assert (tmp_path / "fleet_cache.shards").is_dir()
    # a fresh fleet reloads the sharded store and serves from cache
    with IsingFleet(workers=2, cache_path=path, **kw) as fleet:
        r3 = fleet.submit(p, budget=1.0).result(timeout=60)
        assert r3.cached
        assert fleet.stats()["fleet"]["flushes"] == 0


# -- QoS ---------------------------------------------------------------------

def test_qos_sheds_batch_before_interactive():
    """At a queue depth that sheds batch work, normal and interactive
    requests still admit (batch shed threshold is scaled DOWN, interactive
    UP) — strict priority ordering from one shared ladder."""
    svc = IsingService(solver="sa-numpy", runs=2, n_sweeps=10,
                       resilience=ResiliencePolicy(degrade_pending=None,
                                                   shed_pending=8))
    # stuff the queue synthetically: depth 6 is >= 8*0.5 (batch) but
    # < 8 (normal) and < 16 (interactive)
    svc._pending[("k",)] = [object()] * 6
    with pytest.raises(Overloaded):
        svc._admit(1.0, resolve_qos("batch"))
    assert svc._admit(1.0, resolve_qos("normal")) == 1.0
    assert svc._admit(1.0, resolve_qos("interactive")) == 1.0
    assert svc.stats()["shed_by_qos"] == {"batch": 1}


def test_qos_degrades_batch_first():
    svc = IsingService(solver="sa-numpy", runs=2, n_sweeps=10,
                       resilience=ResiliencePolicy(degrade_pending=8,
                                                   shed_pending=None))
    svc._pending[("k",)] = [object()] * 6
    assert svc._admit(1.0, resolve_qos("batch")) == 0.5    # one rung down
    assert svc._admit(1.0, resolve_qos("normal")) == 1.0   # untouched
    assert svc._admit(1.0, resolve_qos("interactive")) == 1.0


def test_fleet_qos_shed_uses_ledger_depth():
    probs = _problems(4)
    with IsingFleet(workers=1,
                    resilience=ResiliencePolicy(shed_pending=4),
                    **FLEET_KW) as fleet:
        for p in probs:                       # fill the ledger to depth 4
            fleet.submit(p, budget=1.0)
        with pytest.raises(Overloaded):
            fleet.submit(probs[0], budget=1.0, qos="batch")
        fleet.join(timeout_s=60)
    assert fleet.stats()["fleet"]["shed_by_qos"] == {"batch": 1}


# -- sharded stores ----------------------------------------------------------

def test_shard_of_uses_trailing_hash_nibble():
    h = "be" + "0" * 38
    assert shard_of(h) == 0xb
    assert shard_of(f"engine:64:0:abc123:{h}") == 0xb
    # all 16 shards reachable, deterministic
    assert {shard_of(f"{x}{'0' * 39}") for x in "0123456789abcdef"} \
        == set(range(16))
    assert shard_of("autotune-key") == shard_of("autotune-key")


def test_sharded_store_roundtrip_resolve_and_drop(tmp_path):
    path = str(tmp_path / "cache.json")
    keys = [f"{x}{'f' * 39}" for x in "0123456789abcdef"]
    store_sharded_json_cache(path, {k: {"v": 1} for k in keys})
    assert len(list((tmp_path / "cache.shards").glob("shard-*.json"))) == 16
    assert load_sharded_json_cache(path) == {k: {"v": 1} for k in keys}
    # per-key resolve works across shards
    store_sharded_json_cache(
        path, {keys[0]: {"v": 0}, keys[5]: {"v": 9}},
        resolve=lambda old, new: max(old, new, key=lambda d: d["v"]))
    got = load_sharded_json_cache(path)
    assert got[keys[0]]["v"] == 1 and got[keys[5]]["v"] == 9
    # drop quarantines per shard: dropped keys do not resurrect on merge
    store_sharded_json_cache(path, {}, drop=[keys[3], keys[7]])
    got = load_sharded_json_cache(path)
    assert keys[3] not in got and keys[7] not in got
    assert len(got) == 14


def test_monolith_migrates_once_and_shards_win_conflicts(tmp_path):
    path = str(tmp_path / "oracle.json")
    k_old = "a" + "0" * 39
    k_both = "b" + "0" * 39
    # a sharded writer already ran (its entries are newer by construction)
    store_sharded_json_cache(path, {k_both: {"v": "shard"}})
    with open(path, "w") as f:
        json.dump({k_old: {"v": "mono"}, k_both: {"v": "mono"}}, f)
    got = load_sharded_json_cache(path)
    assert got[k_old] == {"v": "mono"}        # monolith entries carried over
    assert got[k_both] == {"v": "shard"}      # existing shard entry wins
    assert not os.path.exists(path)
    assert os.path.exists(path + ".migrated")
    # second load: no monolith left, nothing re-migrates
    assert load_sharded_json_cache(path) == got


def _stress_writer(path, writer_id, n_keys):
    entries = {f"{x}{writer_id:02d}{i:02d}{'e' * 35}": {"writer": writer_id,
                                                        "i": i}
               for i, x in enumerate("0123456789abcdef" * (n_keys // 16))}
    # many small conflicting stores from each process
    for chunk_start in range(0, n_keys, 8):
        chunk = dict(list(entries.items())[chunk_start:chunk_start + 8])
        store_sharded_json_cache(path, chunk)


def test_sharded_store_concurrent_multiprocess_writers(tmp_path):
    """N processes hammering the sharded store concurrently: the union of
    every writer's entries survives — nothing lost to clobbering, nothing
    resurrected after a drop."""
    path = str(tmp_path / "stress.json")
    n_writers, n_keys = 4, 32
    ctx = multiprocessing.get_context("fork")
    procs = [ctx.Process(target=_stress_writer, args=(path, w, n_keys))
             for w in range(n_writers)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    got = load_sharded_json_cache(path)
    assert len(got) == n_writers * n_keys     # zero lost entries
    for w in range(n_writers):
        mine = {k: v for k, v in got.items() if v["writer"] == w}
        assert len(mine) == n_keys
    # quarantine drop after concurrent writes: per-shard, permanent
    victim = sorted(got)[0]
    store_sharded_json_cache(path, {}, drop=[victim])
    assert victim not in load_sharded_json_cache(path)


def test_service_opts_into_sharded_cache(tmp_path):
    path = str(tmp_path / "svc_cache.json")
    p = _problems(1)[0]
    kw = dict(solver="sa-numpy", runs=2, seed=0, block=4, n_sweeps=20)
    with IsingService(cache_path=path, cache_shards=True, **kw) as svc:
        r1 = svc.submit(p, budget=1.0).result(timeout=60)
    assert (tmp_path / "svc_cache.shards").is_dir()
    assert not os.path.exists(path)
    with IsingService(cache_path=path, cache_shards=True, **kw) as svc:
        r2 = svc.submit(p, budget=1.0).result(timeout=60)
    assert r2.cached and not r1.cached
    np.testing.assert_array_equal(r1.energies, r2.energies)
