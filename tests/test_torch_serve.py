"""repro_torch.serve — the mirror of ``tests/test_serve.py`` on the CPU:
service-vs-offline parity, admission policies, result cache, merge-on-store
caches, streamed-report merge. Every service and solver here runs with
``torch_device="cpu"``. (The reference's ``launch.serve`` shim for the LM
is not ported yet: it goes with the LM scaffolding.)"""
import functools
import json
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.api as tapi
import repro_torch.serve as tserve
from repro_torch.api import Problem, ProblemSuite, deadline_to_budget
from repro_torch.utils import (load_json_cache, load_sharded_json_cache,
                         store_json_cache)

RUNS = 4
SEED = 3

CPU = {"torch_device": "cpu"}
IsingService = functools.partial(tserve.IsingService, **CPU)
get_solver = functools.partial(tapi.get_solver, **CPU)
solve_suite = functools.partial(tapi.solve_suite, **CPU)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_problems():
    return [Problem.random_qubo(n, 0.5, seed=10 + i)
            for i, n in enumerate((16, 32, 64, 24))]


# -- service vs offline parity ----------------------------------------------

def test_service_matches_offline_suite_exactly():
    """Same seeds, same coalesced bucket -> bit-identical energies/spins:
    the streaming path is the offline hot path, not a reimplementation."""
    probs = _mixed_problems()
    offline = solve_suite(ProblemSuite(probs), "sa-jax", runs=RUNS,
                          seed=SEED, oracle=False)
    with IsingService(solver="sa-jax", runs=RUNS, seed=SEED, cache=False,
                      max_batch=len(probs), max_wait_s=5.0) as svc:
        results = [t.result(timeout=300) for t in svc.submit_many(probs)]
        stats = svc.stats()
        rep = svc.report()
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res.energies, offline.energies[i])
        np.testing.assert_array_equal(res.sigma, offline.best_sigma[i])
    # all four pad to one 64-spin bucket: one flush, ONE device dispatch
    assert stats["flushes"] == 1 and stats["dispatches"] == 1
    assert results[0].batch_size == len(probs)
    # the streamed report carries the same schema as the offline one
    assert rep.problem_hashes == offline.problem_hashes
    np.testing.assert_array_equal(rep.best_energy, offline.best_energy)


def test_max_batch_admission_splits_flushes():
    probs = [Problem.random_qubo(12, 0.5, seed=50 + i) for i in range(4)]
    with IsingService(solver="sa-jax", runs=RUNS, seed=SEED, cache=False,
                      block=16, max_batch=2, max_wait_s=5.0) as svc:
        for t in svc.submit_many(probs):
            t.result(timeout=300)
        stats = svc.stats()
    assert stats["flushes"] == 2                 # 4 requests / max_batch 2
    assert stats["dispatches"] == 2              # one dispatch per flush
    assert stats["mean_batch"] == 2.0


# -- result cache ------------------------------------------------------------

def test_repeated_problem_served_from_cache_without_dispatch():
    p = Problem.random_qubo(14, 0.5, seed=77)
    with IsingService(solver="sa-jax", runs=RUNS, seed=SEED, block=16,
                      max_batch=1, max_wait_s=0.0) as svc:
        first = svc.submit(p).result(timeout=300)
        second = svc.submit(p).result(timeout=300)
        stats = svc.stats()
    assert not first.cached and second.cached
    assert second.batch_size == 0                # no dispatch behind it
    np.testing.assert_array_equal(first.energies, second.energies)
    assert stats["dispatches"] == 1 and stats["cache_hits"] == 1
    assert stats["cache_hit_rate"] == pytest.approx(0.5)


def test_cache_entry_only_serves_requests_at_or_below_its_effort():
    p = Problem.random_qubo(14, 0.5, seed=78)
    with IsingService(solver="sa-jax", runs=RUNS, seed=SEED, block=16,
                      max_batch=1, max_wait_s=0.0) as svc:
        svc.submit(p, budget=0.25).result(timeout=300)   # low-effort entry
        more = svc.submit(p, budget=2.0).result(timeout=300)
        again = svc.submit(p, budget=0.5).result(timeout=300)
    assert not more.cached            # cached 0.25-effort can't serve 2.0
    assert again.cached               # but the 2.0 entry serves 0.5
    assert again.budget == 2.0


def test_result_cache_persists_and_reloads(tmp_path):
    path = str(tmp_path / "serve_cache.json")
    p = Problem.random_qubo(13, 0.5, seed=79)
    with IsingService(solver="sa-jax", runs=RUNS, seed=SEED, block=16,
                      max_batch=1, max_wait_s=0.0, cache_path=path) as svc:
        first = svc.submit(p).result(timeout=300)
    entries = json.load(open(path))
    assert len(entries) == 1

    svc2 = IsingService(solver="sa-jax", runs=RUNS, seed=SEED, block=16,
                        cache_path=path)

    def boom(*a, **k):
        raise AssertionError("cached problem dispatched after reload")
    svc2._solver.solve = boom
    with svc2:
        res = svc2.submit(p).result(timeout=60)
    assert res.cached
    np.testing.assert_array_equal(res.energies, first.energies)


# -- deadlines ---------------------------------------------------------------

def test_deadline_to_budget_mapping():
    assert deadline_to_budget(None) is None
    assert deadline_to_budget(1.0) == 1.0        # reference deadline
    assert deadline_to_budget(0.5) == 0.5        # linear in allowed time
    assert deadline_to_budget(1e-6) == 0.125     # clamped floor
    assert deadline_to_budget(1e6) == 8.0        # clamped ceiling
    assert deadline_to_budget(2.0, reference_s=4.0) == 0.5
    with pytest.raises(ValueError, match="positive"):
        deadline_to_budget(-1.0)
    with pytest.raises(ValueError, match="positive"):
        deadline_to_budget(1.0, reference_s=0.0)


def test_solver_for_deadline_routing_and_auto():
    from repro_torch.api import list_solvers
    from repro_torch.serve import DEFAULT_FALLBACK_CHAIN, solver_for_deadline

    # every rung of the recommended chain is a registered solver
    registered = set(list_solvers())
    assert set(DEFAULT_FALLBACK_CHAIN) <= registered
    assert DEFAULT_FALLBACK_CHAIN[0] == "sb-jax"
    # deadline -> primary: no deadline = the paper's device; tight =
    # fixed-step SB; slack >= 4x reference buys SR with tabu
    assert solver_for_deadline(None) == "engine"
    assert solver_for_deadline(0.2) == "sb-jax"
    assert solver_for_deadline(1.0) == "engine"
    assert solver_for_deadline(4.0) == "tabu-jax"
    assert solver_for_deadline(2.0, reference_s=10.0) == "sb-jax"
    # solver="auto" resolves through the same mapping at construction
    with IsingService(solver="auto", auto_deadline_s=0.2, runs=RUNS,
                      seed=SEED, cache=False) as svc:
        assert svc.solver_name == "sb-jax"
        p = Problem.random_qubo(12, 0.5, seed=83)
        res = svc.submit(p).result(timeout=300)
        rep = svc.report()
    assert rep.solver == "sb-jax" and np.isfinite(res.best_energy)


def test_deadline_scales_dispatch_effort():
    p = Problem.random_qubo(12, 0.5, seed=80)
    with IsingService(solver="sa-jax", runs=RUNS, seed=SEED, block=16,
                      max_batch=1, max_wait_s=0.0, cache=False) as svc:
        res = svc.submit(p, deadline_s=0.25).result(timeout=300)
        rep = svc.report()
    assert res.budget == 0.25
    # sa-jax base 200 sweeps x 0.25 budget through search_effort
    assert rep.meta["n_sweeps"] == 50


def test_distant_budget_tiers_do_not_coalesce():
    a = Problem.random_qubo(12, 0.5, seed=81)
    b = Problem.random_qubo(12, 0.5, seed=82)
    with IsingService(solver="sa-jax", runs=RUNS, seed=SEED, block=16,
                      max_batch=8, max_wait_s=0.3, cache=False) as svc:
        ta = svc.submit(a, deadline_s=0.25)      # budget 0.25 -> tier -2
        tb = svc.submit(b, deadline_s=4.0)       # budget 4.0  -> tier  2
        ra, rb = ta.result(timeout=300), tb.result(timeout=300)
        stats = svc.stats()
    assert stats["flushes"] == 2                 # separate effort tiers
    assert ra.budget == 0.25 and rb.budget == 4.0


def test_submit_rejects_oversized_problem_for_capped_solver():
    with IsingService(solver="engine", runs=2) as svc:
        with pytest.raises(ValueError, match="chip-lns"):
            svc.submit(Problem.random_qubo(70, 0.4, seed=1))


# -- streamed report merge (SolveReport.merge fix) ---------------------------

def test_merge_concatenates_per_problem_meta_and_sums_counters():
    s1 = ProblemSuite([Problem.random_qubo(11, 0.5, seed=1)])
    s2 = ProblemSuite([Problem.random_qubo(13, 0.5, seed=2)])
    r1 = get_solver("tabu").solve(s1, runs=3, seed=0)
    r2 = get_solver("tabu").solve(s2, runs=3, seed=0)
    merged = r1.merge(r2)
    # per-problem meta lists concatenate in problem order (self first) —
    # pre-fix, {**other.meta, **self.meta} silently dropped r2's entries
    assert merged.meta["n_iters"] == r1.meta["n_iters"] + r2.meta["n_iters"]
    assert merged.meta["iters_used"] == \
        r1.meta["iters_used"] + r2.meta["iters_used"]
    assert merged.dispatches == r1.dispatches + r2.dispatches
    assert merged.wall_s == pytest.approx(r1.wall_s + r2.wall_s)
    assert merged.compile_s == pytest.approx(r1.compile_s + r2.compile_s)


def test_merge_many_matches_pairwise_fold():
    from repro_torch.api import SolveReport
    suites = [ProblemSuite([Problem.random_qubo(11 + i, 0.5, seed=i)])
              for i in range(3)]
    reps = [get_solver("tabu").solve(s, runs=3, seed=0) for s in suites]
    folded = reps[0].merge(reps[1]).merge(reps[2])
    many = SolveReport.merge_many(reps)
    assert many.problem_hashes == folded.problem_hashes
    assert many.sizes == folded.sizes and many.scales == folded.scales
    assert many.meta == folded.meta
    assert many.dispatches == folded.dispatches
    assert many.wall_s == pytest.approx(folded.wall_s)
    np.testing.assert_array_equal(many.best_energy, folded.best_energy)
    with pytest.raises(ValueError, match="runs"):
        SolveReport.merge_many(
            [reps[0], get_solver("tabu").solve(suites[1], runs=2, seed=0)])


def test_cache_key_separates_solver_configs(tmp_path):
    """Two services with different solver options sharing one cache file
    must not serve each other's results as equivalent."""
    path = str(tmp_path / "shared.json")
    p = Problem.random_qubo(12, 0.5, seed=90)
    common = dict(solver="sa-jax", runs=RUNS, seed=SEED, block=16,
                  max_batch=1, max_wait_s=0.0, cache_path=path)
    with IsingService(n_sweeps=10, **common) as svc:
        svc.submit(p).result(timeout=300)
    with IsingService(n_sweeps=400, **common) as svc2:
        res = svc2.submit(p).result(timeout=300)
    assert not res.cached                # different config digest, no hit
    with IsingService(n_sweeps=400, **common) as svc3:
        res3 = svc3.submit(p).result(timeout=60)
    assert res3.cached                   # same config reloads its own entry


def test_merge_rejects_inconsistent_runs():
    s = ProblemSuite([Problem.random_qubo(11, 0.5, seed=1)])
    r1 = get_solver("sa-numpy").solve(s, runs=4, seed=0)
    r2 = get_solver("sa-numpy").solve(s, runs=2, seed=0)
    with pytest.raises(ValueError, match="runs"):
        r1.merge(r2)


# -- merge-on-store JSON caches ----------------------------------------------

def test_store_json_cache_merges_instead_of_clobbering(tmp_path):
    path = str(tmp_path / "cache.json")
    store_json_cache(path, {"a": 1})
    # a second writer whose in-memory view never saw "a" must not drop it
    store_json_cache(path, {"b": 2})
    assert load_json_cache(path) == {"a": 1, "b": 2}
    # per-key conflict: caller wins by default...
    store_json_cache(path, {"a": 9})
    assert load_json_cache(path)["a"] == 9
    # ...or goes through the resolve callable
    store_json_cache(path, {"a": 5}, resolve=lambda old, new: min(old, new))
    assert load_json_cache(path)["a"] == 5
    store_json_cache(path, {"a": 7}, resolve=lambda old, new: min(old, new))
    assert load_json_cache(path)["a"] == 5
    # atomic: no tmp residue (the flock sidecar is expected)
    names = sorted(f.name for f in tmp_path.iterdir())
    assert not any(n.endswith(".tmp") for n in names)
    assert set(names) <= {"cache.json", "cache.json.lock"}


def test_oracle_store_keeps_lower_energy_on_conflict(tmp_path):
    from repro_torch.api.oracle import _store
    path = str(tmp_path / "oracle.json")
    _store(path, {"h1": {"energy": -5.0, "method": "a"}})
    # a stale worker storing a weaker bound for the same key loses...
    _store(path, {"h1": {"energy": -3.0, "method": "b"},
                  "h2": {"energy": -1.0, "method": "b"}})
    cache = load_sharded_json_cache(path)
    assert cache["h1"]["energy"] == -5.0         # min-merge kept the best
    assert cache["h2"]["energy"] == -1.0         # union kept the new key
    # ...and a better bound wins
    _store(path, {"h1": {"energy": -8.0, "method": "c"}})
    assert load_sharded_json_cache(path)["h1"]["method"] == "c"
    # energy TIES go to the new entry: the exact tier re-verifying a
    # heuristic bound must persist its method or it recomputes forever
    _store(path, {"h1": {"energy": -8.0, "method": "brute_force"}})
    assert load_sharded_json_cache(path)["h1"]["method"] == "brute_force"


# -- failure isolation (satellite: flush blast radius regression) ------------

class _PoisonWrap:
    """Solver wrapper failing any dispatch whose suite contains ``poison``;
    clean dispatches delegate."""

    def __init__(self, inner, poison_hash):
        self.inner = inner
        self.poison = poison_hash
        self.caps = inner.caps

    def solve(self, suite, **kw):
        if any(p.content_hash == self.poison for p in suite.problems):
            raise RuntimeError("poisoned request in flush")
        return self.inner.solve(suite, **kw)


def test_poisoned_request_does_not_fail_flush_mates():
    """Regression: one bad request in a coalesced flush must be bisected
    out, not take down every ticket in the batch (the old _solve_batch
    caught one exception and failed ALL coalesced requests)."""
    from repro_torch.serve import FlushFailed
    probs = [Problem.random_qubo(12, 0.5, seed=500 + i) for i in range(4)]
    svc = IsingService(solver="sa-numpy", runs=RUNS, seed=SEED, block=16,
                       cache=False, max_batch=len(probs), max_wait_s=5.0)
    svc._solver = _PoisonWrap(svc._solver, probs[2].content_hash)
    with svc:
        tickets = svc.submit_many(probs)
        svc.stop()                       # drain flushes the full batch
        results = []
        for i, t in enumerate(tickets):
            if i == 2:
                with pytest.raises(FlushFailed):
                    t.result(timeout=300)
            else:
                results.append(t.result(timeout=300))
    assert len(results) == 3             # flush-mates all answered
    assert all(r.rescued for r in results)
    stats = svc.stats()
    assert stats["errors"] == 1 and stats["completed"] == 3
    assert stats["resilience"]["bisections"] >= 1


# -- ticket cancellation (satellite) ------------------------------------------

def test_cancel_dequeues_before_dispatch():
    from repro_torch.serve import RequestCancelled
    p = Problem.random_qubo(12, 0.5, seed=510)
    with IsingService(solver="sa-numpy", runs=RUNS, seed=SEED, block=16,
                      cache=False, max_batch=8, max_wait_s=5.0) as svc:
        t = svc.submit(p)
        assert svc.stats()["pending"] == 1
        assert t.cancel() is True
        assert svc.stats()["pending"] == 0       # dequeued, never dispatched
        with pytest.raises(RequestCancelled, match="before dispatch"):
            t.result(timeout=10)
        assert t.cancel() is False               # already settled
        stats = svc.stats()
    assert stats["cancelled"] == 1
    assert stats["flushes"] == 0 and stats["dispatches"] == 0


def test_cancel_in_flight_discards_result():
    from repro_torch.serve import RequestCancelled

    class _SlowWrap:
        def __init__(self, inner, started):
            self.inner = inner
            self.caps = inner.caps
            self.started = started

        def solve(self, suite, **kw):
            self.started.set()
            time.sleep(0.4)
            return self.inner.solve(suite, **kw)

    p = Problem.random_qubo(12, 0.5, seed=511)
    started = threading.Event()
    svc = IsingService(solver="sa-numpy", runs=RUNS, seed=SEED, block=16,
                       cache=True, max_batch=1, max_wait_s=0.0)
    svc._solver = _SlowWrap(svc._solver, started)
    with svc:
        t = svc.submit(p)
        assert started.wait(timeout=30)          # dispatch is in flight
        assert t.cancel() is True                # mark-discard path
        with pytest.raises(RequestCancelled, match="in flight"):
            t.result(timeout=10)
        svc.stop()
        stats = svc.stats()
    assert stats["cancelled"] == 1
    assert stats["completed"] == 0               # result discarded...
    assert stats["flushes"] == 1                 # ...though the flush ran
    # a caller that gave up must not populate the cache either
    assert svc._cache == {}


# -- serve-cache corruption quarantine (satellite) ----------------------------

def test_corrupt_cache_entry_quarantined_and_not_resurrected(tmp_path):
    path = str(tmp_path / "serve_cache.json")
    p = Problem.random_qubo(13, 0.5, seed=520)
    common = dict(solver="sa-numpy", runs=RUNS, seed=SEED, block=16,
                  max_batch=1, max_wait_s=0.0, cache_path=path)
    with IsingService(**common) as svc:
        first = svc.submit(p).result(timeout=300)
    # corrupt the persisted entry the way a torn write would: truncate
    # the spin payload
    entries = json.load(open(path))
    (key, entry), = entries.items()
    entry["sigma"] = entry["sigma"][:-3]
    json.dump(entries, open(path, "w"))

    with IsingService(**common) as svc2:
        res = svc2.submit(p).result(timeout=300)
        stats = svc2.stats()
    assert not res.cached                        # corrupt hit rejected
    assert stats["cache_quarantined"] == 1
    # re-solved fresh: one flush (sa-numpy is a host loop, so the DEVICE
    # dispatch counter stays 0)
    assert stats["flushes"] == 1 and stats["dispatches"] == 0
    np.testing.assert_array_equal(res.energies, first.energies)
    # the persisted file now holds the CLEAN replacement — a plain
    # merge-on-store would have resurrected (or preferred) the corrupt one
    disk = json.load(open(path))
    assert list(disk) == [key]
    assert len(disk[key]["sigma"]) == p.n
    with IsingService(**common) as svc3:
        assert svc3.submit(p).result(timeout=60).cached


def test_truncated_cache_file_cold_restart_no_data_loss(tmp_path):
    path = str(tmp_path / "serve_cache.json")
    p = Problem.random_qubo(13, 0.5, seed=521)
    common = dict(solver="sa-numpy", runs=RUNS, seed=SEED, block=16,
                  max_batch=1, max_wait_s=0.0, cache_path=path)
    with IsingService(**common) as svc:
        svc.submit(p).result(timeout=300)
    # kill -9 mid-write, old-style: the file is half a JSON document
    raw = open(path).read()
    open(path, "w").write(raw[: len(raw) // 2])

    with IsingService(**common) as svc2:         # cold restart: loads clean
        res = svc2.submit(p).result(timeout=300)
        stats = svc2.stats()
    assert not res.cached and stats["flushes"] == 1    # re-solved fresh
    assert stats["dispatches"] == 0                    # host loop: 0 device
    # the truncated payload was moved aside, and the next _persist_cache
    # wrote a fresh valid file — no data loss, no permanent shadowing
    assert json.load(open(path))                 # parses again
    import os
    assert os.path.exists(path + ".corrupt")
