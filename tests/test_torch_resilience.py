"""repro_torch.serve.resilience + repro_torch.serve.faults — the mirror of
``tests/test_resilience.py`` on the CPU: supervised flush execution,
deterministic fault plans, retry/bisection/fallback, circuit breakers,
watchdog hedging, result validation, straggler detection, overload
admission control and cache quarantine plumbing; plus the port's retry
set (``RETRYABLE_ERRORS``). Every service, executor and solver here runs
with ``torch_device="cpu"``."""
import functools
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.api as tapi
import repro_torch.serve as tserve
from repro_torch.api import Problem
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.serve import (FaultInjector, FaultPlan, FaultySolver,
                               FlushFailed, InjectedFault, Overloaded,
                               ResiliencePolicy, SolverCrash, validate_row)
from repro_torch.serve.resilience import CircuitBreaker
from repro_torch.serve.service import ServeTicket, _Request
from repro_torch.utils import load_json_cache, store_json_cache

RUNS = 3
SEED = 5
BLOCK = 16

CPU = {"torch_device": "cpu"}
IsingService = functools.partial(tserve.IsingService, **CPU)
FlushExecutor = functools.partial(tserve.FlushExecutor, **CPU)
get_solver = functools.partial(tapi.get_solver, **CPU)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(k=4, n=12, seed0=100):
    return [Problem.random_qubo(n, 0.5, seed=seed0 + i) for i in range(k)]


def _mkreq(problem, budget=None, deadline_s=None):
    return _Request(problem=problem, budget=budget, deadline_s=deadline_s,
                    submitted=time.monotonic(), ticket=ServeTicket())


def _executor(policy, solver, name="fake"):
    return FlushExecutor(policy, primary=lambda: solver, solver_name=name,
                         runs=RUNS, seed=SEED, block=BLOCK)


class _Flaky:
    """Delegates to a real solver, but raises scripted exceptions first.
    ``fail_first=k`` fails the first k calls; ``poison`` fails any call
    whose suite contains that problem hash."""

    def __init__(self, fail_first=0, poison=None, exc=RuntimeError,
                 sleep_first=0.0):
        self.inner = get_solver("sa-numpy")
        self.fail_first = fail_first
        self.poison = poison
        self.exc = exc
        self.sleep_first = sleep_first
        self.calls = 0
        self._lock = threading.Lock()

    def solve(self, suite, runs=64, seed=0, budget=None, block=64):
        with self._lock:
            self.calls += 1
            call = self.calls
        if call <= self.fail_first:
            raise self.exc(f"scripted failure #{call}")
        if self.poison is not None and any(
                p.content_hash == self.poison for p in suite.problems):
            raise self.exc("poisoned problem in flush")
        if self.sleep_first and call == 1:
            time.sleep(self.sleep_first)
        return self.inner.solve(suite, runs=runs, seed=seed, budget=budget,
                                block=block)


# -- deterministic fault plans ------------------------------------------------

def test_fault_plan_is_deterministic_and_rate_bounded():
    a = FaultPlan.from_rates(seed=7, rate=0.2, horizon=2000)
    b = FaultPlan.from_rates(seed=7, rate=0.2, horizon=2000)
    c = FaultPlan.from_rates(seed=8, rate=0.2, horizon=2000)
    assert dict(a.schedule) == dict(b.schedule)      # pure function of seed
    assert dict(a.schedule) != dict(c.schedule)
    total = sum(a.counts().values())
    # two sites x 2000 calls at 20% -> ~800 scheduled faults
    assert 550 <= total <= 1050
    assert set(a.counts()) <= {"flush_error", "straggler_delay",
                               "nan_energy", "corrupt_cache_write",
                               "worker_crash"}
    # cache site only ever draws cache corruption
    for (site, _), kind in a.schedule.items():
        if site == "cache":
            assert kind == "corrupt_cache_write"
        else:
            assert kind != "corrupt_cache_write"


def test_fault_plan_validates_inputs():
    with pytest.raises(ValueError, match="rate"):
        FaultPlan.from_rates(rate=1.5)
    with pytest.raises(ValueError, match="unknown fault kinds"):
        FaultPlan.from_rates(kinds=("flush_error", "gamma_ray"))


def test_injector_replays_schedule_in_call_order():
    plan = FaultPlan.from_rates(seed=3, rate=0.5, horizon=50)
    drawn = [FaultInjector(plan).draw("solve") for _ in range(20)]
    expect = [plan.schedule.get(("solve", i)) for i in range(20)]
    # one injector drawing 20 times == 20 fresh injectors drawing once? No —
    # counters advance per injector. Replay against the schedule directly:
    inj = FaultInjector(plan)
    assert [inj.draw("solve") for i in range(20)] == expect
    assert sum(v for v in inj.injected.values()) == \
        sum(1 for k in expect if k)
    # a None plan never injects
    assert FaultInjector(None).draw("solve") is None
    del drawn


def test_faulty_solver_injects_each_kind():
    plan = FaultPlan(seed=0, schedule={
        ("solve", 0): "flush_error",
        ("solve", 1): "worker_crash",
        ("solve", 2): "nan_energy",
    }, straggler_delay_s=0.0)
    from repro_torch.api import ProblemSuite
    suite = ProblemSuite(_problems(2))
    fs = FaultySolver(get_solver("sa-numpy"), FaultInjector(plan))
    with pytest.raises(InjectedFault):
        fs.solve(suite, runs=RUNS, seed=SEED, block=BLOCK)
    with pytest.raises(SolverCrash):
        fs.solve(suite, runs=RUNS, seed=SEED, block=BLOCK)
    rep = fs.solve(suite, runs=RUNS, seed=SEED, block=BLOCK)
    corrupted = rep.meta["injected_nan_problem"]
    assert not validate_row(suite.problems[corrupted],
                            rep.energies[corrupted],
                            rep.best_sigma[corrupted])
    clean = 1 - corrupted
    assert validate_row(suite.problems[clean], rep.energies[clean],
                        rep.best_sigma[clean])


# -- result validation guardrail ----------------------------------------------

def test_validate_row_accepts_honest_solver_output():
    probs = _problems(3)
    from repro_torch.api import ProblemSuite
    rep = get_solver("sa-numpy").solve(ProblemSuite(probs), runs=RUNS,
                                       seed=SEED, block=BLOCK)
    for p, e, s in zip(probs, rep.energies, rep.best_sigma):
        assert validate_row(p, e, s)


def test_validate_row_rejects_corruption_shapes():
    p = _problems(1)[0]
    from repro_torch.api import ProblemSuite
    rep = get_solver("sa-numpy").solve(ProblemSuite([p]), runs=RUNS,
                                       seed=SEED, block=BLOCK)
    e = np.array(rep.energies[0], dtype=np.float64)
    s = np.array(rep.best_sigma[0])
    assert validate_row(p, e, s)
    bad = e.copy(); bad[0] = np.nan
    assert not validate_row(p, bad, s)               # non-finite
    bad = e.copy(); bad[:] = e.min() - 100.0
    assert not validate_row(p, bad, s)               # too-good-to-be-true
    assert not validate_row(p, e, s[:-1])            # truncated spins
    assert not validate_row(p, e, np.zeros_like(s))  # non-±1 spins
    assert not validate_row(p, np.array([]), s)      # empty energies


# -- circuit breaker ----------------------------------------------------------

def test_breaker_threshold_cooldown_and_halfopen_probe():
    br = CircuitBreaker(threshold=3, cooldown_s=0.15)
    for _ in range(2):
        br.record_failure()
    assert br.allow()                        # below threshold
    br.record_success()                      # consecutive: success resets
    for _ in range(3):
        br.record_failure()
    assert not br.allow() and br.trips == 1  # open
    time.sleep(0.16)
    assert br.allow()                        # half-open probe after cooldown
    br.record_failure()                      # probe failed -> re-open
    assert not br.allow()
    time.sleep(0.16)
    br.record_success()                      # probe succeeded -> closed
    assert br.allow() and br.failures == 0


def test_breaker_trips_immediately_on_crash():
    br = CircuitBreaker(threshold=3, cooldown_s=10.0)
    br.trip()
    assert not br.allow() and br.trips == 1


# -- supervised flush executor ------------------------------------------------

def test_retry_recovers_transient_failure():
    solver = _Flaky(fail_first=1)
    ex = _executor(ResiliencePolicy(max_retries=2, backoff_base_s=0.001),
                   solver)
    outcomes, partials, dispatches = ex.execute([_mkreq(p)
                                                 for p in _problems(2)])
    assert all(o.ok and not o.degraded and not o.rescued for o in outcomes)
    assert outcomes[0].attempts == 2 and ex.retries == 1
    # the fake delegates to sa-numpy, a host loop: zero DEVICE dispatches,
    # with the per-problem evaluation count in host_evals instead
    assert dispatches == 0 and len(partials) == 1
    assert partials[0].meta["host_evals"] == 2
    assert partials[0].meta["solver_by_problem"] == ["fake", "fake"]
    assert partials[0].meta["degraded"] == [False, False]


def test_bisection_isolates_poisoned_request():
    probs = _problems(4)
    solver = _Flaky(poison=probs[1].content_hash)
    ex = _executor(ResiliencePolicy(max_retries=0), solver)
    outcomes, partials, _ = ex.execute([_mkreq(p) for p in probs])
    assert [o.ok for o in outcomes] == [True, False, True, True]
    assert isinstance(outcomes[1].error, FlushFailed)
    # survivors were rescued (flush re-composed), never degraded
    assert all(o.rescued and not o.degraded for o in outcomes if o.ok)
    assert ex.bisections >= 1 and ex.failed_requests == 1
    # exactly the three clean problems made it into partial reports
    got = sorted(h for rep in partials for h in rep.problem_hashes)
    assert got == sorted(p.content_hash for i, p in enumerate(probs)
                         if i != 1)


def test_fallback_chain_produces_degraded_results():
    solver = _Flaky(fail_first=10**6)        # primary never succeeds
    ex = _executor(ResiliencePolicy(max_retries=0, fallback=("sa-numpy",)),
                   solver)
    outcomes, partials, _ = ex.execute([_mkreq(p) for p in _problems(2)])
    assert all(o.ok and o.degraded and o.solver == "sa-numpy"
               for o in outcomes)
    assert ex.fallback_solves == 2
    # a failed 2-flush bisects to singletons before escalating, so the
    # fallback provenance arrives as per-problem meta across the partials
    by_problem = [s for rep in partials
                  for s in rep.meta["solver_by_problem"]]
    degraded = [d for rep in partials for d in rep.meta["degraded"]]
    assert by_problem == ["sa-numpy", "sa-numpy"]
    assert degraded == [True, True]


def test_open_breaker_skips_primary_until_cooldown():
    solver = _Flaky(fail_first=10**6)
    ex = _executor(ResiliencePolicy(max_retries=0, fallback=("sa-numpy",),
                                    breaker_threshold=2,
                                    breaker_cooldown_s=60.0), solver)
    reqs = _problems(3)
    for p in reqs[:2]:                       # two exhausted loops -> open
        ex.execute([_mkreq(p)])
    calls_when_open = solver.calls
    out, _, _ = ex.execute([_mkreq(reqs[2])])
    assert out[0].ok and out[0].degraded
    assert solver.calls == calls_when_open   # primary never dispatched
    assert ex.stats()["breaker_trips"] == 1
    assert "fake" in ex.stats()["breaker_open"]


def test_exhausted_chain_fails_typed():
    solver = _Flaky(fail_first=10**6)
    ex = _executor(ResiliencePolicy(max_retries=0), solver)  # no fallback
    out, partials, _ = ex.execute([_mkreq(_problems(1)[0])])
    assert not out[0].ok and isinstance(out[0].error, FlushFailed)
    assert partials == []


class _Corruptor:
    """Returns honest results with the first ``bad`` calls' energies
    corrupted (validation-level, not exception-level, failure)."""

    def __init__(self, bad=1):
        self.inner = get_solver("sa-numpy")
        self.bad = bad
        self.calls = 0

    def solve(self, suite, runs=64, seed=0, budget=None, block=64):
        self.calls += 1
        rep = self.inner.solve(suite, runs=runs, seed=seed, budget=budget,
                               block=block)
        if self.calls <= self.bad:
            rep.energies = list(rep.energies)
            rep.energies[0] = np.array(rep.energies[0], copy=True)
            rep.energies[0][:] = np.nan
        return rep


def test_validation_rejects_and_redispatches():
    ex = _executor(ResiliencePolicy(max_retries=2), _Corruptor(bad=1))
    out, partials, _ = ex.execute([_mkreq(p) for p in _problems(2)])
    assert all(o.ok for o in out)
    assert out[0].rescued                    # its row was re-dispatched
    assert ex.validation_failures == 1
    # clean row kept from flush 1, corrupted row re-solved in flush 2
    assert len(partials) == 2
    for rep in partials:
        for k in range(rep.num_problems):
            e = np.asarray(rep.energies[k])
            assert np.all(np.isfinite(e))


def test_persistent_corruption_escalates_to_fallback():
    ex = _executor(ResiliencePolicy(max_retries=1, fallback=("sa-numpy",)),
                   _Corruptor(bad=10**6))
    out, _, _ = ex.execute([_mkreq(_problems(1)[0])])
    assert out[0].ok and out[0].degraded and out[0].solver == "sa-numpy"
    assert ex.validation_failures >= 2       # initial + retry both rejected


# -- watchdog + hedging -------------------------------------------------------

def test_watchdog_hedges_straggler_first_completion_wins():
    solver = _Flaky(sleep_first=1.5)         # call 1 straggles, call 2 fast
    ex = _executor(ResiliencePolicy(flush_timeout_s=0.3, min_timeout_s=0.05,
                                    hedge=True, hedge_grace=8.0), solver)
    t0 = time.monotonic()
    out, _, _ = ex.execute([_mkreq(p) for p in _problems(2)])
    wall = time.monotonic() - t0
    assert all(o.ok and not o.degraded for o in out)
    assert ex.timeouts == 1 and ex.hedges == 1
    assert wall < 1.4                        # hedge won; never waited out
    #                                          the 1.5s straggler


def test_watchdog_without_hedge_fails_flush():
    class _Sleeper:
        def solve(self, suite, **kw):
            time.sleep(0.5)
            raise AssertionError("should have been abandoned")
    ex = _executor(ResiliencePolicy(flush_timeout_s=0.1, min_timeout_s=0.05,
                                    hedge=False, max_retries=0), _Sleeper())
    out, _, _ = ex.execute([_mkreq(_problems(1)[0])])
    assert not out[0].ok and ex.timeouts == 1


def test_flush_timeout_derives_from_deadlines_with_floor():
    ex = _executor(ResiliencePolicy(flush_timeout_s=5.0, min_timeout_s=0.25),
                   _Flaky())
    reqs = [_mkreq(_problems(1)[0], deadline_s=2.0),
            _mkreq(_problems(1, seed0=200)[0], deadline_s=0.001)]
    t = ex._flush_timeout(reqs)
    assert t == pytest.approx(0.25)          # tightest deadline, floored
    assert ex._flush_timeout([reqs[0]]) == pytest.approx(2.0, abs=0.1)
    # no deadlines, no policy timeout, cold detector -> no watchdog at all
    ex2 = _executor(ResiliencePolicy(), _Flaky())
    assert ex2._flush_timeout([_mkreq(_problems(1)[0])]) is None


# -- straggler detector (satellite: warmup fix) -------------------------------

def test_straggler_warmup_seeds_mean_and_variance():
    det = StragglerDetector(warmup=3, threshold=3.0, patience=2)
    for dt in (0.10, 0.20, 0.30):
        assert det.observe(dt) is False
    assert det.mean == pytest.approx(0.20)
    assert det.var == pytest.approx(np.var([0.1, 0.2, 0.3]))
    # a hair above the last warmup sample is NOT an outlier against the
    # seeded spread (the pre-fix detector had var=0 here and z-scored
    # against a floor of 5% of mean)
    det.observe(0.31)
    assert det.strikes == 0


def test_straggler_persistent_outlier_freezes_baseline_and_flags():
    det = StragglerDetector(warmup=3, threshold=3.0, patience=3, alpha=0.5)
    for dt in (0.10, 0.10, 0.10):
        det.observe(dt)
    base = det.mean
    flagged = [det.observe(5.0) for _ in range(3)]
    assert flagged == [False, False, True]   # patience strikes, then flag
    assert det.mean == pytest.approx(base)   # outliers never drag the EWMA
    assert det.strikes == 0                  # flag resets the strike count


def test_straggler_recovers_after_transient():
    det = StragglerDetector(warmup=3, threshold=3.0, patience=3)
    for dt in (0.10, 0.10, 0.10):
        det.observe(dt)
    det.observe(5.0)                         # one transient spike
    assert det.strikes == 1
    det.observe(0.10)                        # back to normal: strikes clear
    assert det.strikes == 0


# -- overload admission control ----------------------------------------------

def test_overload_degrades_then_sheds_typed():
    policy = ResiliencePolicy(degrade_pending=1, shed_pending=3)
    probs = _problems(5, seed0=300)
    svc = IsingService(solver="sa-numpy", runs=RUNS, seed=SEED, block=BLOCK,
                       cache=False, max_batch=64, max_wait_s=5.0,
                       resilience=policy)
    with svc:
        t0 = svc.submit(probs[0], budget=1.0)           # depth 0: full effort
        t1 = svc.submit(probs[1], budget=1.0)           # depth 1: degraded
        t2 = svc.submit(probs[2], budget=1.0)           # depth 2: degraded 2x
        with pytest.raises(Overloaded, match="overloaded"):
            svc.submit(probs[3], budget=1.0)            # depth 3: shed
        stats = svc.stats()
        # unblock the queue: drain on exit resolves everything still queued
    r0, r1, r2 = (t.result(timeout=300) for t in (t0, t1, t2))
    assert r0.budget == 1.0
    assert r1.budget == pytest.approx(0.5)               # one ladder rung
    assert r2.budget == pytest.approx(0.25)              # two rungs
    assert stats["shed"] == 1 and stats["degraded_admissions"] == 2
    assert svc.stats()["completed"] == 3


def test_degrade_budget_ladder_floors():
    from repro_torch.api.budget import degrade_budget
    assert degrade_budget(1.0, 0) == 1.0
    assert degrade_budget(1.0, 1) == 0.5
    assert degrade_budget(None, 2) == 0.25
    assert degrade_budget(1.0, 50) == 0.125              # floored
    with pytest.raises(ValueError):
        degrade_budget(0.0, 1)


# -- cache quarantine plumbing (utils drop=) ---------------------------------

def test_store_json_cache_drop_prevents_resurrection(tmp_path):
    path = str(tmp_path / "c.json")
    store_json_cache(path, {"good": 1, "corrupt": 666})
    # plain merge would resurrect "corrupt" from disk; drop kills it
    store_json_cache(path, {"good": 1}, drop=("corrupt",))
    assert load_json_cache(path) == {"good": 1}
    # a replacement for a dropped key lands without fighting the resolver
    store_json_cache(path, {"corrupt": 2}, drop=("corrupt",),
                     resolve=lambda old, new: max(old, new))
    assert load_json_cache(path)["corrupt"] == 2
    # dropping a missing key is a no-op
    store_json_cache(path, {}, drop=("ghost",))
    assert load_json_cache(path) == {"good": 1, "corrupt": 2}


# -- end-to-end chaos smoke ---------------------------------------------------

def test_chaos_service_loses_no_tickets_and_validates_all_results():
    plan = FaultPlan.from_rates(seed=11, rate=0.35, horizon=500,
                                straggler_delay_s=0.4)
    policy = ResiliencePolicy(max_retries=2, backoff_base_s=0.001,
                              fallback=("sa-numpy",),
                              flush_timeout_s=0.2, min_timeout_s=0.1,
                              hedge=True, hedge_grace=20.0,
                              breaker_threshold=3, breaker_cooldown_s=0.5)
    probs = _problems(10, seed0=400)
    with IsingService(solver="sa-numpy", runs=RUNS, seed=SEED, block=BLOCK,
                      max_batch=4, max_wait_s=0.01, cache=True,
                      resilience=policy, fault_plan=plan) as svc:
        tickets = svc.submit_many(probs)
        results = [t.result(timeout=300) for t in tickets]
        stats = svc.stats()
    assert len(results) == len(probs)        # zero lost tickets
    for p, res in zip(probs, results):
        assert validate_row(p, res.energies, res.sigma)
    assert sum(stats["faults"]["injected"].values()) > 0  # chaos actually ran
    assert stats["errors"] == 0


# -- the port's retry set ----------------------------------------------------

def test_retryable_errors_retry_launch_failures_only():
    from repro_torch.distributed.fault_tolerance import (RETRYABLE_ERRORS,
                                                         StepFailure,
                                                         resilient_step)
    from repro_torch.kernels.build import KernelLaunchError, check_launch
    assert KernelLaunchError in RETRYABLE_ERRORS
    assert torch.cuda.OutOfMemoryError in RETRYABLE_ERRORS
    assert RuntimeError not in RETRYABLE_ERRORS
    assert ValueError not in RETRYABLE_ERRORS

    def run(errors):
        calls, restores = [], []

        def step(state):
            calls.append(state)
            if len(calls) <= len(errors):
                raise errors[len(calls) - 1]
            return state + 1, {"loss": 0.0}
        return resilient_step(step, lambda: restores.append(1) or 10,
                              max_retries=3)(0), calls, restores

    # a failed launch (and a typed step failure) is retried after a restore
    (state, _), calls, restores = run([KernelLaunchError("cudaError 719"),
                                       StepFailure("nan")])
    assert state == 11 and len(calls) == 3 and len(restores) == 2
    # a refused plan, a bare RuntimeError and a ValueError propagate at once
    for err in (ValueError("bad shape"), RuntimeError("a bug")):
        with pytest.raises(type(err)):
            run([err])
    with pytest.raises(ValueError, match="refused the launch plan"):
        check_launch(-1, "ising_anneal", "plan")
    with pytest.raises(KernelLaunchError, match="cudaError 2"):
        check_launch(2, "sb_integrate", "plan")
    check_launch(0, "sb_integrate", "plan")
    # exhausted retries end in a StepFailure naming the last error
    with pytest.raises(StepFailure, match="cudaError 700"):
        run([KernelLaunchError("cudaError 700")] * 4)


class _Refusing:
    """A primary whose kernel wrapper refuses its launch plan on every
    call (the ``ValueError`` of ``check_launch``), or whose launch fails
    on the first ``fail_launches`` calls (``KernelLaunchError``)."""

    def __init__(self, fail_launches=None, inner=None):
        self.inner = inner if inner is not None else get_solver("sa-numpy")
        self.caps = self.inner.caps
        self.fail_launches = fail_launches
        self.calls = 0

    def solve(self, suite, runs=64, seed=0, budget=None, block=64):
        from repro_torch.kernels.build import REFUSED, check_launch
        self.calls += 1
        if self.fail_launches is None:
            check_launch(REFUSED, "ising_anneal", "plan")
        if self.calls <= self.fail_launches:
            check_launch(719, "ising_anneal", "plan")
        return self.inner.solve(suite, runs=runs, seed=seed, budget=budget,
                                block=block)


def test_executor_passes_refusals_through_and_retries_launch_failures():
    policy = ResiliencePolicy(max_retries=2, backoff_base_s=0.001,
                              fallback=("sa-numpy",))
    # a refused plan: one call, no retry, no bisection, no fallback; every
    # ticket of the flush gets the ValueError itself and the breaker is
    # not charged
    solver = _Refusing()
    ex = _executor(policy, solver)
    outcomes, partials, _ = ex.execute([_mkreq(p) for p in _problems(3)])
    assert solver.calls == 1 and partials == []
    assert ex.retries == ex.bisections == ex.fallback_solves == 0
    assert all(not o.ok and isinstance(o.error, ValueError) and
               "refused the launch plan" in str(o.error) for o in outcomes)
    assert ex.failed_requests == 3
    assert ex._breakers["fake"].failures == 0
    # a failed launch is a fault: retried on the same tier, not degraded
    solver = _Refusing(fail_launches=2)
    ex = _executor(policy, solver)
    outcomes, _, _ = ex.execute([_mkreq(p) for p in _problems(2)])
    assert all(o.ok and not o.degraded and o.solver == "fake"
               for o in outcomes)
    assert solver.calls == 3 and ex.retries == 2


def test_service_ticket_raises_the_engines_refusal():
    """The engine raising ``ValueError`` inside ``IsingService``: the
    ticket's result raises it, after one dispatch and no fallback."""
    probs = _problems(2, n=16, seed0=700)
    policy = ResiliencePolicy(max_retries=2, backoff_base_s=0.001,
                              fallback=("sa-numpy",))
    with IsingService(solver="engine", runs=RUNS, seed=SEED, block=BLOCK,
                      max_batch=2, max_wait_s=0.01, cache=True,
                      resilience=policy) as svc:
        svc._solver = _Refusing(inner=svc._solver)
        tickets = svc.submit_many(probs)
        for t in tickets:
            with pytest.raises(ValueError, match="refused the launch plan"):
                t.result(timeout=60)
        stats = svc.stats()
    assert svc._solver.calls == 1
    assert stats["errors"] == 2
    assert stats["resilience"]["fallback_solves"] == 0
