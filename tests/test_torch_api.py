"""The port's typed API against the JAX package's, on the CPU.

Tolerances, fixed before the port was written:
  * bitwise: ``problem_set`` levels, ``content_hash``, bucket plans,
    brute-force and numpy-tabu energies (same seed);
  * SR / TTS / ETS: rtol 1e-12;
  * end-to-end ``solve_suite`` at N <= 24 (brute-force oracle): ``gd``
    energies bitwise; ``perturbation`` >= 99% of run energies equal and
    per-problem SR within 0.01.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as rapi
from repro.metrics import success as r_success
from repro.solvers.brute_force import brute_force_ground_state as r_brute
from repro.solvers.tabu import tabu_search as r_tabu
import repro_torch.api as tapi
from repro_torch import convert
from repro_torch.api import oracle as t_oracle
from repro_torch.metrics import success as t_success
from repro_torch.problems import problem_set as t_problem_set
from repro_torch.solvers.brute_force import brute_force_ground_state as t_brute
from repro_torch.solvers.tabu import tabu_search as t_tabu
from repro_torch.solvers.tabu_jax import tabu_search_jax_runs as t_tabu_jax

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU matmuls run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' oracle and autotune caches in a temp dir."""
    monkeypatch.setenv("REPRO_ORACLE_CACHE", str(tmp_path / "r_oracle.json"))
    monkeypatch.setenv("REPRO_TORCH_ORACLE_CACHE",
                       str(tmp_path / "t_oracle.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "r_tune.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "t_tune.json"))
    return tmp_path


# -- problems, suites, plans ---------------------------------------------

@pytest.mark.parametrize("n,density,num,seed", [(16, 0.5, 3, 42),
                                                (64, 0.3, 2, 7)])
def test_random_suites_identical(n, density, num, seed):
    from repro.problems import problem_set as r_problem_set
    assert np.array_equal(r_problem_set(n, density, num, seed).J,
                          t_problem_set(n, density, num, seed).J)
    a = rapi.ProblemSuite.random(n=n, density=density, num_problems=num,
                                 seed=seed)
    b = tapi.ProblemSuite.random(n=n, density=density, num_problems=num,
                                 seed=seed)
    assert a.hashes == b.hashes
    for pa, pb in zip(a, b):
        assert np.array_equal(pa.levels, pb.levels) and pa.meta == pb.meta


def test_grid_suite_and_bucket_plans_identical():
    kw = dict(sizes=(16, 20, 64, 70), densities=(0.1, 0.9),
              problems_per_cell=2, seed=3)
    a, b = rapi.ProblemSuite.grid(**kw), tapi.ProblemSuite.grid(**kw)
    assert a.hashes == b.hashes
    assert dataclasses.astuple(a.plan()) == dataclasses.astuple(b.plan())
    assert a.num_dispatches() == b.num_dispatches() == 2
    for ba, bb in zip(a.buckets(), b.buckets()):
        assert ba.n_pad == bb.n_pad and ba.indices == bb.indices
        assert np.array_equal(ba.J, bb.J)
    assert tapi.padded_size(65) == rapi.padded_size(65) == 128


def test_problem_constructors_and_hash():
    J = np.array([[0, 3, -2], [3, 0, 1], [-2, 1, 0]], float)
    for ctor in ("from_couplings", "partition"):
        arg = J if ctor == "from_couplings" else [3, 1, 2]
        pa = getattr(rapi.Problem, ctor)(arg)
        pb = getattr(tapi.Problem, ctor)(arg)
        assert pa.content_hash == pb.content_hash and pa.scale == pb.scale
    cont = np.array([[0, 0.3, 1.1], [0.3, 0, -0.7], [1.1, -0.7, 0]])
    pa = rapi.Problem.from_couplings(cont, quantize=True)
    pb = tapi.Problem.from_couplings(cont, quantize=True)
    assert pa.content_hash == pb.content_hash
    assert np.array_equal(pa.levels, pb.levels)
    with pytest.raises(ValueError):
        tapi.Problem.from_couplings(cont)
    with pytest.raises(ValueError):
        tapi.Problem(levels=np.array([[0, 16], [16, 0]]))


def test_convert_carries_problems_and_configs():
    from repro.core import DEFAULT_PERTURBATION, DeviceModel
    rs = rapi.ProblemSuite.random(n=12, density=0.5, num_problems=3, seed=1)
    h = np.linspace(-1, 1, 12)
    p0 = rapi.Problem(levels=rs[0].levels, scale=0.25, h=h, kind="x")
    carried = convert.problem_from_arrays(np.asarray(p0.levels), p0.scale,
                                          np.asarray(p0.h), kind=p0.kind)
    assert carried.content_hash == p0.content_hash
    suite = convert.suite_from_arrays([np.asarray(p.levels) for p in rs],
                                      metas=[p.meta for p in rs])
    assert suite.hashes == rs.hashes
    dev = DeviceModel(n_spins=32, tau_leak_sweeps=4.0,
                      compute_dtype="bfloat16")
    tdev = convert.device_model_from_fields(dataclasses.asdict(dev))
    assert dataclasses.asdict(tdev) == dataclasses.asdict(dev)
    assert tdev.n_steps == dev.n_steps and tdev.dt == dev.dt
    tp = convert.perturbation_from_fields(
        dataclasses.asdict(DEFAULT_PERTURBATION))
    assert dataclasses.asdict(tp) == dataclasses.asdict(DEFAULT_PERTURBATION)
    with pytest.raises(ValueError, match="no fields"):
        convert.device_model_from_fields({"n_spins": 8, "bogus": 1})


# -- host solvers and metrics --------------------------------------------

def test_brute_force_and_tabu_bitwise():
    J = t_problem_set(14, 0.6, 1, seed=5).J[0]
    ea, sa = r_brute(J)
    eb, sb = t_brute(J)
    assert ea == eb and np.array_equal(sa, sb)
    ra = r_tabu(J, n_iters=200, n_restarts=4, seed=9, return_all=True)
    rb = t_tabu(J, n_iters=200, n_restarts=4, seed=9, return_all=True)
    for a, b in zip(ra, rb):
        assert np.array_equal(a, b)


def test_success_metrics_match():
    rng = np.random.default_rng(0)
    e = -rng.integers(50, 100, (4, 32)).astype(float)
    best = e.min(axis=1) - rng.integers(0, 3, 4)
    sr_a = r_success.success_rate(e, best)
    sr_b = t_success.success_rate(e, best)
    np.testing.assert_allclose(sr_b, sr_a, rtol=1e-12)
    np.testing.assert_allclose(t_success.time_to_solution(sr_b, 3e-6),
                               r_success.time_to_solution(sr_a, 3e-6),
                               rtol=1e-12)
    np.testing.assert_allclose(
        t_success.normalized_ets(t_success.energy_to_solution(0.03, sr_b)),
        r_success.normalized_ets(r_success.energy_to_solution(0.03, sr_a)),
        rtol=1e-12)


def _metrics_close(ra, rb):
    ma, mb = ra.metrics(), rb.metrics()
    for k in ("success_rate", "tts_s", "ets_j", "normalized_ets_j"):
        np.testing.assert_allclose(mb[k], ma[k], rtol=1e-12)


# -- end to end ----------------------------------------------------------

SUITE = dict(n=16, density=0.5, num_problems=3, seed=42)


def test_solve_suite_gd_bitwise_and_metrics(caches):
    ra = rapi.solve_suite(rapi.ProblemSuite.random(**SUITE), solver="engine",
                          runs=64, seed=7, variant="gd")
    rb = tapi.solve_suite(tapi.ProblemSuite.random(**SUITE), solver="engine",
                          runs=64, seed=7, variant="gd", torch_device=CPU)
    assert rb.meta["engine_plan"]["j_dtype"] == "int8"
    assert rb.dispatches == ra.dispatches == 1
    for a, b in zip(ra.energies, rb.energies):
        assert np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(ra.best_sigma,
                                                    rb.best_sigma))
    assert np.array_equal(ra.best_known, rb.best_known)
    _metrics_close(ra, rb)
    # the fused path (the kernel's plain version on the CPU) agrees too
    rf = tapi.solve_suite(tapi.ProblemSuite.random(**SUITE), solver="engine",
                          runs=64, seed=7, variant="gd", backend="fused",
                          torch_device=CPU)
    assert rf.meta["engine_plan"]["path"] == "fused"
    for a, b in zip(ra.energies, rf.energies):
        assert np.array_equal(a, b)


def test_solve_suite_perturbation_within_tolerance(caches):
    ra = rapi.solve_suite(rapi.ProblemSuite.random(**SUITE), solver="engine",
                          runs=64, seed=7)
    rb = tapi.solve_suite(tapi.ProblemSuite.random(**SUITE), solver="engine",
                          runs=64, seed=7, torch_device=CPU)
    ea, eb = np.concatenate(ra.energies), np.concatenate(rb.energies)
    assert (ea == eb).mean() >= 0.99
    assert np.array_equal(ra.best_known, rb.best_known)   # brute force
    assert np.abs(ra.success_rate() - rb.success_rate()).max() <= 0.01
    # block_r: None, the launch plan's pick where a kernel runs (the scan
    # path ignores it)
    assert rb.meta["engine_plan"] == {"path": "scan", "block_r": None,
                                      "j_dtype": "float32", "reason": "auto"}


def test_noise_variant_and_brute_force_solver(caches):
    suite = tapi.ProblemSuite.random(n=10, density=0.5, num_problems=2,
                                     seed=3)
    runs = [tapi.solve_suite(suite, solver="engine", runs=16, seed=1,
                             variant="noise", budget=0.25, torch_device=CPU)
            for _ in range(2)]
    assert runs[0].meta["engine_plan"]["path"] == "scan"
    assert all(np.array_equal(a, b) for a, b in zip(runs[0].energies,
                                                    runs[1].energies))
    exact = tapi.solve_suite(suite, solver="brute-force", torch_device=CPU)
    assert np.array_equal(exact.best_energy, runs[0].best_known)
    ref = rapi.solve_suite(rapi.ProblemSuite.random(n=10, density=0.5,
                                                    num_problems=2, seed=3),
                           solver="brute-force")
    assert np.array_equal(ref.best_energy, exact.best_energy)
    assert set(tapi.list_solvers()) == {"engine", "brute-force", "sb-jax",
                                        "chip-lns", "sa-jax", "sa-numpy",
                                        "tabu", "tabu-jax", "pt-jax",
                                        "ode-jax", "fabric-jax"}
    assert set(tapi.list_solvers()) == set(rapi.list_solvers())
    with pytest.raises(ValueError, match="max_n"):
        tapi.solve_suite(tapi.ProblemSuite.random(n=70, density=0.5,
                                                  num_problems=1, seed=0),
                         torch_device=CPU, oracle=False)


def test_oracle_tiers_and_own_cache(caches):
    small = tapi.ProblemSuite.random(n=12, density=0.5, num_problems=2,
                                     seed=4)
    large = tapi.ProblemSuite.random(n=26, density=0.5, num_problems=1,
                                     seed=4)
    path = t_oracle.cache_path()
    assert path == str(caches / "t_oracle.json")
    e = tapi.best_known_energies(small + large, torch_device=CPU)
    cache = t_oracle._load(path)
    methods = [cache[p.content_hash]["method"] for p in small + large]
    assert methods == ["brute_force", "brute_force", "tabu-jax"]
    assert e[0] == t_brute(small[0].J_levels)[0]
    # the batched tier: tabu-jax with the oracle's seed and restarts, the
    # problem padded to its 64-spin bucket
    (bucket,) = large.buckets()
    assert e[2] == t_tabu_jax(
        bucket.J, n_true=[26], n_restarts=t_oracle.TABU_JAX_ORACLE_RESTARTS,
        seed=0, torch_device=CPU)[0].min()
    assert not (caches / "r_oracle.shards").exists()
    # a cache hit skips the search; a strictly better candidate upgrades it
    again = tapi.best_known_energies(small + large, torch_device=CPU)
    assert np.array_equal(again, e)
    better = tapi.reconcile_best_known(large, e[2:] - 2.0, method="test")
    assert better[0] == e[2] - 2.0
    assert t_oracle._load(path)[large[0].content_hash]["method"] == "test"
    assert t_oracle.DEFAULT_CACHE.endswith(
        "experiments/oracle_cache_torch.json")


def test_report_merge_slice_and_json(caches):
    suite = tapi.ProblemSuite.random(n=10, density=0.5, num_problems=3,
                                     seed=2)
    rep = tapi.solve_suite(suite, solver="engine", runs=8, seed=0,
                           budget=0.25, torch_device=CPU)
    parts = [rep.slice_problems([0]), rep.slice_problems([1, 2])]
    merged = tapi.SolveReport.merge_many(parts)
    assert merged.problem_hashes == rep.problem_hashes
    np.testing.assert_allclose(merged.success_rate(), rep.success_rate(),
                               rtol=1e-12)
    js = rep.to_json()
    assert js["solver"] == "engine" and js["metrics"] is not None
    assert js["meta"]["torch_device"] == "cpu"
    assert "success rate" in rep.summary()
