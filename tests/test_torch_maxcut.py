"""Max-Cut / Gset problems, chip-lns and the solve CLI in the port against
the JAX package.

The same seeds and numpy inputs go to ``repro`` and ``repro_torch``
(``torch_device="cpu"``). Tolerances, fixed before the port was written:
  * bitwise: every problem generator (graph bytes and
    ``Problem.content_hash``), Gset text round trips, ``cut_from_energy``;
  * chip-lns on the unit schedule (``BlockLNS`` over an ``AnnealEngine``
    with no perturbation and no finite leakage, the same arrays on both
    sides): energies, spins and initial energies bitwise, and the same
    dispatch count (one per outer sweep);
  * chip-lns under the default perturbation schedule: >= 99% of energies
    equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import Problem as RProblem
from repro.api import get_solver as r_get_solver
from repro.core import perturbation as r_pert
from repro.core.device_model import DeviceModel as RDeviceModel
from repro.core.engine import AnnealEngine as RAnnealEngine
from repro.core.engine import BlockLNS as RBlockLNS
from repro.core.engine import lns_blocks as r_lns_blocks
from repro.launch.solve import build_suite as r_build_suite
from repro.problems import cut_from_energy as r_cut_from_energy
from repro.problems import dump_gset as r_dump_gset
from repro.problems import gset_problem as r_gset_problem
from repro.problems import maxcut_problem as r_maxcut_problem
from repro.problems import number_partitioning as r_number_partitioning
from repro.problems import parse_gset as r_parse_gset
from repro.problems import random_gset as r_random_gset
from repro.problems import random_maxcut as r_random_maxcut
from repro_torch.api import Problem, ProblemSuite, get_solver
from repro_torch.convert import (device_model_from_fields,
                                 perturbation_from_fields)
from repro_torch.core import AnnealEngine, maxcut_value
from repro_torch.core.engine import BlockLNS, lns_blocks
from repro_torch.launch import solve as cli
from repro_torch.problems import (cut_from_energy, dump_gset, gset_problem,
                                  load_gset, maxcut_problem,
                                  number_partitioning, parse_gset,
                                  random_gset, random_maxcut)

CPU = {"torch_device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- problem generators: bitwise ---------------------------------------------

@pytest.mark.parametrize("n,density,seed,weighted", [
    (12, 0.5, 0, True), (48, 0.9, 606, True), (33, 0.3, 7, False)])
def test_random_maxcut_and_problem_maxcut_bitwise(n, density, seed, weighted):
    W = random_maxcut(n, density, seed, weighted)
    W_ref = r_random_maxcut(n, density, seed, weighted)
    assert W.dtype == W_ref.dtype and np.array_equal(W, W_ref)
    p = Problem.maxcut(n, density, seed, weighted)
    r = RProblem.maxcut(n, density, seed, weighted)
    assert p.content_hash == r.content_hash and p.kind == "maxcut"
    assert np.array_equal(p.meta["W"], r.meta["W"])
    assert np.array_equal(p.J, r.J)
    W2, J2 = maxcut_problem(n, density, seed, weighted)
    W2r, J2r = r_maxcut_problem(n, density, seed, weighted)
    assert np.array_equal(W2, W2r) and np.array_equal(J2, J2r)


@pytest.mark.parametrize("n,kind,seed,degree,max_w", [
    (100, "uniform", 3, 6.0, 1), (64, "uniform", 5, 3.0, 4),
    (49, "torus", 2, 6.0, 1), (2000, "uniform", 1209, 6.0, 1)])
def test_gset_generators_bitwise(n, kind, seed, degree, max_w):
    W = random_gset(n, seed=seed, kind=kind, degree=degree, max_w=max_w)
    W_ref = r_random_gset(n, seed=seed, kind=kind, degree=degree,
                          max_w=max_w)
    assert W.dtype == W_ref.dtype and np.array_equal(W, W_ref)
    p = gset_problem(n, seed=seed, kind=kind, degree=degree, max_w=max_w)
    r = r_gset_problem(n, seed=seed, kind=kind, degree=degree, max_w=max_w)
    assert p.content_hash == r.content_hash
    assert np.array_equal(p.meta["W"], r.meta["W"])


def test_duel_graph_is_the_reference_duel_graph():
    """The N=2000 Gset duel graph (benchmarks/fabric_scaling.py): 6035
    edges, levels {-1, 0}."""
    p = gset_problem(2000, seed=1209, degree=6.0)
    assert p.n == 2000 and int((p.meta["W"] > 0).sum()) // 2 == 6035
    assert set(np.unique(p.levels)) == {-1, 0}
    assert p.content_hash == r_gset_problem(2000, seed=1209,
                                            degree=6.0).content_hash


def test_gset_text_round_trip_and_file(tmp_path):
    W = random_gset(30, seed=1, max_w=3)
    text = dump_gset(W)
    assert text == r_dump_gset(W)
    assert np.array_equal(parse_gset(text), r_parse_gset(text))
    assert np.array_equal(parse_gset(text), W)
    path = tmp_path / "g.txt"
    path.write_text(text)
    assert np.array_equal(load_gset(path), W)
    from_file = gset_problem(str(path))
    assert from_file.content_hash == r_gset_problem(str(path)).content_hash
    assert from_file.meta["gset_path"] == str(path)
    assert gset_problem(W).content_hash == r_gset_problem(W).content_hash


@pytest.mark.parametrize("text,match", [
    ("", "empty"), ("3\n", "header"), ("3 2\n1 2 1\n", "promises"),
    ("3 1\n1 2\n", "i j w"), ("3 1\n1 4 1\n", "outside"),
    ("3 1\n2 2 1\n", "self-loop"), ("0 0\n", ">= 1")])
def test_parse_gset_rejects_what_the_reference_rejects(text, match):
    with pytest.raises(ValueError, match=match):
        parse_gset(text)
    with pytest.raises(ValueError, match=match):
        r_parse_gset(text)


def test_gset_rejects_bad_kinds():
    for fn in (random_gset, r_random_gset):
        with pytest.raises(ValueError, match="square"):
            fn(50, kind="torus")
        with pytest.raises(ValueError, match="unknown"):
            fn(50, kind="ring")


def test_cut_from_energy_matches_reference_and_spins():
    p = gset_problem(120, seed=4)
    W = p.meta["W"]
    rng = np.random.default_rng(0)
    for _ in range(5):
        s = rng.choice([-1, 1], 120).astype(np.int8)
        e = float(p.energy(s))
        cut = cut_from_energy(W, e)
        assert cut == r_cut_from_energy(W, e)
        W64 = torch.as_tensor(W, dtype=torch.float64)
        assert cut == float(maxcut_value(W64, torch.as_tensor(s)))


def test_number_partitioning_matches_reference():
    for values in ([3, 1, 1, 2, 2, 1], [0.5, 1.25, 7.0, 2.0]):
        J, residue = number_partitioning(values)
        J_ref, residue_ref = r_number_partitioning(values)
        assert np.array_equal(J, J_ref)
        s = np.array([1, -1] * (len(values) // 2))
        assert residue(s) == residue_ref(s)


# -- chip-lns ----------------------------------------------------------------

def _unit_engines(anneal_sweeps=0.25):
    """Reference and port engines on the unit schedule (no perturbation,
    no finite leakage) with the same device model."""
    rdev = RDeviceModel(anneal_sweeps=anneal_sweeps,
                        tau_leak_sweeps=float("inf"))
    tdev = device_model_from_fields(dataclasses.asdict(rdev))
    tpert = perturbation_from_fields(dataclasses.asdict(r_pert.NOMINAL))
    return (RAnnealEngine(device=rdev, perturbation=r_pert.NOMINAL),
            AnnealEngine(device=tdev, perturbation=tpert, **CPU))


@pytest.mark.parametrize("n", [128, 130])
def test_block_lns_unit_schedule_bitwise(n):
    J = [Problem.maxcut(n, 0.5, seed=717).J_levels.astype(np.float64),
         gset_problem(n, seed=3, degree=8.0).J_levels.astype(np.float64)]
    r_eng, t_eng = _unit_engines()
    ref, r_d = RBlockLNS(r_eng, chip_block=64, inner_runs=4).solve(
        J, restarts=4, outer_sweeps=2, seed=11)
    lns = BlockLNS(t_eng, chip_block=64, inner_runs=4)
    out, t_d = lns.solve(J, restarts=4, outer_sweeps=2, seed=11)
    assert t_d == r_d == 2 == lns.last_timings["dispatches"]
    for (e, s, e0), (re, rs, re0) in zip(out, ref):
        assert np.array_equal(e, re) and np.array_equal(e0, re0)
        assert s.dtype == np.int8 and np.array_equal(s, rs)
        assert np.all(e <= e0)                  # monotone incumbents


def test_lns_blocks_match_reference():
    for n, fb in ((128, 63), (130, 63), (2000, 63), (5, 10)):
        a, b = lns_blocks(n, fb), r_lns_blocks(n, fb)
        assert len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
    with pytest.raises(ValueError):
        lns_blocks(10, 0)


def test_chip_lns_default_schedule_matches_reference():
    """Through the registry, under the default perturbation schedule: >= 99%
    of the returned energies equal, the same dispatch ledger."""
    kw = dict(anneal_sweeps=0.5, inner_runs=4, outer_sweeps=2)
    p = Problem.maxcut(128, 0.5, seed=717)
    rep = get_solver("chip-lns", **kw, **CPU).solve(p, runs=4, seed=11)
    ref = r_get_solver("chip-lns", **kw).solve(
        RProblem.maxcut(128, 0.5, seed=717), runs=4, seed=11)
    assert rep.dispatches == ref.dispatches == 2
    assert rep.meta["n_blocks"] == ref.meta["n_blocks"] == 3
    same = np.asarray(rep.energies[0]) == np.asarray(ref.energies[0])
    assert same.mean() >= 0.99
    s = rep.best_sigma[0].astype(np.float64)
    assert -0.5 * s @ p.J_levels.astype(np.float64) @ s == rep.best_energy[0]


def test_chip_lns_duel_graph_cut_matches_reference():
    """The N=2000 duel with its recorded settings (inner_runs 4, outer
    sweeps 2, anneal_sweeps 0.5, 4 restarts, seed 1207): the same best
    cut as the reference (BENCH_fabric.json records 3923)."""
    kw = dict(anneal_sweeps=0.5, inner_runs=4, outer_sweeps=2)
    p = gset_problem(2000, seed=1209, degree=6.0)
    rep = get_solver("chip-lns", **kw, **CPU).solve(p, runs=4, seed=1207)
    ref = r_get_solver("chip-lns", **kw).solve(
        r_gset_problem(2000, seed=1209, degree=6.0), runs=4, seed=1207)
    W = p.meta["W"]
    cut = cut_from_energy(W, float(np.min(rep.energies[0])))
    assert cut == r_cut_from_energy(W, float(np.min(ref.energies[0])))
    assert cut == 3923.0 and rep.dispatches == 2


def test_chip_lns_delegates_small_problems_to_the_engine_bitwise():
    suite = ProblemSuite([Problem.maxcut(48, 0.5, seed=1),
                          Problem.random_qubo(40, 0.5, seed=2)])
    lns = get_solver("chip-lns", **CPU).solve(suite, runs=8, seed=5,
                                              budget=0.1)
    eng = get_solver("engine", **CPU).solve(suite, runs=8, seed=5)
    assert lns.dispatches == eng.dispatches == 1
    assert lns.meta["lns_problems"] == []
    for a, b in zip(lns.energies, eng.energies):
        np.testing.assert_array_equal(a, b)


def test_engine_rejects_big_problems_and_names_chip_lns():
    with pytest.raises(ValueError, match="chip-lns"):
        get_solver("engine", **CPU).solve(Problem.maxcut(70, 0.5), runs=2)


# -- the solve CLI -----------------------------------------------------------

@pytest.mark.parametrize("workload,n,degree", [
    ("random-qubo", 24, None), ("maxcut", 40, None), ("gset", 300, 4.0)])
def test_build_suite_matches_reference(workload, n, degree):
    suite = cli.build_suite(workload, n, 0.5, 3, seed=5, degree=degree)
    ref = r_build_suite(workload, n, 0.5, 3, seed=5, degree=degree)
    assert suite.hashes == ref.hashes


def test_solve_on_cpu_reports_consistent_cuts():
    rep, suite = cli.solve(40, 0.8, 2, 16, seed=3, solver="sb-jax",
                           workload="maxcut", oracle=False, **CPU)
    assert rep.solver == "sb-jax" and rep.dispatches == 1
    for i, p in enumerate(suite):
        W = p.meta["W"]
        cut = float(maxcut_value(torch.as_tensor(W, dtype=torch.float64),
                                 torch.as_tensor(rep.best_sigma[i])))
        assert cut == cut_from_energy(W, float(rep.best_energy[i]))
        assert f"[maxcut #{i}] N=40 cut weight={cut:g}" in \
            cli.cut_lines("maxcut", suite, rep)[i]


def test_cli_main_prints_plan_summary_and_cuts(capsys, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_ORACLE_CACHE", str(tmp_path / "o.json"))
    cli.main(["--solver", "chip-lns", "--workload", "maxcut", "--spins", "48",
              "--problems", "1", "--runs", "8", "--budget", "0.1",
              "--torch-device", "cpu"])
    out = capsys.readouterr().out
    assert "[engine] path=scan" in out and "[chip-lns] 1 problems" in out
    assert "[maxcut #0] N=48 cut weight=" in out
    cli.main(["--list-solvers"])
    listed = capsys.readouterr().out
    for name in ("brute-force", "chip-lns", "engine", "sb-jax"):
        assert name in listed


@pytest.mark.parametrize("argv,dies", [
    (["--mesh-devices", "8"], 8), ([], 1)])
def test_cli_runs_the_fabric(capsys, argv, dies):
    """``--solver fabric-jax`` (with or without ``--mesh-devices``) solves
    and prints the reference's ``[fabric]`` ledger lines."""
    cli.main(["--solver", "fabric-jax", "--workload", "gset", "--spins",
              "130", "--problems", "1", "--runs", "2", "--budget", "0.1",
              "--no-oracle", "--torch-device", "cpu", *argv])
    out = capsys.readouterr().out
    assert (f"[fabric] {dies} dies, 2 colors x 1 sweeps = 2 dispatches, "
            "2 field exchanges") in out
    assert "[fabric]   color 0: peak" in out and "[fabric-jax]" in out
    assert "[gset #0] N=130 cut weight=" in out


@pytest.mark.parametrize("kwargs", [
    {"solver": "ode-jax"},
    {"solver": "ode-jax", "chips": 3, "mismatch_sigma": 0.1,
     "tau_leak_spread": 0.3}])
def test_cli_runs_the_ode_fleet(kwargs):
    rep, suite = cli.solve(12, 0.5, 1, 4, oracle=False, budget=0.1,
                           **{**CPU, **kwargs})
    chips = kwargs.get("chips", 1)
    assert rep.solver == "ode-jax" and rep.dispatches == 1
    assert rep.meta["n_chips"] == chips and rep.runs == 4 * chips
    assert np.asarray(rep.energies[0]).shape == (4 * chips,)
