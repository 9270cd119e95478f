"""The port's workload zoo against the JAX package's, on the CPU.

Tolerances, fixed before the port was written:
  * encodings bitwise equal to the reference's for every workload at the
    reference's ``SIZES`` (levels, ``offset``, ``fits_dac``, the native
    instance, ``content_hash``): the generators are numpy copies;
  * the affine identity ``4 f(bits(sigma)) == energy(sigma) + offset``
    exactly, for arbitrary sigma;
  * penalty sufficiency by brute force at ``TINY``: exact;
  * a round trip through EVERY solver the port registers (``sb-jax`` at
    ``dt=0.25``, as the reference tunes it): the identity exactly and a
    feasible decode, all solvers taking part.
"""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hyp_compat import given, settings, st
import repro.workloads as rwl
from repro.api import ProblemSuite as RSuite
from repro.launch.solve import build_suite as r_build_suite
from repro_torch.api import ProblemSuite, get_solver, list_solvers
from repro_torch.launch import solve as cli
from repro_torch.solvers.brute_force import brute_force_ground_state
from repro_torch.workloads import (WORKLOADS, get_workload, list_workloads,
                                   model_energy, spins_to_bits)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"

#: the reference's native sizes for solver round trips (every encoding lands
#: at N <= 24 spins, so brute force takes part)
SIZES = {"mis": 9, "vertex-cover": 9, "coloring": 5, "3sat": 5, "tsp": 4}
#: smaller still for the exhaustive penalty-sufficiency check
TINY = {"mis": 7, "vertex-cover": 7, "coloring": 4, "3sat": 4, "tsp": 3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _native_model(wl, problem, objective):
    """The penalty-free model value a FEASIBLE objective corresponds to."""
    if wl.name == "mis":
        return -objective
    if wl.name == "3sat":
        return len(problem.meta["instance"]["clauses"]) - objective
    return objective            # vertex-cover, coloring, tsp: f == objective


def _native_optimum(wl, problem):
    """Exhaustive solve of the ORIGINAL combinatorial problem (tiny N)."""
    inst = problem.meta["instance"]
    if wl.name in ("mis", "vertex-cover"):
        n = inst["n"]
        feasible = []
        for code in range(1 << n):
            res = wl.verify(problem, [i for i in range(n) if code >> i & 1])
            if res.feasible:
                feasible.append(res.objective)
        return max(feasible) if wl.sense == "max" else min(feasible)
    if wl.name == "coloring":
        return 0.0              # the generator plants a proper coloring
    if wl.name == "3sat":
        return float(len(inst["clauses"]))   # planted satisfiable
    if wl.name == "tsp":
        n = inst["n"]
        return min(wl.verify(problem, [0] + list(perm)).objective
                   for perm in itertools.permutations(range(1, n)))
    raise AssertionError(wl.name)


def test_registry_matches_the_reference():
    assert list_workloads() == rwl.list_workloads() == tuple(sorted(SIZES))
    for name in SIZES:
        assert get_workload(name).sense == rwl.get_workload(name).sense


@pytest.mark.parametrize("name", sorted(SIZES))
def test_encodings_bitwise_equal_to_reference(name):
    wl, ref = get_workload(name), rwl.get_workload(name)
    for size in (TINY[name], SIZES[name]):
        for seed in range(4):
            p = wl.random_problem(size, seed=seed)
            r = ref.random_problem(size, seed=seed)
            assert p.levels.dtype == r.levels.dtype
            assert np.array_equal(p.levels, r.levels)
            assert p.meta == r.meta and p.kind == r.kind == name
            assert p.max_level == r.max_level
            assert p.content_hash == r.content_hash


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=10))
def test_affine_energy_identity_everywhere(seed):
    """model_value(bits) == (energy + offset)/4 for ARBITRARY spins,
    penalties included."""
    rng = np.random.default_rng(seed)
    for name, wl in sorted(WORKLOADS.items()):
        p = wl.random_problem(SIZES[name], seed=seed)
        assert p.meta["qubo_scale"] == 4
        for _ in range(4):
            s = rng.choice([-1, 1], size=p.n)
            s[0] = rng.choice([-1, 1])       # either ancilla gauge
            assert wl.model_value(p, spins_to_bits(s)) == \
                model_energy(p, s), (name, seed)
            assert model_energy(p, s) == rwl.model_energy(
                rwl.get_workload(name).random_problem(SIZES[name],
                                                      seed=seed), s)


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=0, max_value=5))
def test_penalty_weights_sufficient_by_brute_force(seed):
    """No constraint-violating ground states, and the decoded ground-state
    objective is the native optimum."""
    for name, wl in sorted(WORKLOADS.items()):
        p = wl.random_problem(TINY[name], seed=seed)
        e, s = brute_force_ground_state(p.J_levels)
        res = wl.roundtrip(p, s)
        assert res.feasible, (name, seed, res)
        assert res.objective == _native_optimum(wl, p), (name, seed)
        assert _native_model(wl, p, res.objective) == \
            (e + p.meta["offset"]) / p.meta["qubo_scale"], (name, seed)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_roundtrip_through_every_capable_solver(name):
    """encode -> solve -> decode -> verify through the port's registry, for
    every solver whose declared capacity covers the encoded instance."""
    wl = get_workload(name)
    p = wl.random_problem(SIZES[name], seed=2)
    suite = ProblemSuite([p])
    # the reference's per-solver tuning: penalty encodings concentrate
    # sigma_J in a few constraint rows, and bSB's default step (dt=0.5) can
    # stall against that stiffness
    tuned = {"sb-jax": dict(dt=0.25)}
    solved = []
    for sname, caps in list_solvers().items():
        if caps.max_n is not None and p.n > caps.max_n:
            continue
        rep = get_solver(sname, torch_device=CPU,
                         **tuned.get(sname, {})).solve(
            suite, runs=48, seed=5, block=32)
        mv = wl.model_value(p, spins_to_bits(rep.best_sigma[0]))
        assert mv == model_energy(p, rep.best_sigma[0]), sname
        res = wl.roundtrip(p, rep.best_sigma[0])
        assert res.feasible, (name, sname, res)
        assert _native_model(wl, p, res.objective) == mv, (name, sname)
        solved.append(sname)
    assert sorted(solved) == sorted(list_solvers()), solved
    assert {"sa-jax", "pt-jax", "tabu-jax", "sa-numpy", "tabu", "engine",
            "chip-lns", "sb-jax", "brute-force"} <= set(solved)


def test_encoding_dac_fit_flags_and_hard_cap():
    wl = get_workload("mis")
    star = {"n": 14, "edges": [[0, i] for i in range(1, 14)]}
    p = wl.encode(star)
    assert not p.meta["fits_dac"]
    assert abs(p.levels).max() == 2 * 13 - 2
    assert p.content_hash == rwl.get_workload("mis").encode(star).content_hash
    assert wl.random_problem(12, seed=0).meta["fits_dac"]
    huge = {"n": 72, "edges": [[0, i] for i in range(1, 72)]}
    with pytest.raises(ValueError, match="level"):
        wl.encode(huge)


def test_suite_workload_constructor_batches_zoo_instances():
    suite = ProblemSuite.workload("coloring", size=5, num_problems=3, seed=7)
    assert len(suite) == 3
    assert all(p.kind == "coloring" for p in suite)
    assert len({p.content_hash for p in suite}) == 3
    assert suite.num_dispatches() == 1
    ref = RSuite.workload("coloring", size=5, num_problems=3, seed=7)
    assert suite.hashes == ref.hashes


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_build_suite_resolves_zoo_names_like_the_reference(workload):
    suite = cli.build_suite(workload, SIZES[workload], 0.4, 2, seed=3)
    assert suite.hashes == r_build_suite(workload, SIZES[workload], 0.4, 2,
                                         seed=3).hashes


def test_cli_solves_mis_with_tabu_jax_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="",
               REPRO_TORCH_ORACLE_CACHE=str(tmp_path / "o.json"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--workload",
         "mis", "--solver", "tabu-jax", "--spins", "12", "--problems", "2",
         "--runs", "16", "--torch-device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[mis #")]
    assert len(lines) == 2
    assert all("feasible=True" in ln and "(max)" in ln for ln in lines)
    assert "[tabu-jax] 2 problems" in out.stdout


def _star_mis(leaves: int):
    """A MIS instance whose hub's bias reaches level 2 * leaves - 2: the
    largest levels an encoding that fits one 64-spin die can carry."""
    edges = [[0, i] for i in range(1, leaves + 1)]
    edges += [[i, i + 1] for i in range(1, leaves, 2)]
    return get_workload("mis").encode({"n": leaves + 1, "edges": edges})


@pytest.mark.parametrize("name", [*sorted(SIZES), "star"])
def test_bf16_anneal_sums_exact_on_zoo_levels(name):
    """Zoo encodings carry levels past the DAC's 15 (TSP 60 at its SIZES,
    the star 118). The bf16 anneal is bitwise equal to its plain version on
    the card only while each step's ``bf16(q*s) @ J^T`` is exact in f32:
    float64 gives the same product at every step of the default schedule,
    on the bucket the engine runs."""
    from repro_torch.core import DEFAULT_PERTURBATION, DeviceModel
    from repro_torch.core.lfsr import lfsr_voltage_inits
    from repro_torch.core.perturbation import scales_from_cols
    from repro_torch.kernels.ising_anneal import fused_anneal_torch
    p = (_star_mis(60) if name == "star"
         else get_workload(name).random_problem(SIZES[name], seed=2))
    (bucket,) = ProblemSuite([p]).buckets(32 if name != "star" else 64)
    J = torch.as_tensor(bucket.J)
    N = J.shape[-1]
    dev = DeviceModel(compute_dtype="bfloat16")
    v0 = torch.as_tensor(lfsr_voltage_inits(N, 48, seed=3))[None]
    Jt = J.to(torch.bfloat16).float().transpose(-1, -2).contiguous()
    scales = scales_from_cols(torch.arange(dev.n_steps)[:, None],
                              torch.arange(N)[None, :], dev,
                              DEFAULT_PERTURBATION) * float(dev.drive_eff *
                                                            dev.dt)
    v = v0
    for t in range(dev.n_steps):
        sq = (torch.where(v >= dev.threshold, 1.0, -1.0) * scales[t]).to(
            torch.bfloat16).float()
        dv = torch.matmul(sq, Jt)
        assert torch.equal(dv.double(),
                           torch.matmul(sq.double(), Jt.double())), t
        v = torch.clamp(v + dv, 0.0, dev.vdd)
    assert torch.equal(v, fused_anneal_torch(J, v0, dev, DEFAULT_PERTURBATION,
                                             "bfloat16"))
    if name in ("tsp", "star"):
        assert int(np.abs(p.levels).max()) > 15 and not p.meta["fits_dac"]
