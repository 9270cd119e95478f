"""Simulated bifurcation (sb-jax) in the port against the JAX package.

Mirrors ``tests/test_sb_jax.py`` test for test. The same numpy inputs go to
``repro`` (its plain ``sb_reference`` / Pallas kernel in interpret mode) and
to ``repro_torch`` with ``torch_device="cpu"``, where the SB wrapper runs
its plain version. Tolerances, fixed before the port was written:
  * port plain version vs the reference, injected x0/y0: sign readouts
    differ in <= 1% of runs for each variant, best energy per problem
    equal, returned energies exactly -1/2 s'Js of the returned spins, dSB
    |dx_final| <= 1e-5 (aSB / bSB x_final is not asserted elementwise: the
    sums are taken in another order);
  * bitwise: the coupling scale c0, Jc, the float64 energies of the same
    spins, zero pads staying 0.
The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain version.
"""
import numpy as np
import pytest
import torch

from repro.api import Problem as RProblem
from repro.api import ProblemSuite as RSuite
from repro.kernels.sb_kernel import fused_sb_kernel as r_fused_sb_kernel
from repro.kernels.sb_kernel import sb_reference as r_sb_reference
from repro.solvers import simulated_bifurcation_jax_runs as r_sb_runs
from repro.solvers.brute_force import brute_force_ground_state
from repro.solvers.sb_jax import sb_coupling_scale as r_sb_coupling_scale
from repro.solvers.sb_jax import sb_inits as r_sb_inits
from repro_torch.api import Problem, ProblemSuite, get_solver
from repro_torch.convert import sb_inits_from_arrays
from repro_torch.kernels import build
from repro_torch.kernels import sb_kernel as sbk
from repro_torch.solvers import simulated_bifurcation_jax
from repro_torch.solvers.sb_jax import (INIT_AMP, sb_coupling_scale,
                                        sb_inits, sb_scaled_couplings,
                                        simulated_bifurcation_jax_runs)

CPU = {"torch_device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_ising(n, seed, P=1):
    rng = np.random.default_rng(seed)
    J = rng.integers(-7, 8, (P, n, n)).astype(np.float64)
    J = np.round((J + np.swapaxes(J, 1, 2)) / 2)
    for p in range(P):
        np.fill_diagonal(J[p], 0)
    return J


def _energies(J, s):
    s = np.asarray(s, np.float64)
    return -0.5 * np.einsum("pri,pij,prj->pr", s, np.asarray(J, np.float64),
                            s)


def _injected(P, R, n, n_true=None, seed=0):
    """The reference's own sb_inits draws, as numpy and as port tensors."""
    x0, y0 = (np.asarray(a) for a in r_sb_inits(P, R, n, n_true=n_true,
                                                seed=seed))
    return (x0, y0), sb_inits_from_arrays(x0, y0, "cpu")


# -- dynamics reach the ground state -----------------------------------------

@pytest.mark.parametrize("variant", ["bSB", "dSB"])
def test_sb_matches_brute_force_small(variant):
    J = _random_ising(12, seed=7, P=3)
    e, s = simulated_bifurcation_jax_runs(J, variant=variant, n_steps=400,
                                          n_restarts=16, dt=0.5, seed=0,
                                          **CPU)
    assert e.shape == (3, 16) and s.shape == (3, 16, 12)
    assert s.dtype == np.int8 and set(np.unique(s)) <= {-1, 1}
    for p in range(3):
        e_bf, _ = brute_force_ground_state(J[p])
        assert e[p].min() == e_bf, (variant, p)
    # reported energies are exactly the energies of the reported spins
    assert np.array_equal(e, _energies(J, s))


def test_sb_asb_reproduces_the_reference_miss():
    """aSB at dt 0.25: the reference's own result on problem 1 is -82
    where brute force gives -88 (its test_sb_matches_brute_force_small[aSB]
    fails). Fed the reference's inits, the port returns the same energies,
    the miss included: inherited, not a port fault."""
    J = _random_ising(12, seed=7, P=3)
    (x0, y0), (tx0, ty0) = _injected(3, 16, 12, seed=0)
    re, rs = r_sb_runs(J, variant="aSB", n_steps=400, n_restarts=16,
                       dt=0.25, seed=0)
    te, ts = simulated_bifurcation_jax_runs(
        J, variant="aSB", n_steps=400, n_restarts=16, dt=0.25, x0=tx0,
        y0=ty0, **CPU)
    assert np.array_equal(te.min(1), np.asarray(re).min(1))
    assert te[1].min() == -82.0
    assert brute_force_ground_state(J[1])[0] == -88.0
    assert ((ts != np.asarray(rs)).any(-1)).mean() <= 0.01


# -- plain version vs the reference ------------------------------------------

def _maxcut_slice():
    """The dense Max-Cut slice as solve_suite pads it: 4 problems of 48
    spins in a 64-spin bucket, c0 folded in."""
    suite = RSuite([RProblem.maxcut(48, 0.9, seed=606 + i) for i in range(4)])
    (bucket,) = suite.buckets(64)
    n_true = [48] * 4
    c0 = r_sb_coupling_scale(bucket.J, n_true)
    Jc = (bucket.J.astype(np.float64) * c0[:, None, None]).astype(np.float32)
    return bucket.J, Jc, n_true


@pytest.mark.parametrize("variant", sbk.SB_VARIANTS)
def test_plain_version_matches_reference(variant):
    J, Jc, n_true = _maxcut_slice()
    (x0, y0), (tx0, ty0) = _injected(4, 32, 64, n_true=n_true, seed=3)
    ref = np.asarray(r_sb_reference(Jc, x0, y0, variant=variant))
    out = sbk.fused_sb_kernel(torch.as_tensor(Jc), tx0, ty0,
                              variant=variant).numpy()
    s_ref, s_out = np.where(ref >= 0, 1, -1), np.where(out >= 0, 1, -1)
    assert (s_ref != s_out).any(-1).mean() <= 0.01
    assert np.array_equal(_energies(J, s_out).min(1),
                          _energies(J, s_ref).min(1))
    if variant == "dSB":
        assert np.abs(out - ref).max() <= 1e-5
    assert np.all(out[:, :, 48:] == 0)          # zero pads stay exactly 0


@pytest.mark.parametrize("variant", sbk.SB_VARIANTS)
def test_plain_version_matches_reference_kernel_in_interpret_mode(variant):
    """The same check against the Pallas kernel itself (interpret mode, as
    tests/test_sb_jax.py runs it), at a ragged size the reference pads to
    128 lanes and the port does not pad at all."""
    J = _random_ising(24, seed=1, P=2) * 0.01
    rng = np.random.default_rng(2)
    x0 = rng.uniform(-0.1, 0.1, (2, 8, 24)).astype(np.float32)
    y0 = rng.uniform(-0.1, 0.1, (2, 8, 24)).astype(np.float32)
    ref = np.asarray(r_fused_sb_kernel(J, x0, y0, variant=variant,
                                       n_steps=300, block_r=8))
    out = sbk.fused_sb_kernel(torch.as_tensor(J, dtype=torch.float32),
                              torch.as_tensor(x0), torch.as_tensor(y0),
                              variant=variant, n_steps=300).numpy()
    s_ref, s_out = np.where(ref >= 0, 1, -1), np.where(out >= 0, 1, -1)
    assert (s_ref != s_out).any(-1).mean() <= 0.01
    assert np.array_equal(_energies(J, s_out).min(1),
                          _energies(J, s_ref).min(1))
    if variant == "dSB":
        assert np.abs(out - ref).max() <= 1e-5


@pytest.mark.parametrize("variant", sbk.SB_VARIANTS)
def test_solver_runs_match_reference_with_injected_inits(variant):
    """simulated_bifurcation_jax_runs end to end (c0, Jc, kernel, readout,
    float64 energies) on a padded bucket, the reference's inits injected."""
    J, _, n_true = _maxcut_slice()
    (x0, y0), (tx0, ty0) = _injected(4, 16, 64, n_true=n_true, seed=9)
    re, rs = r_sb_runs(J, n_true=n_true, variant=variant, n_steps=400,
                       n_restarts=16, seed=9)
    te, ts = simulated_bifurcation_jax_runs(
        J, n_true=n_true, variant=variant, n_steps=400, n_restarts=16,
        x0=tx0, y0=ty0, **CPU)
    re, rs = np.asarray(re), np.asarray(rs)
    assert te.dtype == np.float64 and ts.dtype == np.int8
    assert (ts != rs).any(-1).mean() <= 0.01
    assert np.array_equal(te.min(1), re.min(1))
    assert np.array_equal(te, _energies(J, ts))     # exact float64 energies
    assert np.all(ts[:, :, 48:] == 1)               # pads read out +1


def test_energies_and_couplings_bitwise():
    """c0 and Jc (float64 numpy on both sides) and the float64 energies of
    the same spins are bitwise equal to the reference's."""
    J = _random_ising(40, seed=5, P=3)
    n_true = [40, 33, 17]
    for p, n in enumerate(n_true):
        J[p, n:, :] = J[p, :, n:] = 0
    c_ref = r_sb_coupling_scale(J, n_true)
    c_out = sb_coupling_scale(J, n_true)
    assert c_out.dtype == np.float64 and np.array_equal(c_out, c_ref)
    # the reference's own expression (src/repro/solvers/sb_jax.py)
    J32 = np.asarray(J, np.float32)
    Jc_ref = (J32.astype(np.float64) * c_ref[:, None, None]).astype(
        np.float32)
    Jc = sb_scaled_couplings(J, n_true)
    assert Jc.dtype == np.float32 and np.array_equal(Jc, Jc_ref)
    # energies of the reference's own spins, recomputed by the port
    re, rs = r_sb_runs(J, n_true=n_true, n_steps=50, n_restarts=8, seed=4)
    s = torch.as_tensor(np.array(rs)).double()
    e = -0.5 * torch.sum(s * torch.matmul(s, torch.as_tensor(J).mT), dim=-1)
    assert np.array_equal(e.numpy(), np.asarray(re))


def test_sb_kernel_rejects_unknown_variant():
    J = torch.zeros(1, 8, 8)
    z = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="variant"):
        sbk.fused_sb_kernel(J, z, z, variant="xSB")
    with pytest.raises(ValueError, match="variant"):
        sbk.sb_reference(J, z, z, variant="xSB")
    with pytest.raises(ValueError, match="variant"):
        simulated_bifurcation_jax_runs(J.numpy(), variant="xSB", **CPU)


# -- padded buckets ----------------------------------------------------------

def test_sb_padded_bucket_is_exact():
    """A 16-spin problem embedded in a 64-pad bucket solves the SAME
    problem: c0 comes from the true size, padded spins stay exactly 0
    through the dynamics and read +1."""
    n = 16
    J = _random_ising(n, seed=4)
    Jpad = np.zeros((1, 64, 64))
    Jpad[:, :n, :n] = J
    e_bf, _ = brute_force_ground_state(J[0])
    e, s = simulated_bifurcation_jax_runs(Jpad, n_true=[n], variant="bSB",
                                          n_steps=400, n_restarts=16, seed=5,
                                          **CPU)
    assert np.all(s[:, :, n:] == 1)
    assert e.min() == e_bf
    assert sb_coupling_scale(Jpad, [n])[0] == sb_coupling_scale(J)[0]
    x0, y0 = sb_inits(1, 16, 64, n_true=[n], seed=5, **CPU)
    x = sbk.sb_reference(torch.as_tensor(Jpad, dtype=torch.float32), x0, y0,
                         variant="dSB")
    assert torch.all(x[:, :, n:] == 0)


def test_sb_coupling_scale_degenerate_problems():
    c0 = sb_coupling_scale(np.zeros((2, 8, 8)), [8, 1])
    assert np.all(c0 == 1.0)                 # all-zero J / single spin: finite
    assert np.array_equal(c0, r_sb_coupling_scale(np.zeros((2, 8, 8)),
                                                  [8, 1]))


def test_sb_inits_per_problem_streams():
    """U(-0.1, 0.1), float32, padded spins zero, and a problem's draws do not
    depend on the other problems of the batch."""
    x3, y3 = sb_inits(3, 8, 20, n_true=[20, 12, 5], seed=11, **CPU)
    x2, y2 = sb_inits(2, 8, 20, seed=11, **CPU)
    assert x3.dtype == torch.float32 and tuple(x3.shape) == (3, 8, 20)
    assert torch.equal(x3[0], x2[0]) and torch.equal(y3[0], y2[0])
    assert torch.equal(x3[1, :, :12], x2[1, :, :12])
    assert torch.all(x3[1, :, 12:] == 0) and torch.all(y3[2, :, 5:] == 0)
    assert float(x2.abs().max()) <= INIT_AMP and float(x2.std()) > 0.04
    other, _ = sb_inits(2, 8, 20, seed=12, **CPU)
    assert not torch.equal(other, x2)


# -- registry metrology ------------------------------------------------------

def test_sb_registry_one_dispatch_per_bucket():
    suite = ProblemSuite([Problem.random_qubo(16, 0.5, seed=1),
                          Problem.random_qubo(40, 0.5, seed=2),
                          Problem.random_qubo(64, 0.5, seed=3),
                          Problem.random_qubo(70, 0.5, seed=4)])
    assert suite.num_dispatches() == 2       # {16,40,64} -> 64; {70} -> 128
    rep = get_solver("sb-jax", n_steps=100, **CPU).solve(suite, runs=8,
                                                         seed=0)
    assert rep.dispatches == suite.num_dispatches()
    assert rep.solver == "sb-jax" and rep.meta["variant"] == "bSB"
    assert get_solver("sb-jax", **CPU).caps.max_n is None
    for i, p in enumerate(suite):
        s = rep.best_sigma[i].astype(np.float64)
        assert s.shape == (p.n,)
        e = -0.5 * s @ p.J_levels.astype(np.float64) @ s
        assert e == rep.best_energy[i]


def test_sb_determinism_same_seed_bit_identical():
    suite = ProblemSuite.random(24, 0.5, 2, seed=11)
    r1 = get_solver("sb-jax", **CPU).solve(suite, runs=8, seed=3)
    r2 = get_solver("sb-jax", **CPU).solve(suite, runs=8, seed=3)
    for a, b in zip(r1.energies, r2.energies):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r1.best_sigma, r2.best_sigma):
        np.testing.assert_array_equal(a, b)
    # another seed gives another solve; at the default 400 steps every
    # restart of this easy suite converges to the same energies whatever the
    # seed, so the seeds are compared on a solve cut to 50 steps
    s3 = get_solver("sb-jax", n_steps=50, **CPU).solve(suite, runs=8, seed=3)
    s4 = get_solver("sb-jax", n_steps=50, **CPU).solve(suite, runs=8, seed=4)
    assert any(not np.array_equal(a, b)
               for a, b in zip(s3.energies, s4.energies))


def test_sb_budget_scales_iters_not_restarts():
    suite = ProblemSuite.random(16, 0.5, 1, seed=6)
    base = get_solver("sb-jax", n_steps=64, **CPU).solve(suite, runs=8,
                                                         seed=0)
    double = get_solver("sb-jax", n_steps=64, **CPU).solve(
        suite, runs=8, seed=0, budget=2.0)
    assert base.meta["effort"]["iters"] == 64
    assert double.meta["effort"]["iters"] == 128
    assert base.meta["effort"]["restarts"] == \
        double.meta["effort"]["restarts"] == 8


def test_sb_warmup_splits_compile_from_wall():
    suite = ProblemSuite.random(16, 0.5, 1, seed=8)
    rep = get_solver("sb-jax", warmup=True, n_steps=64, **CPU).solve(
        suite, runs=8, seed=0)
    assert rep.wall_s > 0 and rep.compile_s >= 0
    rep2 = get_solver("sb-jax", n_steps=64, **CPU).solve(suite, runs=8,
                                                         seed=0)
    for a, b in zip(rep.energies, rep2.energies):    # warmup never reroots
        np.testing.assert_array_equal(a, b)          # the deterministic seed


def test_sb_rejects_bad_variant_at_registry():
    with pytest.raises(ValueError, match="variant"):
        get_solver("sb-jax", variant="zSB", **CPU)


def test_best_of_restarts_view():
    J = _random_ising(12, seed=7, P=3)
    e, s = simulated_bifurcation_jax(J, n_restarts=8, seed=2, **CPU)
    runs_e, _ = simulated_bifurcation_jax_runs(J, n_restarts=8, seed=2, **CPU)
    assert np.array_equal(e, runs_e.min(1)) and s.shape == (3, 12)
    e1, s1 = simulated_bifurcation_jax(J[0], n_restarts=8, seed=2, **CPU)
    assert isinstance(e1, float) and s1.shape == (12,)


# -- the wrapper's rules -----------------------------------------------------

def test_wrapper_rules_on_cpu():
    J = torch.as_tensor(_random_ising(8, seed=1), dtype=torch.float32)
    z = torch.zeros(1, 4, 8)
    sbk.reset_launches()
    sbk.fused_sb_kernel(J, z, z, n_steps=5)
    # the plain version ran: CPU tensors never count as a kernel launch
    assert set(sbk.launches) == {"sb_asb", "sb_bsb", "sb_dsb"}
    assert all(v == 0 for v in sbk.launches.values())
    assert torch.equal(sbk.fused_sb_kernel(J, z, z, n_steps=0), z)
    with pytest.raises(ValueError, match="block_r"):
        sbk.fused_sb_kernel(J, z, z, block_r=0)
    # a tensor that is neither on the CPU nor on CUDA is refused, not
    # quietly moved
    with pytest.raises(ValueError, match="CUDA device"):
        sbk.fused_sb_kernel(J.to("meta"), z.to("meta"), z.to("meta"))
    with pytest.raises(ValueError, match="x0 and y0"):
        simulated_bifurcation_jax_runs(J.numpy(), n_restarts=4, x0=z, **CPU)
    assert sbk.MAX_N == 8192       # Gset-sized graphs beyond 2048 spins


def test_ordered_matvec_is_a_matvec_in_one_fixed_order():
    """Exact against float64 where every sum is an integer, and each output
    equals the left-to-right sum of its rounded products."""
    rng = np.random.default_rng(0)
    d = torch.as_tensor(rng.choice([-1.0, 1.0], (2, 3, 7)),
                        dtype=torch.float32)
    Jt = torch.as_tensor(rng.integers(-15, 16, (2, 7, 5)), dtype=torch.float32)
    assert torch.equal(sbk.ordered_matvec(d, Jt),
                       torch.matmul(d.double(), Jt.double()).float())
    x = torch.as_tensor(rng.standard_normal((1, 1, 9)), dtype=torch.float32)
    Jx = torch.as_tensor(rng.standard_normal((1, 9, 2)), dtype=torch.float32)
    acc = torch.zeros(2)
    for j in range(9):
        acc = acc + x[0, 0, j] * Jx[0, j]
    assert torch.equal(sbk.ordered_matvec(x, Jx)[0, 0], acc)


def test_pump_offsets_follow_the_kernels_float32_order():
    a0, n = 1.0, 400
    got = sbk.pump_offsets(n, a0)
    inv = np.float32(1.0 / n)
    want = [np.float32(a0) - np.float32(a0) * (np.float32(t + 1) * inv)
            for t in range(n)]
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert got[-1] == 0.0


def test_sb_kernel_source_carries_its_notes():
    src = (build.CSRC / sbk.SOURCE).read_text()
    assert "src/repro/kernels/sb_kernel.py:79" in src
    assert "__fmul_rn" in src and "use_fast_math" in src
    assert "atomic" not in src.replace("No atomics", "")
    # the cluster design: spins split over a thread-block cluster, the
    # drive exchanged through distributed shared memory, the launch's
    # cluster checked against what the card can co-schedule
    assert "thread-block clusters along the spins" in src
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "cudaOccupancyMaxActiveClusters" in src
    assert "ld.shared::cluster" in src and "cluster.sync()" in src
    assert "12.8 ms" in src and "25.6 ms" in src     # bound and 2x ceiling


# -- the launch plan (pure Python; the C side checks it) ---------------------

PLAN_SHAPES = [(4, 256, 64), (1, 256, 2048), (3, 100, 37), (2, 50, 300),
               (1, 32, 7000)]

#: clusters of C CTAs (one CTA an SM) that an H100 80GB HBM3 holds at once,
#: by C, as cudaOccupancyMaxActiveClusters reports them (chip_smoke.py
#: prints them): clusters stay within one GPC, so 8 CTAs fit 15 times and
#: 10-16 seven times, not 132 / C. A fake of the card for the plan.
H100_CLUSTER_CAPACITY = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                         8: 15, 9: 9, **{c: 7 for c in range(10, 17)}}


def h100(regime, cluster, threads, smem_bytes):
    return H100_CLUSTER_CAPACITY[cluster]


def h100_plan(P, R, N, block_r=None):
    return sbk.sb_launch_plan(P, R, N, block_r, h100)


def _owners(plan, P, R, N):
    """How many (CTA, thread, tile slot) of the plan own each (problem, run,
    spin): the kernel's mapping, spin = c*S + 4*gs + s and run =
    cy*block_r + pass*rc + 4*gr + q, masked to N and to the cluster's runs."""
    count = np.zeros((P, R, N), np.int64)
    S, rc, br = plan.spins_per_cta, plan.runs_per_pass, plan.block_r
    gs = np.arange(S // 4)
    gr = np.arange(rc // 4)
    for p in range(P):
        for cy in range(-(-R // br)):
            r_begin, r_end = cy * br, min(cy * br + br, R)
            for c0 in range(r_begin, r_end, rc):
                for c in range(plan.cluster):
                    i = (c * S + 4 * gs[:, None] + np.arange(4)).ravel()
                    r = (c0 + 4 * gr[:, None] + np.arange(4)).ravel()
                    i, r = i[i < N], r[r < r_end]
                    np.add.at(count[p], np.ix_(r, i), 1)
    return count


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
@pytest.mark.parametrize("block_r", [None, 4, 16])
def test_launch_plan_covers_every_spin_and_run_once(shape, block_r):
    P, R, N = shape
    plan = h100_plan(P, R, N, block_r)
    assert np.all(_owners(plan, P, R, N) == 1)
    assert plan.smem_bytes <= 232448 and plan.cluster <= 16
    assert plan.threads == (plan.spins_per_cta // 4) * \
        (plan.runs_per_pass // 4) <= sbk.MAX_THREADS
    assert plan.runs_per_pass % 4 == 0
    assert (plan.cluster - 1) * plan.spins_per_cta < N     # no empty CTA
    if plan.regime == "cluster":
        assert plan.spins_per_cta % plan.tile_j == 0
        assert 2 <= plan.stages <= 4
    else:
        assert plan.cluster == 1 and plan.spins_per_cta >= N
    assert plan.ctas == P * -(-R // plan.block_r) * plan.cluster


def test_launch_plan_fills_the_card_in_one_wave_at_gset():
    """At the Gset shape the default plan puts every cluster on the card at
    once. An H100 holds 7 clusters of 10-16 CTAs or 15 of 8 (clusters stay
    within a GPC), so one wave holds at most 112-120 CTAs; 16 clusters of 8
    (128 CTAs) would need two waves and take twice as long."""
    plan = h100_plan(1, 256, 2048)
    assert plan.regime == "cluster" and plan.waves == 1
    assert plan.ctas >= 112
    assert plan.runs_per_pass >= 16          # each Jc^T word feeds >= 16 runs
    # 16 runs a cluster of 8 would make 16 clusters: one more than fit
    assert -(-256 // 16) > H100_CLUSTER_CAPACITY[8]
    # the dense Max-Cut shape keeps Jc^T resident
    assert h100_plan(4, 256, 64).regime == "resident"


def test_launch_plan_follows_the_card_capacity():
    """The plan reads the clusters a card holds at once from ``capacity``:
    with room for every cluster it keeps one wave; where no cluster fits it
    finds no plan."""
    roomy = sbk.sb_launch_plan(1, 256, 2048, None, lambda *a: 1000)
    assert roomy.waves == 1
    with pytest.raises(ValueError, match="no SB launch plan"):
        sbk.sb_launch_plan(1, 256, 2048, None, lambda *a: 0)
    # an explicit block_r is kept as the runs per cluster, in as many waves
    # as it takes
    plan = h100_plan(1, 256, 2048, block_r=8)
    assert plan.block_r == 8 and plan.ctas == 32 * plan.cluster


def test_launch_plan_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="N <= 8192"):
        h100_plan(1, 4, sbk.MAX_N + 1)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="block_r"):
            h100_plan(1, 4, 64, bad)
    with pytest.raises(ValueError, match="P >= 1"):
        h100_plan(0, 4, 64)
    # the largest N has a plan
    assert h100_plan(1, 256, sbk.MAX_N).regime == "cluster"


@pytest.mark.parametrize("shape", [(2, 10, 37), (2, 50, 300)])
def test_panels_are_jc_transposed_per_cta(shape):
    """The wrapper's Jc^T layout: panels[p, c, j, s] = Jc[p, c*S + s, j],
    zero past N, rows whole tiles."""
    P, R, N = shape
    rng = np.random.default_rng(1)
    Jc = torch.as_tensor(rng.standard_normal((P, N, N)), dtype=torch.float32)
    plan = h100_plan(P, R, N)
    panels, rows = sbk._panels(Jc, plan)
    C, S = plan.cluster, plan.spins_per_cta
    assert panels.shape == (P, C, rows, S) and panels.is_contiguous()
    full = panels.permute(0, 1, 3, 2).reshape(P, C * S, rows)
    assert torch.equal(full[:, :N, :N], Jc)
    assert not full[:, N:].any() and not full[:, :, N:].any()
    if plan.regime == "cluster":
        assert rows % plan.tile_j == 0 and rows - N < plan.tile_j


@pytest.mark.parametrize("variant", sbk.SB_VARIANTS)
def test_lifted_limit_matches_reference_at_2100(variant):
    """N = 2100, past the first kernel's 2048: the port (its plain version
    on the CPU) and the reference's sb_reference from the same numpy
    x0 / y0 agree to |dx| <= 1e-5 after 5 steps, with identical signs
    wherever |x| > 1e-3 (the two sum dv in different orders)."""
    from repro_torch.problems import gset_problem
    problem = gset_problem(2100, seed=1209, degree=6.0)
    J = problem.J_levels[None].astype(np.float64)
    Jc = sb_scaled_couplings(J, [problem.n])
    rng = np.random.default_rng(21)
    x0 = rng.uniform(-0.1, 0.1, (1, 4, 2100)).astype(np.float32)
    y0 = rng.uniform(-0.1, 0.1, (1, 4, 2100)).astype(np.float32)
    ref = np.asarray(r_sb_reference(Jc, x0, y0, variant=variant, n_steps=5))
    out = sbk.fused_sb_kernel(torch.as_tensor(Jc), torch.as_tensor(x0),
                              torch.as_tensor(y0), variant=variant,
                              n_steps=5).numpy()
    assert out.shape == ref.shape == (1, 4, 2100)
    assert np.abs(out - ref).max() <= 1e-5
    big = np.abs(ref) > 1e-3
    assert np.array_equal(np.sign(out[big]), np.sign(ref[big]))
