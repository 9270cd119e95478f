"""The port's classical search tier (sa-jax, pt-jax, tabu-jax, sa-numpy,
tabu) and the oracle's batched tabu-jax tier against the JAX package, on
the CPU.

Tolerances, fixed before the port was written:
  * tabu-jax, with the reference's draws injected: per-restart energies,
    sigmas and ``iters_used`` bitwise equal (every quantity is an integer
    exact in float32, or an index);
  * sa-jax and pt-jax, with the reference's draws injected: per-restart
    energies and sigmas equal, the beta tables within 2 ULP. A restart may
    differ only where an accept decision (a Metropolis flip or a PT swap)
    ties with ``u``: at its first divergent decision the two packages'
    probabilities are within 2 ULP of each other (an ``exp`` / ``pow``
    tie). At most 1% of restarts may differ;
  * with the port's own draws: best energies equal brute force on
    ``problem_set(16, 0.5, 2, seed=3 / 5)``, as ``tests/test_search_jax.py``
    asserts for the reference;
  * sa-numpy and tabu (numpy copies, same seeds): bitwise.

The reference's draws are made here by repeating its ``jax.random`` calls
(the same key splits, in the same order) and carried over as numpy arrays
through ``repro_torch.convert``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
from repro.problems import problem_set
from repro.solvers.pt_jax import beta_ladder as r_beta_ladder
from repro.solvers.pt_jax import parallel_tempering_jax_runs as r_pt
from repro.solvers.sa import simulated_annealing as r_sa_numpy
from repro.solvers.sa_jax import simulated_annealing_jax_runs as r_sa
from repro.solvers.tabu_jax import tabu_search_jax_runs as r_tabu_jax
import repro_torch.api as tapi
import repro_torch.api.oracle as t_oracle
from repro_torch import convert
from repro_torch.solvers import (BRUTE_FORCE_MAX_N, brute_force_ground_state,
                                 parallel_tempering_jax_runs,
                                 simulated_annealing,
                                 simulated_annealing_jax,
                                 simulated_annealing_jax_runs, tabu_search,
                                 tabu_search_jax, tabu_search_jax_runs)
from repro_torch.solvers.pt_jax import beta_ladder, pt_draws
from repro_torch.solvers.sa_jax import sa_betas, sa_draws
from repro_torch.solvers.tabu_jax import tabu_draws
from repro_torch.utils import load_sharded_json_cache, store_sharded_json_cache

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the reference's draws, made by repeating its jax.random calls
# ---------------------------------------------------------------------------

def _pm1(key, shape):
    return jnp.where(jax.random.bernoulli(key, 0.5, shape), 1.0, -1.0)


def _sweep_draws(key, n):
    """``metropolis_sweep``'s draws: a spin order and n uniforms."""
    k_ord, k_u = jax.random.split(key)
    return jax.random.permutation(k_ord, n), jax.random.uniform(k_u, (n,))


def _per_problem_restart(P, R, seed, per_restart):
    keys = jax.random.split(jax.random.PRNGKey(seed), P)
    f = jax.vmap(lambda kp: jax.vmap(per_restart)(jax.random.split(kp, R)))
    return [np.asarray(a) for a in f(keys)]


def ref_sa_draws(P, R, n, T, seed):
    """(s0, order, u) of ``repro.solvers.sa_jax.simulated_annealing_jax_runs``
    for (P, R, n, T, seed)."""
    def per_restart(key):
        k_init, k_run = jax.random.split(key)
        order, u = jax.vmap(lambda k: _sweep_draws(k, n))(
            jax.random.split(k_run, T))
        return _pm1(k_init, (n,)), order, u
    return _per_problem_restart(P, R, seed, per_restart)


def ref_pt_draws(P, R, K, n, T, seed):
    """(s0, order, u, swap_u) of ``repro.solvers.pt_jax``."""
    def per_restart(key):
        k_init, k_run = jax.random.split(key)
        s0 = jax.vmap(lambda k: _pm1(k, (n,)))(jax.random.split(k_init, K))

        def per_step(kk):
            k_sweep, k_swap = jax.random.split(kk)
            order, u = jax.vmap(lambda k: _sweep_draws(k, n))(
                jax.random.split(k_sweep, K))
            return order, u, jax.random.uniform(k_swap, (K,))
        return (s0, *jax.vmap(per_step)(jax.random.split(k_run, T)))
    return _per_problem_restart(P, R, seed, per_restart)


def ref_tabu_draws(P, R, n, n_true, max_iters, seed):
    """(s0, kick) of ``repro.solvers.tabu_jax.tabu_search_jax_runs``."""
    def per_problem(kp, nt):
        def per_restart(key):
            k_init, k_kick = jax.random.split(key)
            kick = jax.vmap(lambda it: jax.random.randint(
                jax.random.fold_in(k_kick, it), (), 0, nt))(
                jnp.arange(max_iters))
            return _pm1(k_init, (n,)), kick
        return jax.vmap(per_restart)(jax.random.split(kp, R))
    keys = jax.random.split(jax.random.PRNGKey(seed), P)
    return [np.asarray(a) for a in jax.vmap(per_problem)(
        keys, jnp.asarray(n_true, jnp.int32))]


def _restarts_differ(ref, port):
    """(P, R) bool: the restart's energy or sigma differs."""
    (ea, sa), (eb, sb) = ref[:2], port[:2]
    return (ea != eb) | (sa != sb).any(axis=-1)


def _ulps(a, b):
    """ULP distance of positive float32 values."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---------------------------------------------------------------------------
# the tie rule: the first decision where the port and the reference part
# ---------------------------------------------------------------------------

class ExpSpy:
    """Records every ``torch.exp`` the port calls (argument and value), in
    call order."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = torch.exp

        def spy(x):
            out = orig(x)
            self.calls.append((x.detach().clone().numpy(),
                               out.detach().clone().numpy()))
            return out
        monkeypatch.setattr(torch, "exp", spy)


def _ref_flip_probability(x_port, neg2beta_port, neg2beta_ref):
    """The reference's accept probability exp(-beta_ref max(dH, 0)) for the
    flip whose port argument was ``x_port`` = (-2 beta_port) max(s_k f_k,
    0): the integer s_k f_k is recovered exactly, then multiplied in
    float32 as the reference multiplies."""
    a = np.rint(x_port.astype(np.float64) / neg2beta_port)
    x_ref = a.astype(np.float32) * np.asarray(neg2beta_ref, np.float32)
    return np.asarray(jnp.exp(jnp.asarray(x_ref, jnp.float32)))


def first_divergences(decisions):
    """``decisions``: per decision in call order, (port_accepts,
    ref_accepts, p_port, p_ref), each (P, R) — or (P, R, m) over a
    restart's m parallel decisions, masked ones equal. Returns {(p, r):
    ULP distance of the two probabilities at the restart's first decision
    where the packages part}."""
    out = {}
    for dp, dr, pp, pr in decisions:
        diff = dp != dr
        ulps = np.where(diff, _ulps(pp, pr), -1)
        if diff.ndim == 3:
            diff, ulps = diff.any(-1), ulps.max(-1)
        for p, r in zip(*np.nonzero(diff)):
            out.setdefault((int(p), int(r)), int(ulps[p, r]))
    return out


def assert_tie_rule(ref, port, first, runs):
    differ = _restarts_differ(ref, port)
    parted = {k for k, ulps in first.items()}
    unexplained = {(int(p), int(r)) for p, r in zip(*np.nonzero(differ))
                   } - parted
    assert not unexplained, f"restarts differ with no divergent decision: " \
                            f"{sorted(unexplained)}"
    assert all(u <= 2 for u in first.values()), \
        f"a first divergence is no tie (ULPs by restart): {first}"
    assert differ.sum() <= 0.01 * runs, f"{differ.sum()} of {runs} differ"


# ---------------------------------------------------------------------------
# tabu-jax: bitwise with the reference's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patience,n_iters", [
    (None, None), (0, None), (None, [300, 520])],
    ids=["kicks", "patience0", "per_problem_n_iters"])
def test_tabu_jax_bitwise_with_reference_draws(patience, n_iters):
    ps = problem_set(16, 0.5, 2, seed=7)
    Jp = np.zeros((2, 48, 48), np.float32)
    Jp[:, :16, :16] = ps.J
    kw = dict(n_true=[16, 16], n_iters=n_iters, n_restarts=16,
              patience=patience)
    ref = r_tabu_jax(Jp, seed=2, **kw)
    max_iters = 640 if n_iters is None else max(n_iters)
    draws = convert.tabu_draws_from_arrays(
        *ref_tabu_draws(2, 16, 48, [16, 16], max_iters, seed=2),
        torch_device=CPU)
    port = tabu_search_jax_runs(Jp, draws=draws, torch_device=CPU, **kw)
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.all(port[1][:, :, 16:] == 1)
    if n_iters is not None:
        assert port[2][0].max() <= 300 < port[2][1].max()


@pytest.mark.parametrize("patience", [0, 6], ids=["latched", "kicked"])
def test_tabu_jax_stall_bitwise_with_reference_draws(patience):
    # tenure >> n: every restart stalls. Without kicks the latched ``done``
    # must stop the port exactly where the reference stops; with them a
    # stall latches nothing and the kicks carry the search on
    J = np.asarray(problem_set(8, 0.9, 1, seed=6).J)
    kw = dict(n_iters=200, n_restarts=8, tenure=10_000, patience=patience,
              kick_len=3)
    ref = r_tabu_jax(J, seed=3, **kw)
    draws = convert.tabu_draws_from_arrays(
        *ref_tabu_draws(1, 8, 8, [8], 200, seed=3), torch_device=CPU)
    port = tabu_search_jax_runs(J, draws=draws, torch_device=CPU, **kw)
    for a, b in zip(ref, port):
        assert np.array_equal(a, b)
    if patience == 0:
        assert np.all(port[2] < 200)
    else:
        assert np.all(port[2] > 20)


# ---------------------------------------------------------------------------
# sa-jax and pt-jax: equal to the tie rule with the reference's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [200, 120, 37, 1000])
def test_beta_tables_within_two_ulp(T):
    ref = np.asarray(0.05 * (4.0 / 0.05) ** (
        jnp.arange(T, dtype=jnp.float32) / max(T - 1, 1)))
    assert _ulps(sa_betas(T, torch_device=CPU).numpy(), ref).max() <= 2
    for K in (2, 4, 8):
        assert _ulps(beta_ladder(K, torch_device=CPU).numpy(),
                     np.asarray(r_beta_ladder(K))).max() <= 2


@pytest.mark.parametrize("seed", [0, 1])
def test_sa_jax_equal_to_the_tie_rule_with_reference_draws(seed,
                                                           monkeypatch):
    J = np.asarray(problem_set(16, 0.5, 2, seed=3).J)
    P, R, n, T = 2, 64, 16, 200
    ref = r_sa(J, n_runs=R, n_sweeps=T, seed=seed)
    s0, order, u = ref_sa_draws(P, R, n, T, seed)
    spy = ExpSpy(monkeypatch)
    port = simulated_annealing_jax_runs(
        J, n_runs=R, n_sweeps=T, draws=convert.sa_draws_from_arrays(
            s0, order, u, torch_device=CPU), torch_device=CPU)
    monkeypatch.undo()
    assert port[0].dtype == np.float64 and port[1].dtype == np.int8
    nb_port = -2.0 * sa_betas(T, torch_device=CPU).numpy().astype(np.float64)
    nb_ref = -2.0 * np.asarray(0.05 * (4.0 / 0.05) ** (
        jnp.arange(T, dtype=jnp.float32) / max(T - 1, 1)))
    assert len(spy.calls) == T * n
    decisions = []
    for c, (x, p_port) in enumerate(spy.calls):
        t, i = divmod(c, n)
        p_ref = _ref_flip_probability(x, nb_port[t], nb_ref[t])
        uc = u[:, :, t, i][..., None]
        decisions.append((uc < p_port, uc < p_ref, p_port, p_ref))
    first = first_divergences([tuple(a[..., 0] for a in d)
                               for d in decisions])
    assert_tie_rule(ref, port, first, P * R)


@pytest.mark.parametrize("swap_every", [1, 3])
def test_pt_jax_equal_to_the_tie_rule_with_reference_draws(swap_every,
                                                          monkeypatch):
    J = np.asarray(problem_set(16, 0.5, 2, seed=5).J)
    P, R, K, n, T = 2, 32, 4, 16, 80
    ref = r_pt(J, n_runs=R, n_sweeps=T, n_rungs=K, swap_every=swap_every,
               seed=4)
    s0, order, u, swap_u = ref_pt_draws(P, R, K, n, T, seed=4)
    spy = ExpSpy(monkeypatch)
    port = parallel_tempering_jax_runs(
        J, n_runs=R, n_sweeps=T, n_rungs=K, swap_every=swap_every,
        draws=convert.pt_draws_from_arrays(s0, order, u, swap_u,
                                           torch_device=CPU),
        torch_device=CPU)
    monkeypatch.undo()
    assert port[2].dtype == np.int64 and np.array_equal(port[2], ref[2])
    b_port = beta_ladder(K, torch_device=CPU).numpy()
    b_ref = np.asarray(r_beta_ladder(K))
    nb_port = np.tile(-2.0 * b_port.astype(np.float64), R)      # walker r*K+k
    nb_ref = np.tile(-2.0 * b_ref, R)
    db_port = b_port - np.roll(b_port, -1)
    db_ref = b_ref - np.roll(b_ref, -1)
    calls = iter(spy.calls)
    decisions = []
    for t in range(T):
        for i in range(n):
            x, p_port = next(calls)
            p_ref = _ref_flip_probability(x, nb_port[:, None],
                                          nb_ref[:, None])
            uc = u[:, :, t, :, i].reshape(P, R * K, 1)
            decisions.append(tuple(
                a.reshape(P, R, K) for a in
                (uc < p_port, uc < p_ref, p_port, p_ref)))
        if (t + 1) % swap_every == 0:
            x, p_port = next(calls)                      # (P, R, K)
            d_e = np.rint(x.astype(np.float64) / db_port)
            p_ref = np.asarray(jnp.exp(jnp.asarray(
                d_e.astype(np.float32) * db_ref, jnp.float32)))
            k = np.arange(K)
            left = (k % 2 == (t // swap_every) % 2) & (k + 1 < K)
            uc = swap_u[:, :, t]
            decisions.append((left & (uc < p_port), left & (uc < p_ref),
                              p_port, p_ref))
    assert next(calls, None) is None
    first = first_divergences(decisions)
    assert_tie_rule(ref, port, first, P * R)


def test_tie_rule_machinery():
    # two restarts, three decisions each: restart 1 parts at the second,
    # where the probabilities are 1 ULP apart; restart 0 never parts
    half = np.float32(0.5)
    up = np.nextafter(half, np.float32(1))
    same = np.array([[True, True]])
    p = np.full((1, 2), half, np.float32)
    q = np.array([[half, up]], np.float32)
    decisions = [(same, same, p, p),
                 (same, np.array([[True, False]]), p, q),
                 (same, ~same, p, p)]
    first = first_divergences(decisions)
    assert first == {(0, 1): 1, (0, 0): 0}
    e = np.zeros((1, 2))
    s = np.ones((1, 2, 3), np.int8)
    assert_tie_rule((e, s), (e + [[0.0, 2.0]], s), {(0, 1): 1}, 100)
    with pytest.raises(AssertionError, match="no divergent decision"):
        assert_tie_rule((e, s), (e + [[2.0, 0.0]], s), {(0, 1): 1}, 100)
    with pytest.raises(AssertionError, match="no tie"):
        assert_tie_rule((e, s), (e + [[0.0, 2.0]], s), {(0, 1): 3}, 100)
    with pytest.raises(AssertionError, match="of 100 differ"):
        assert_tie_rule((e, s), (e + 2.0, s), {(0, 0): 1, (0, 1): 1}, 100)


# ---------------------------------------------------------------------------
# the port's own draws: parity with brute force and the numpy oracle
# ---------------------------------------------------------------------------

def test_tabu_jax_matches_numpy_and_brute_force():
    ps = problem_set(16, 0.5, 2, seed=3)
    for p in range(2):
        J = np.asarray(ps.J[p])
        e_bf, _ = brute_force_ground_state(J)
        e_np, _ = tabu_search(J, n_restarts=16, seed=1)
        e_jx, s_jx = tabu_search_jax(J, n_restarts=16, seed=1,
                                     torch_device=CPU)
        assert e_np == e_jx == pytest.approx(e_bf)
        f = J @ s_jx.astype(np.float64)
        assert -0.5 * float(s_jx @ f) == pytest.approx(e_jx)


def test_tabu_jax_parity_mode_replicates_numpy_semantics():
    J = np.asarray(problem_set(16, 0.5, 1, seed=3).J[0])
    e_bf, _ = brute_force_ground_state(J)
    e, _, _ = tabu_search_jax_runs(J, n_restarts=16, seed=1, patience=0,
                                   torch_device=CPU)
    assert e.min() == pytest.approx(e_bf)


def test_tabu_jax_padded_bucket_is_exact():
    ps = problem_set(16, 0.5, 2, seed=7)
    Jp = np.zeros((2, 48, 48), np.float32)
    for p in range(2):
        Jp[p, :16, :16] = ps.J[p]
    e, s, _ = tabu_search_jax_runs(Jp, n_true=[16, 16], n_restarts=16,
                                   seed=2, torch_device=CPU)
    for p in range(2):
        e_bf, _ = brute_force_ground_state(np.asarray(ps.J[p]))
        assert e[p].min() == pytest.approx(e_bf)
    assert np.all(s[:, :, 16:] == 1)


@pytest.mark.parametrize("solver", ["sa", "pt"])
def test_own_draws_reach_brute_force(solver):
    ps = problem_set(16, 0.5, 2, seed=3 if solver == "sa" else 5)
    if solver == "sa":
        e, s = simulated_annealing_jax_runs(np.asarray(ps.J), n_runs=16,
                                            seed=0, torch_device=CPU)
        best_e, best_s = simulated_annealing_jax(np.asarray(ps.J[1]),
                                                 n_restarts=16, seed=0,
                                                 torch_device=CPU)
        assert best_e == brute_force_ground_state(np.asarray(ps.J[1]))[0]
        assert best_s.shape == (16,) and best_s.dtype == np.int8
    else:
        e, s, swaps = parallel_tempering_jax_runs(
            np.asarray(ps.J), n_runs=8, n_sweeps=80, n_rungs=4, seed=0,
            torch_device=CPU)
        assert swaps.shape == (2, 8) and swaps.sum() > 0
    assert e.shape == (2, s.shape[1]) and s.shape[2] == 16
    for p in range(2):
        e_bf, _ = brute_force_ground_state(np.asarray(ps.J[p]))
        assert e[p].min() == pytest.approx(e_bf)
        k = int(np.argmin(e[p]))
        sig = s[p, k].astype(np.float64)
        assert -0.5 * sig @ np.asarray(ps.J[p], np.float64) @ sig \
            == pytest.approx(e[p, k])


def test_draws_are_per_problem_and_in_range():
    # a problem's draws depend on (seed, p) only, not on the batch
    a = sa_draws(3, 4, 10, 5, seed=9, torch_device=CPU)
    b = sa_draws(1, 4, 10, 5, seed=9, torch_device=CPU)
    assert all(torch.equal(x[:1], y) for x, y in zip(a, b))
    s0, order, u = a
    assert set(s0.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(order.sort(dim=-1).values,
                       torch.arange(10, dtype=torch.int32).expand(3, 4, 5, 10))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    s0, order, u, swap_u = pt_draws(2, 3, 4, 8, 5, seed=1, torch_device=CPU)
    assert order.shape == (2, 3, 5, 4, 8) and swap_u.shape == (2, 3, 5, 4)
    s0, kick = tabu_draws(2, 5, 48, 300, n_true=[16, 48], seed=2,
                          torch_device=CPU)
    assert s0.shape == (2, 5, 48) and kick.dtype == torch.int64
    assert int(kick[0].max()) < 16 and int(kick[1].max()) < 48
    assert int(kick.min()) >= 0
    with pytest.raises(ValueError, match="draw kick"):
        tabu_search_jax_runs(np.zeros((2, 48, 48), np.float32),
                             n_true=[16, 48], n_restarts=5,
                             draws=(s0, kick[:, :, :10]), torch_device=CPU)
    with pytest.raises(ValueError, match="leading"):
        convert.sa_draws_from_arrays(np.ones((2, 3, 4)),
                                     np.zeros((2, 4, 5, 4)),
                                     np.zeros((2, 3, 5, 4)),
                                     torch_device=CPU)


# ---------------------------------------------------------------------------
# determinism and honest iteration accounting
# ---------------------------------------------------------------------------

def test_tabu_jax_seed_determinism():
    J = np.asarray(problem_set(24, 0.5, 2, seed=9).J)
    a = tabu_search_jax_runs(J, n_iters=12, n_restarts=8, seed=4,
                             torch_device=CPU)
    b = tabu_search_jax_runs(J, n_iters=12, n_restarts=8, seed=4,
                             torch_device=CPU)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = tabu_search_jax_runs(J, n_iters=12, n_restarts=8, seed=5,
                             torch_device=CPU)
    assert not np.array_equal(a[0], c[0])


@pytest.mark.parametrize("solver", ["sa", "pt"])
def test_seed_determinism(solver):
    J = np.asarray(problem_set(20, 0.5, 1, seed=2).J)
    if solver == "sa":
        def run(seed):
            return simulated_annealing_jax_runs(J, n_runs=6, n_sweeps=3,
                                                seed=seed, torch_device=CPU)
    else:
        def run(seed):
            return parallel_tempering_jax_runs(J, n_runs=6, n_sweeps=3,
                                               seed=seed, torch_device=CPU)
    a, b, c = run(3), run(3), run(4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])


def test_stalled_restarts_report_truncated_iterations():
    J = np.asarray(problem_set(8, 0.9, 1, seed=6).J[0])
    n_iters = 200
    _, _, used_np = tabu_search(J, n_iters=n_iters, n_restarts=8,
                                tenure=10_000, seed=3, return_all=True,
                                return_iters=True)
    _, _, used_jx = tabu_search_jax_runs(J, n_iters=n_iters, n_restarts=8,
                                         tenure=10_000, seed=3, patience=0,
                                         torch_device=CPU)
    for used in (used_np, used_jx[0]):
        assert np.all(used < n_iters)
        assert np.all(used >= 1)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_tabu_solvers_record_iters_used():
    suite = tapi.ProblemSuite.random(12, 0.5, 2, seed=4)
    for name in ("tabu", "tabu-jax"):
        rep = tapi.get_solver(name, torch_device=CPU).solve(
            suite, runs=4, seed=0, block=16)
        used = rep.meta["iters_used"]
        assert len(used) == 2 and all(len(u) == 4 for u in used)
        assert all(0 < u <= ni for us, ni in zip(used, rep.meta["n_iters"])
                   for u in us)


def test_one_dispatch_per_bucket_on_mixed_suite():
    suite = tapi.ProblemSuite([tapi.Problem.random_qubo(16, 0.5, seed=1),
                               tapi.Problem.random_qubo(64, 0.5, seed=2),
                               tapi.Problem.random_qubo(70, 0.5, seed=3)])
    assert suite.num_dispatches() == 2
    for name in ("tabu-jax", "pt-jax", "sa-jax"):
        rep = tapi.get_solver(name, torch_device=CPU).solve(
            suite, runs=4, seed=0, budget=0.25 if name != "sa-jax" else 0.1)
        assert rep.dispatches == suite.num_dispatches(), name
        assert rep.num_problems == 3 and rep.meta["torch_device"] == CPU
        for i, p in enumerate(suite):
            s = rep.best_sigma[i].astype(np.float64)
            assert s.shape == (p.n,)
            e = -0.5 * s @ p.J_levels.astype(np.float64) @ s
            assert np.isclose(e, rep.best_energy[i]), name


def test_host_solvers_bitwise_with_reference():
    J = problem_set(14, 0.6, 1, seed=5).J[0]
    ra = r_sa_numpy(J, n_sweeps=50, n_restarts=4, seed=9, return_all=True)
    rb = simulated_annealing(J, n_sweeps=50, n_restarts=4, seed=9,
                             return_all=True)
    assert all(np.array_equal(a, b) for a, b in zip(ra, rb))
    kw = dict(n=12, density=0.5, num_problems=2, seed=4)
    for name in ("sa-numpy", "tabu"):
        a = rapi.get_solver(name).solve(rapi.ProblemSuite.random(**kw),
                                        runs=6, seed=3, budget=0.5)
        b = tapi.get_solver(name, torch_device=CPU).solve(
            tapi.ProblemSuite.random(**kw), runs=6, seed=3, budget=0.5)
        assert all(np.array_equal(x, y) for x, y in zip(a.energies,
                                                        b.energies)), name
        assert all(np.array_equal(x, y) for x, y in zip(a.best_sigma,
                                                        b.best_sigma)), name
        assert a.meta.get("iters_used") == b.meta.get("iters_used"), name
    assert a.meta["n_iters"] == b.meta["n_iters"]


def test_budget_scales_iters_not_restarts():
    suite = tapi.ProblemSuite.random(12, 0.5, 1, seed=8)
    sol = tapi.get_solver("tabu-jax", torch_device=CPU)
    full = sol.solve(suite, runs=6, seed=0, block=16)
    half = sol.solve(suite, runs=6, seed=0, budget=0.5, block=16)
    assert half.meta["n_iters"][0] == full.meta["n_iters"][0] // 2
    assert half.runs == full.runs == 6
    assert all(len(e) == 6 for e in half.energies)
    pt = tapi.get_solver("pt-jax", n_sweeps=10, torch_device=CPU).solve(
        suite, runs=3, seed=0, budget=0.5, block=16)
    assert pt.meta["effort"] == {"iters": 5, "restarts": 3, "rungs": 4}
    assert len(pt.meta["swap_acceptances"]) == 1


def test_solver_wrapper_delegates():
    inner = tapi.get_solver("tabu-jax", torch_device=CPU)

    class Counting(tapi.registry.SolverWrapper):
        calls = 0

        def solve(self, suite, **kw):
            Counting.calls += 1
            return super().solve(suite, **kw)

    w = Counting(inner)
    assert w.name == "tabu-jax" and w.caps == inner.caps
    suite = tapi.ProblemSuite.random(8, 0.5, 1, seed=1)
    rep = w.solve(suite, runs=2, seed=0, block=8)
    direct = inner.solve(suite, runs=2, seed=0, block=8)
    assert Counting.calls == 1
    assert np.array_equal(rep.energies[0], direct.energies[0])


# ---------------------------------------------------------------------------
# the oracle: the batched tabu-jax tier and the shared brute-force boundary
# ---------------------------------------------------------------------------

def test_oracle_refresh_is_one_batched_dispatch(tmp_path, monkeypatch):
    path = str(tmp_path / "oracle.json")
    suite = tapi.ProblemSuite([tapi.Problem.random_qubo(n, 0.5, seed=n)
                               for n in (25, 28, 32, 40, 48, 64)])
    calls = []
    orig = t_oracle._tabu_jax_batch

    def counting(J, n_true, seed, torch_device):
        calls.append(np.asarray(J).shape)
        return orig(J, n_true, seed, torch_device)

    with monkeypatch.context() as mp:
        mp.setattr(t_oracle, "_tabu_jax_batch", counting)
        bk = tapi.best_known_energies(suite, path=path, torch_device=CPU)
        assert len(calls) == 1 and calls[0] == (6, 64, 64)
        np.testing.assert_array_equal(
            tapi.best_known_energies(suite, path=path, torch_device=CPU), bk)
        assert len(calls) == 1
    entries = load_sharded_json_cache(path)
    assert set(entries) == set(suite.hashes)
    assert all(e["method"] == "tabu-jax" and
               e["restarts"] == t_oracle.TABU_JAX_ORACLE_RESTARTS
               for e in entries.values())
    rep = tapi.get_solver("tabu-jax", torch_device=CPU).solve(
        suite, runs=16, seed=123)
    assert np.all(bk <= rep.best_energy + 1e-9)


def test_stale_heuristic_entry_inside_exact_tier_is_recomputed(tmp_path):
    path = str(tmp_path / "oracle.json")
    p = tapi.Problem.random_qubo(21, 0.5, seed=9)
    bk = tapi.best_known_energies(tapi.ProblemSuite([p]), path=path,
                                  torch_device=CPU)
    stale = {p.content_hash: {"energy": float(bk[0]) + 30.0,
                              "method": "tabu", "n": 21, "kind": p.kind}}
    store_sharded_json_cache(path, stale)
    out = tapi.best_known_energies(tapi.ProblemSuite([p]), path=path,
                                   torch_device=CPU)
    np.testing.assert_array_equal(out, bk)
    entry = load_sharded_json_cache(path)[p.content_hash]
    assert entry["method"] == "brute_force" and entry["energy"] == bk[0]


def test_host_tabu_entry_of_an_older_cache_stays_valid(tmp_path):
    # the port's cache held host-tabu entries above the exact tier before
    # the batched tier: they are served as they are, and a better tabu-jax
    # refresh replaces one only where its energy is lower
    path = str(tmp_path / "oracle.json")
    p = tapi.Problem.random_qubo(30, 0.5, seed=2)
    fresh = tapi.best_known_energies(p, path=str(tmp_path / "fresh.json"),
                                     torch_device=CPU)
    store_sharded_json_cache(path, {p.content_hash: {
        "energy": float(fresh[0]) + 4.0, "method": "tabu", "n": 30,
        "kind": p.kind}})
    served = tapi.best_known_energies(p, path=path, torch_device=CPU)
    assert served[0] == fresh[0] + 4.0
    again = tapi.best_known_energies(p, path=path, refresh=True,
                                     torch_device=CPU)
    assert again[0] == fresh[0]
    assert load_sharded_json_cache(path)[p.content_hash]["method"] == \
        "tabu-jax"
    t_oracle._store(path, {p.content_hash: {"energy": fresh[0] + 9.0,
                                            "method": "tabu"}})
    assert load_sharded_json_cache(path)[p.content_hash]["energy"] == \
        fresh[0]


def test_brute_force_tier_boundary_is_one_shared_constant(tmp_path):
    from repro_torch.solvers.brute_force import BRUTE_FORCE_MAX_N as const
    from repro.solvers.brute_force import BRUTE_FORCE_MAX_N as ref_const
    assert t_oracle.BRUTE_FORCE_MAX_N == const == BRUTE_FORCE_MAX_N \
        == ref_const
    assert tapi.get_solver("brute-force", torch_device=CPU).caps.max_n == \
        const
    small = tapi.Problem.random_qubo(22, 0.5, seed=1)
    big = tapi.Problem.random_qubo(const + 2, 0.5, seed=1)
    path = str(tmp_path / "o.json")
    tapi.best_known_energies(tapi.ProblemSuite([small, big]), path=path,
                             torch_device=CPU)
    methods = {e["n"]: e["method"]
               for e in load_sharded_json_cache(path).values()}
    assert methods == {22: "brute_force", const + 2: "tabu-jax"}
