"""The port's counter-based generator (``repro_torch.rng``) and the search
tier's draws on it.

  * Threefry-2x32 against JAX's own implementation and a numpy one written
    here in uint32 / uint64 arithmetic; uniforms, spins, permutations and
    kick indices are pure functions of their key, bit for bit;
  * a permutation's sort keys never tie;
  * the per-sweep draws that the SA, PT and tabu loops make are bitwise the
    whole-stream functions' (``sa_draws``, ``pt_draws``, ``tabu_draws``),
    shown by running each solver both ways;
  * no search solver draws more than one sweep's worth at a time when
    nothing is injected (every ``rng.bits`` call of a solve is recorded);
  * normals: Box–Muller in float32 within ``NORMAL_ULP_BOUND`` of the
    exact value at its float32 inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch import rng as t_rng
from repro_torch.core.annealer import anneal
from repro_torch.core.device_model import DeviceModel
from repro_torch.core.perturbation import NOMINAL
from repro_torch.solvers.pt_jax import parallel_tempering_jax_runs, pt_draws
from repro_torch.solvers.sa_jax import (sa_draws,
                                        simulated_annealing_jax_runs)
from repro_torch.solvers.sb_jax import sb_inits
from repro_torch.solvers.tabu_jax import tabu_draws, tabu_search_jax_runs

CPU = "cpu"
M = np.uint64(0xFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- a numpy Threefry-2x32 (uint64 words masked to 32 bits) ---------------

def np_threefry(k0, k1, x0, x1):
    k0, k1, x0, x1 = (np.asarray(a, np.uint64) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(0x1BD11BDA))
    x0 = (x0 + ks[0]) & M
    x1 = (x1 + ks[1]) & M
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & M
            x1 = (((x1 << np.uint64(r)) | (x1 >> np.uint64(32 - r))) & M) \
                ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & M
    return x0, x1


def np_key(seed, *path):
    k = (np.uint64(seed & 0xFFFFFFFF), np.uint64(seed >> 32))
    for d in path:
        k = np_threefry(k[0], k[1], d & 0xFFFFFFFF, d >> 32)
    return k


def test_threefry_matches_jax_and_numpy():
    import jax.numpy as jnp
    from jax._src import prng
    # the Random123 / JAX known answer
    assert t_rng.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88,
                              0x85A308D3) == (0xC4923A9C, 0x483DF7A0)
    g = np.random.default_rng(3)
    k = g.integers(0, 2**32, 2, dtype=np.uint64)
    x = g.integers(0, 2**32, (2, 64), dtype=np.uint64)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(k, jnp.uint32),
                                         jnp.asarray(x.ravel(), jnp.uint32)))
    y0, y1 = t_rng.threefry2x32(int(k[0]), int(k[1]),
                                torch.as_tensor(x[0].astype(np.int64)),
                                torch.as_tensor(x[1].astype(np.int64)))
    assert np.array_equal(np.concatenate([y0.numpy(), y1.numpy()]),
                          want.astype(np.int64))
    n0, n1 = np_threefry(k[0], k[1], x[0], x[1])
    assert np.array_equal(y0.numpy(), n0.astype(np.int64))
    assert np.array_equal(y1.numpy(), n1.astype(np.int64))


@pytest.mark.parametrize("seed,path", [(0, ()), (7, (3, 1)),
                                       (2**40 + 5, (12345, 2, 9))])
def test_keys_and_draws_are_pure_functions_of_the_key(seed, path):
    assert t_rng.key(seed, *path) == tuple(int(w) for w in
                                           np_key(seed, *path))
    k = t_rng.key(seed, *path)
    idx = t_rng.counters((3, 40), CPU)
    w0, w1 = t_rng.bits(k, 11, idx)
    n0, n1 = np_threefry(np.uint64(k[0]), np.uint64(k[1]), 11,
                         np.arange(120, dtype=np.uint64).reshape(3, 40))
    assert np.array_equal(w0.numpy(), n0.astype(np.int64))
    assert np.array_equal(w1.numpy(), n1.astype(np.int64))
    # the derived draws, recomputed in numpy integer / float32 arithmetic
    u = (n0 >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)
    assert np.array_equal(t_rng.uniform(w0).numpy(), u)
    s = np.where(n1 >> np.uint64(31), 1.0, -1.0).astype(np.float32)
    assert np.array_equal(t_rng.spins(w1).numpy(), s)
    kick = ((n0 >> np.uint64(8)) * np.uint64(37)) >> np.uint64(24)
    assert np.array_equal(t_rng.index(w0, 37).numpy(), kick.astype(np.int64))
    perm = np.argsort((n0 << np.uint64(6)) | np.arange(40, dtype=np.uint64),
                      axis=-1, kind="stable")
    assert np.array_equal(t_rng.permutation(w0).numpy(), perm)
    # and again: the same key gives the same bits
    assert all(torch.equal(a, b) for a, b in
               zip(t_rng.bits(t_rng.key(seed, *path), 11, idx), (w0, w1)))


def test_draw_ranges_and_permutations_never_tie():
    k = t_rng.key(5, 1)
    w0, w1 = t_rng.bits(k, 0, t_rng.counters((64, 3), CPU))
    # equal high bits everywhere: the position still orders them
    p = t_rng.permutation(torch.zeros((4, 9), dtype=torch.int64))
    assert torch.equal(p, torch.arange(9).expand(4, 9))
    p = t_rng.permutation(w0 & 0xF)                # 16 values, many ties
    keys = ((w0 & 0xF) << 2) | torch.arange(3)
    assert all(len(set(row.tolist())) == 3 for row in keys)
    assert torch.equal(p.sort(dim=-1).values, torch.arange(3).expand(64, 3))
    u = t_rng.uniform(w1)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert set(t_rng.spins(w1).unique().tolist()) == {-1.0, 1.0}
    kick = t_rng.index(w0, torch.tensor([[5], [1], [8]]).repeat(22, 1)[:64])
    assert int(kick.min()) >= 0 and int(kick.max()) < 8
    with pytest.raises(ValueError, match="2\\^32"):
        t_rng.counters((1 << 17, 1 << 16), "meta")


def test_normals_within_a_few_ulp_of_float64():
    k = t_rng.key(9, 4)
    w0, w1 = t_rng.bits(k, 3, t_rng.counters((4096,), CPU))
    z = t_rng.normal(w0, w1).numpy()
    u1 = ((w0.numpy() >> 8) + 1) * 2.0 ** -24
    u2 = ((w1.numpy() >> 8) * 2.0 ** -24).astype(np.float32)
    # the exact value at the float32 angle both devices compute (one
    # float32 multiply): log, sqrt, cos and the product are what may differ
    angle = (u2 * np.float32(2 * np.pi)).astype(np.float64)
    ref = np.sqrt(-2.0 * np.log(u1)) * np.cos(angle)
    ulp = np.spacing(np.maximum(np.abs(z), np.abs(ref)).astype(np.float32))
    assert np.max(np.abs(z - ref) / ulp) <= t_rng.NORMAL_ULP_BOUND
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05


# -- the search tier: per-sweep draws == the whole stream -------------------

def _J(P, n, seed):
    g = np.random.default_rng(seed)
    J = g.integers(-15, 16, (P, n, n)).astype(np.float32)
    J = np.triu(J, 1)
    return J + J.transpose(0, 2, 1)


def test_sa_per_sweep_draws_equal_the_whole_stream():
    J = _J(2, 12, 0)
    a = simulated_annealing_jax_runs(J, n_runs=6, n_sweeps=9, seed=4,
                                     torch_device=CPU)
    b = simulated_annealing_jax_runs(J, n_runs=6, n_sweeps=9, seed=4,
                                     draws=sa_draws(2, 6, 12, 9, 4, CPU),
                                     torch_device=CPU)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_pt_per_sweep_draws_equal_the_whole_stream():
    J = _J(2, 10, 1)
    kw = dict(n_runs=3, n_sweeps=7, n_rungs=4, swap_every=2, seed=8,
              torch_device=CPU)
    a = parallel_tempering_jax_runs(J, **kw)
    b = parallel_tempering_jax_runs(J, draws=pt_draws(2, 3, 4, 10, 7, 8,
                                                      CPU), **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_tabu_per_chunk_kicks_equal_the_whole_stream():
    # 3 chunks of n iterations, the last one partial; kicks fire often
    J = _J(2, 8, 2)
    kw = dict(n_true=[8, 6], n_iters=[20, 13], n_restarts=5, patience=2,
              kick_len=2, seed=3, torch_device=CPU)
    a = tabu_search_jax_runs(J, **kw)
    b = tabu_search_jax_runs(J, draws=tabu_draws(2, 5, 8, 20, [8, 6], 3,
                                                 CPU), **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("solver", ["sa", "pt", "tabu"])
def test_no_solver_draws_more_than_a_sweep_at_a_time(solver, monkeypatch):
    P, R, K, n, T = 2, 3, 4, 8, 50
    sizes = []
    bits = t_rng.bits

    def spy(k, step, index):
        out = bits(k, step, index)
        sizes.append(out[0].numel())
        return out
    monkeypatch.setattr(t_rng, "bits", spy)
    for whole in (sa_draws, pt_draws, tabu_draws):
        monkeypatch.setattr(f"{whole.__module__}.{whole.__name__}",
                            lambda *a, **k: pytest.fail("whole stream"))
    J = _J(P, n, 5)
    if solver == "sa":
        simulated_annealing_jax_runs(J, n_runs=R, n_sweeps=T, seed=1,
                                     torch_device=CPU)
        per_sweep = P * R * n
    elif solver == "pt":
        parallel_tempering_jax_runs(J, n_runs=R, n_sweeps=T, n_rungs=K,
                                    seed=1, torch_device=CPU)
        per_sweep = P * R * K * n
    else:
        tabu_search_jax_runs(J, n_iters=T * n, n_restarts=R, seed=1,
                             torch_device=CPU)
        per_sweep = P * R * n                   # n iterations' kicks
    assert len(sizes) > T // 2                  # drawn inside the loop
    assert max(sizes) <= per_sweep


def test_sb_inits_are_scaled_24_bit_uniforms():
    x0, y0 = sb_inits(2, 4, 8, seed=6, torch_device=CPU)
    k = t_rng.keys(6, range(2), 1, ndim=3)
    w0, w1 = t_rng.bits(k, 0, t_rng.counters((1, 4, 8), CPU))
    for x, w in ((x0, w0), (y0, w1)):
        u = (w.numpy() >> 8).astype(np.float32) * np.float32(2.0 ** -24)
        want = u * np.float32(0.2) - np.float32(0.1)
        assert np.array_equal(x.numpy(), want)


def test_engine_noise_is_seeded_counter_based_normals():
    dev = DeviceModel(n_spins=8, anneal_sweeps=0.125, noise_sigma=2.0)
    g = np.random.default_rng(1)
    J = torch.as_tensor(_J(1, 8, 1))
    v0 = torch.as_tensor(g.uniform(0.2, 0.8, (1, 4, 8)).astype(np.float32))
    a = anneal(J, v0, dev, NOMINAL, noise_seed=3)
    # the same run from the same normals, injected
    idx = t_rng.counters((1, 4, 8), CPU)
    k = t_rng.key(3, 1)
    z = torch.stack([t_rng.normal(*t_rng.bits(k, t, idx))
                     for t in range(dev.n_steps)])
    b = anneal(J, v0, dev, NOMINAL, noise=z)
    assert torch.equal(a.v_final, b.v_final)
    c = anneal(J, v0, dev, NOMINAL, noise_seed=4)
    assert not torch.equal(a.v_final, c.v_final)
