"""The port's top-k routed MoE (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the same numpy inputs and weights
(the reference's ``init_moe`` draws, carried across as arrays).

Tolerances, fixed before the port was written:
  * exact: the routing (expert per sorted slot, keep mask, ``dest``) and
    the dispatched (E, cap) slot buffer, which copies tokens;
  * ``rtol=1e-4, atol=1e-5``: the layer's output;
  * the reference's own 1e-4 for the per-token oracle (no drops) and
    1e-6 for batch locality.
The gradient test of ``tests/test_moe.py`` is training and waits for the
training slice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as r_common
from repro.models.moe import apply_moe as r_apply_moe
from repro.models.moe import init_moe as r_init_moe
from repro_torch.models import moe

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed, d, f, e):
    r_p = r_init_moe(jax.random.PRNGKey(seed), d, f, e)
    return r_p, {k: torch.as_tensor(np.array(v)) for k, v in r_p.items()}


def _reference(r_p, x, top_k, cf, monkeypatch):
    """The reference's output with its routing, read by spies on what
    ``_moe_compute`` calls: ``shard`` sees the sorted experts and the
    dispatched buffer; the ``jnp.where`` over a bool (B, S*k) mask is the
    one that makes ``dest``."""
    seen, wheres = [], []
    real_shard, real_where = r_common.shard, jnp.where

    def shard(t, *axes):
        seen.append(np.asarray(t))
        return real_shard(t, *axes)

    def where(c, *a):
        out = real_where(c, *a)
        wheres.append((np.asarray(c), np.asarray(out)))
        return out
    monkeypatch.setattr(r_common, "shard", shard)
    monkeypatch.setattr(jnp, "where", where)
    out = np.asarray(r_apply_moe(r_p, jnp.asarray(x), top_k=top_k,
                                 capacity_factor=cf))
    monkeypatch.undo()
    b, s, _ = x.shape
    keep, dest = next((c, o) for c, o in wheres
                      if c.dtype == bool and c.shape == (b, s * top_k))
    return out, {"se": seen[0], "xe": seen[1], "keep": keep, "dest": dest}


def _port_routing(p, x, top_k, cf):
    xt = torch.as_tensor(x)
    e = p["router"].shape[-1]
    cap = moe.capacity(x.shape[1], top_k, e, cf)
    r = moe.route(p["router"], xt, top_k=top_k, cap=cap)
    b, _, d = x.shape
    xe = torch.zeros((b, e * cap, d)).scatter_add_(
        1, r["dest"][..., None].expand(-1, -1, d),
        torch.where(r["keep"][..., None],
                    torch.gather(xt, 1, r["st"][..., None].expand(-1, -1, d)),
                    0.0)).reshape(b, e, cap, d)
    return r, xe, cap


def _check_against_reference(r_p, p, x, top_k, cf, monkeypatch):
    ref, r_route = _reference(r_p, x, top_k, cf, monkeypatch)
    r, xe, cap = _port_routing(p, x, top_k, cf)
    np.testing.assert_array_equal(r["se"].numpy(), r_route["se"])
    np.testing.assert_array_equal(r["keep"].numpy(), r_route["keep"])
    np.testing.assert_array_equal(r["dest"].numpy(), r_route["dest"])
    np.testing.assert_array_equal(xe.numpy(), r_route["xe"])
    with torch.no_grad():
        out = moe.apply_moe(p, torch.as_tensor(x), top_k=top_k,
                            capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    return r, cap


@pytest.mark.parametrize("seed,b,s,d,f,e,k,cf", [
    (0, 2, 8, 16, 32, 4, 2, 1.25),
    (1, 2, 20, 32, 24, 8, 2, 1.25),
    (2, 3, 13, 16, 16, 6, 3, 1.0),
    (3, 1, 1, 16, 32, 8, 2, 1.25),        # a decode step: cap == top_k
    (4, 2, 33, 24, 40, 5, 1, 2.0),
])
def test_apply_moe_matches_reference(seed, b, s, d, f, e, k, cf,
                                     monkeypatch):
    r_p, p = _params(seed, d, f, e)
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    r, cap = _check_against_reference(r_p, p, x, k, cf, monkeypatch)
    if s == 1:
        assert cap == k and bool(r["keep"].all())


def test_capacity_rounds_half_to_even():
    # s*k/e*cf = 2.5 and 3.5: Python's round goes to 2 and 4
    assert moe.capacity(4, 1, 2, 1.25) == 2
    assert moe.capacity(4, 1, 2, 1.75) == 4
    assert moe.capacity(1, 8, 64, 1.25) == 8      # decode: cap == top_k
    assert moe.capacity(3, 2, 2, 8.0) == 6        # capped at s * k


def test_capacity_drops_tokens(monkeypatch):
    d, f, e, k = 16, 32, 4, 2
    r_p, p = _params(0, d, f, e)
    x = np.random.default_rng(5).normal(size=(1, 32, d)).astype(np.float32)
    r, _ = _check_against_reference(r_p, p, x, k, 0.5, monkeypatch)
    assert not bool(r["keep"].all())
    with torch.no_grad():
        full = moe.apply_moe(p, torch.as_tensor(x), top_k=k,
                             capacity_factor=float(e)).numpy()
        tight = moe.apply_moe(p, torch.as_tensor(x), top_k=k,
                              capacity_factor=0.5).numpy()
    assert not np.allclose(full, tight)
    assert np.abs(tight).max() <= np.abs(full).max() * 2


@pytest.mark.parametrize("case", ["zero_router", "duplicate_columns"])
def test_top_k_ties_go_to_the_lower_expert(case, monkeypatch):
    d, f, e, k = 16, 24, 6, 2
    r_p, _ = _params(7, d, f, e)
    router = np.asarray(r_p["router"]).copy()
    if case == "zero_router":
        router[:] = 0.0                       # every gate 1/E: experts 0, 1
    else:
        router[:, 4] = router[:, 1]           # experts 1 and 4 tie always
        router[:, 5] = router[:, 2]
    r_p = dict(r_p, router=jnp.asarray(router))
    p = {key: torch.as_tensor(np.array(v)) for key, v in r_p.items()}
    x = np.random.default_rng(8).normal(size=(2, 12, d)).astype(np.float32)
    r, _ = _check_against_reference(r_p, p, x, k, 1.25, monkeypatch)
    if case == "zero_router":
        assert np.all(r["idx"].numpy() == [0, 1])
    gates = np.random.default_rng(9).integers(0, 3, (64, 8)).astype(
        np.float32)
    w, i = moe.top_k_gates(torch.as_tensor(gates), 3)
    r_w, r_i = jax.lax.top_k(jnp.asarray(gates), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(r_i))
    np.testing.assert_array_equal(w.numpy(), np.asarray(r_w))


def _oracle(p, x, top_k):
    """Per-token dense evaluation of the same top-k mixture (no capacity)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    g = torch.softmax(xf @ p["router"], -1)
    w, idx = moe.top_k_gates(g, top_k)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(top_k):
            e = int(idx[t, j])
            hi = xf[t] @ p["wi"][e]
            hg = xf[t] @ p["wg"][e]
            out[t] += w[t, j] * ((torch.nn.functional.silu(hg) * hi)
                                 @ p["wo"][e])
    return out.reshape(b, s, d)


@pytest.mark.parametrize("seed", range(5))
def test_moe_matches_oracle_no_drops(seed):
    d, f, e, k = 16, 32, 4, 2
    _, p = _params(seed, d, f, e)
    x = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(2, 8, d)).astype(np.float32))
    with torch.no_grad():
        out = moe.apply_moe(p, x, top_k=k, capacity_factor=float(e))
        ref = _oracle(p, x, k)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_moe_batch_locality():
    """Row b's output depends only on row b (dispatch never crosses the
    batch)."""
    d, f, e, k = 16, 32, 4, 2
    _, p = _params(1, d, f, e)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    x2 = x.copy()
    x2[1] = rng.normal(size=(8, d))
    with torch.no_grad():
        out = moe.apply_moe(p, torch.as_tensor(x), top_k=k,
                            capacity_factor=1.0).numpy()
        out2 = moe.apply_moe(p, torch.as_tensor(x2), top_k=k,
                             capacity_factor=1.0).numpy()
    np.testing.assert_allclose(out[0], out2[0], rtol=1e-6)
    assert not np.allclose(out[1], out2[1])


def test_init_moe_shapes_match_reference():
    r_p = r_init_moe(jax.random.PRNGKey(0), 16, 24, 5)
    p = moe.init_moe(torch.Generator().manual_seed(0), 16, 24, 5)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in r_p.items()}
    assert all(v.dtype == torch.float32 for v in p.values())

