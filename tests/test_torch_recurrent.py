"""The port's recurrent layers (``repro_torch.models.mamba2`` and
``rwkv6``) against the JAX package's, on the same numpy inputs and the
reference's own initial weights, carried across as arrays; and the port's
chunked forms against its own sequential recurrences (the reference's
``tests/test_recurrent_layers.py``).

Tolerances, fixed before the port was written:
  * against the reference: ``rtol=1e-4, atol=1e-5`` at s = 7, 32, 70
    (70 pads the last chunk);
  * the reference's own for the port alone: WKV chunked vs sequential and
    the time mix's chunked vs decode 2e-4, Mamba-2 chunked vs decode 5e-4,
    chunk invariance 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as r_mamba2
from repro.models import rwkv6 as r_rwkv6
from repro_torch.models import mamba2, rwkv6

RTOL, ATOL = 1e-4, 1e-5
LENGTHS = [7, 32, 70]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


# -- Mamba-2 -----------------------------------------------------------------

D, HD, DS = 32, 8, 8


@pytest.fixture(scope="module")
def mamba_params():
    r_p = r_mamba2.init_mamba2(jax.random.PRNGKey(1), D, expand=2,
                               head_dim=HD, d_state=DS, conv_kernel=4)
    # a nonzero A_log and D, so every term of the recurrence shows
    rng = np.random.default_rng(0)
    r_p = dict(r_p, A_log=jnp.asarray(rng.normal(size=r_p["A_log"].shape),
                                      jnp.float32),
               D=jnp.asarray(rng.normal(size=r_p["D"].shape), jnp.float32))
    return r_p, _t(r_p)


@pytest.mark.parametrize("s", LENGTHS)
def test_apply_mamba2_matches_reference(mamba_params, s):
    r_p, p = mamba_params
    x = np.random.default_rng(s).normal(size=(2, s, D)).astype(np.float32)
    y, h = mamba2.apply_mamba2(p, torch.as_tensor(x), head_dim=HD,
                               d_state=DS, chunk=32)
    r_y, r_h = r_mamba2.apply_mamba2(r_p, jnp.asarray(x), head_dim=HD,
                                     d_state=DS, chunk=32)
    _close(y, r_y)
    _close(h, r_h)


@pytest.mark.parametrize("s", LENGTHS)
def test_decode_mamba2_matches_reference(mamba_params, s):
    r_p, p = mamba_params
    x = np.random.default_rng(s + 1).normal(size=(2, s, D)).astype(
        np.float32)
    n_heads, conv_dim = 2 * D // HD, 2 * D + 2 * DS
    st = mamba2.init_mamba_state(2, n_heads, HD, DS, conv_dim,
                                 torch_device="cpu")
    r_st = r_mamba2.init_mamba_state(2, n_heads, HD, DS, conv_dim)
    for t in range(s):
        y, st = mamba2.decode_mamba2(p, torch.as_tensor(x[:, t:t + 1]), st,
                                     head_dim=HD, d_state=DS)
        r_y, r_st = r_mamba2.decode_mamba2(r_p, jnp.asarray(x[:, t:t + 1]),
                                           r_st, head_dim=HD, d_state=DS)
        _close(y, r_y)
    _close(st["h"], r_st["h"])
    _close(st["conv"], r_st["conv"])


def test_mamba2_chunked_vs_decode(mamba_params):
    """Chunked SSD == sequential single-token updates (the port alone)."""
    _, p = mamba_params
    s = 21
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(2, s, D)).astype(np.float32))
    y_par, h_final = mamba2.apply_mamba2(p, x, head_dim=HD, d_state=DS,
                                         chunk=8)
    state = mamba2.init_mamba_state(2, 2 * D // HD, HD, DS, 2 * D + 2 * DS,
                                    torch_device="cpu")
    ys = []
    for t in range(s):
        y_t, state = mamba2.decode_mamba2(p, x[:, t:t + 1], state,
                                          head_dim=HD, d_state=DS)
        ys.append(y_t)
    _close(y_par, torch.cat(ys, dim=1), rtol=5e-4, atol=5e-4)
    _close(h_final, state["h"], rtol=5e-4, atol=5e-4)


def test_mamba2_chunk_invariance(mamba_params):
    _, p = mamba_params
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(1, 48, D)).astype(np.float32))
    y8, _ = mamba2.apply_mamba2(p, x, head_dim=HD, d_state=DS, chunk=8)
    for chunk in (16, 48):
        y, _ = mamba2.apply_mamba2(p, x, head_dim=HD, d_state=DS,
                                   chunk=chunk)
        _close(y8, y, rtol=1e-4, atol=1e-4)


def test_mamba2_decay_overflow_is_masked():
    """Above the diagonal exp(cum_t - cum_j) overflows to inf with a fast
    decay; it must be selected away, never multiplied by zero (NaN)."""
    p = _t(r_mamba2.init_mamba2(jax.random.PRNGKey(2), D, head_dim=HD,
                                d_state=DS))
    p["A_log"] = torch.full_like(p["A_log"], 6.0)      # A = -e^6 per step
    p["dt_bias"] = torch.full_like(p["dt_bias"], 3.0)
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(1, 40, D)).astype(np.float32))
    y, h = mamba2.apply_mamba2(p, x, head_dim=HD, d_state=DS, chunk=40)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()


def test_init_mamba2_shapes_match_reference():
    r_p = r_mamba2.init_mamba2(jax.random.PRNGKey(0), D, head_dim=HD,
                               d_state=DS)
    p = mamba2.init_mamba2(torch.Generator().manual_seed(0), D, head_dim=HD,
                           d_state=DS)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in r_p.items()}


# -- RWKV-6 ------------------------------------------------------------------

RD, RN, FF = 24, 8, 40


@pytest.fixture(scope="module")
def rwkv_params():
    r_t = r_rwkv6.init_rwkv_tmix(jax.random.PRNGKey(0), RD, head_dim=RN)
    rng = np.random.default_rng(1)
    # a nonzero bonus u and a data-dependent decay that reaches the clamp
    r_t = dict(r_t, u=jnp.asarray(rng.normal(size=r_t["u"].shape),
                                  jnp.float32),
               wB=jnp.asarray(rng.normal(size=r_t["wB"].shape), jnp.float32),
               w0=jnp.asarray(rng.normal(size=(RD,)), jnp.float32))
    r_c = r_rwkv6.init_rwkv_cmix(jax.random.PRNGKey(1), RD, FF)
    return r_t, _t(r_t), r_c, _t(r_c)


@pytest.mark.parametrize("s", LENGTHS)
def test_rwkv_tmix_and_cmix_match_reference(rwkv_params, s):
    r_t, t, r_c, c = rwkv_params
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, RD)).astype(np.float32)
    xp = rng.normal(size=(2, 1, RD)).astype(np.float32)
    for prev in (None, xp):
        tp = None if prev is None else torch.as_tensor(prev)
        jp = None if prev is None else jnp.asarray(prev)
        y, (last, S) = rwkv6.apply_rwkv_tmix(t, torch.as_tensor(x), tp,
                                             head_dim=RN)
        r_y, (r_last, r_S) = r_rwkv6.apply_rwkv_tmix(r_t, jnp.asarray(x), jp,
                                                     head_dim=RN)
        _close(y, r_y)
        _close(S, r_S)
        np.testing.assert_array_equal(last.numpy(), np.asarray(r_last))
        y, last = rwkv6.apply_rwkv_cmix(c, torch.as_tensor(x), tp)
        r_y, r_last = r_rwkv6.apply_rwkv_cmix(r_c, jnp.asarray(x), jp)
        _close(y, r_y)
        np.testing.assert_array_equal(last.numpy(), np.asarray(r_last))


@pytest.mark.parametrize("s", LENGTHS)
def test_decode_rwkv_tmix_matches_reference(rwkv_params, s):
    r_t, t, _, _ = rwkv_params
    x = np.random.default_rng(s + 2).normal(size=(2, s, RD)).astype(
        np.float32)
    st = {"x": torch.zeros((2, 1, RD)), "S": torch.zeros((2, RD // RN, RN,
                                                          RN))}
    r_st = {"x": jnp.zeros((2, 1, RD)), "S": jnp.zeros((2, RD // RN, RN,
                                                        RN))}
    for i in range(s):
        y, st = rwkv6.decode_rwkv_tmix(t, torch.as_tensor(x[:, i:i + 1]), st,
                                       head_dim=RN)
        r_y, r_st = r_rwkv6.decode_rwkv_tmix(r_t, jnp.asarray(x[:, i:i + 1]),
                                             r_st, head_dim=RN)
        _close(y, r_y)
    _close(st["S"], r_st["S"])


def _wkv_sequential(r, k, v, logw, u, head_dim):
    b, s, d = r.shape
    h = d // head_dim
    rr, kk, vv = (a.reshape(b, s, h, head_dim) for a in (r, k, v))
    ww = np.exp(logw).reshape(b, s, h, head_dim)
    S = np.zeros((b, h, head_dim, head_dim))
    ys = np.zeros((b, s, h, head_dim))
    for t in range(s):
        kvt = np.einsum("bhn,bhm->bhnm", kk[:, t], vv[:, t])
        ys[:, t] = np.einsum("bhn,bhnm->bhm", rr[:, t],
                             S + u[None, :, :, None] * kvt)
        S = S * ww[:, t][..., None] + kvt
    return ys.reshape(b, s, d), S


@pytest.mark.parametrize("s", LENGTHS)
def test_wkv_chunked_vs_sequential(s):
    rng = np.random.default_rng(s)
    b, h, n = 2, 3, 8
    d = h * n
    r, k, v = (rng.normal(size=(b, s, d)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.normal(size=(b, s, d)).clip(-3, 0.65)).astype(
        np.float32)
    u = rng.normal(size=(h, n)).astype(np.float32)
    y, S = rwkv6._wkv_chunked(*(torch.as_tensor(a) for a in (r, k, v, logw,
                                                             u)), n)
    y_ref, S_ref = _wkv_sequential(r, k, v, logw, u, n)
    _close(y, y_ref, rtol=2e-4, atol=2e-4)
    _close(S, S_ref, rtol=2e-4, atol=2e-4)


def test_rwkv_tmix_decode_consistency(rwkv_params):
    """Chunked path == token-by-token decode (the port alone)."""
    _, t, _, _ = rwkv_params
    s = 39
    x = torch.as_tensor(np.random.default_rng(6).normal(
        size=(1, s, RD)).astype(np.float32))
    y_par, (_, S_par) = rwkv6.apply_rwkv_tmix(t, x, head_dim=RN)
    state = {"x": torch.zeros((1, 1, RD)),
             "S": torch.zeros((1, RD // RN, RN, RN))}
    ys = []
    for i in range(s):
        y_t, state = rwkv6.decode_rwkv_tmix(t, x[:, i:i + 1], state,
                                            head_dim=RN)
        ys.append(y_t)
    _close(y_par, torch.cat(ys, dim=1), rtol=2e-4, atol=2e-4)
    _close(S_par, state["S"], rtol=2e-4, atol=2e-4)


def test_rwkv_tmix_stays_float32_under_bfloat16():
    """The time mix's internals run in float32 on float32 weights; only
    its output takes the input's dtype."""
    t = rwkv6.init_rwkv_tmix(torch.Generator().manual_seed(0), RD,
                             head_dim=RN)
    x = torch.as_tensor(np.random.default_rng(7).normal(
        size=(1, 40, RD)).astype(np.float32))
    y32, (_, S32) = rwkv6.apply_rwkv_tmix(t, x, head_dim=RN)
    y16, (_, S16) = rwkv6.apply_rwkv_tmix(t, x.bfloat16(), head_dim=RN)
    assert y16.dtype == torch.bfloat16 and S16.dtype == torch.float32
    _close(y16.float(), y32, rtol=2e-2, atol=2e-2)


def test_init_rwkv_shapes_match_reference():
    pairs = [(r_rwkv6.init_rwkv_tmix(jax.random.PRNGKey(0), RD, head_dim=RN),
              rwkv6.init_rwkv_tmix(torch.Generator().manual_seed(0), RD,
                                   head_dim=RN)),
             (r_rwkv6.init_rwkv_cmix(jax.random.PRNGKey(0), RD, FF),
              rwkv6.init_rwkv_cmix(torch.Generator().manual_seed(0), RD,
                                   FF))]
    for r_p, p in pairs:
        assert {k: tuple(v.shape) for k, v in p.items()} == \
            {k: v.shape for k, v in r_p.items()}
