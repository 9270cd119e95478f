"""RWKV-6 "Finch" block (the reference's ``models.rwkv6``): data-dependent
per-channel decay, matrix-valued state, token-shift mixing; the chunked
parallel form for whole sequences and the O(1)-state recurrence for
decode.

Recurrence per head (N = head dim; k_t, r_t row-vectors in R^N, v_t in R^N):
    y_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
with w_t = exp(-exp(wraw_t)) in (0,1), wraw = w0 + tanh(x_shift @ A) @ B.

Chunked form (chunk Lc): with cum_t = sum_{s<=t} log w_s (per channel),
    y = (r~ @ k~^T ⊙ strict-lower-mask) v  +  diag-bonus  +  r~ @ S_0
where r~_t = r_t ⊙ exp(cum_{t-1}), k~_j = k_j ⊙ exp(-cum_j); the current
token enters only through the bonus u. wraw is clamped to <= 0.65, so with
Lc = 32 exp(-cum) reaches about e^61: safe in float32 only. So the time
mix runs wholly in float32 on the float32 weights, uncast, whatever
``cfg.dtype`` is (as in the reference); the chunks cross in a plain loop
and the last one is padded with zeros.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..distributed.sharding import batch_axes
from .common import (dense_init, from_local, heads_over_ranks, local_heads,
                     local_shard, logical, process_mesh, rms_norm, shard)

WRAW_CLAMP = 0.65
CHUNK = 32


def init_rwkv_tmix(gen: torch.Generator, d_model: int, head_dim: int = 64,
                   lora_dim: int = 64):
    h = d_model // head_dim

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32)
    return {
        "mu_r": full((d_model,), 0.5), "mu_k": full((d_model,), 0.5),
        "mu_v": full((d_model,), 0.5), "mu_w": full((d_model,), 0.5),
        "mu_g": full((d_model,), 0.5),
        "w0": full((d_model,), -1.0),
        "wA": dense_init(gen, d_model, lora_dim, scale=0.01),
        "wB": dense_init(gen, lora_dim, d_model, scale=0.01),
        "u": full((h, head_dim), 0.0),
        "Wr": dense_init(gen, d_model, d_model),
        "Wk": dense_init(gen, d_model, d_model),
        "Wv": dense_init(gen, d_model, d_model),
        "Wg": dense_init(gen, d_model, d_model),
        "Wo": dense_init(gen, d_model, d_model),
        "ln_w": full((d_model,), 1.0),
    }


def init_rwkv_cmix(gen: torch.Generator, d_model: int, d_ff: int):
    return {
        "mu_k": torch.full((d_model,), 0.5),
        "mu_r": torch.full((d_model,), 0.5),
        "Wk": dense_init(gen, d_model, d_ff),
        "Wv": dense_init(gen, d_ff, d_model),
        "Wr": dense_init(gen, d_model, d_model),
    }


def _shift(x, x_prev):
    """Token shift: the previous state's last token, then all but the
    final token."""
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu[None, None, :]


def _wkv_chunked(r, k, v, logw, u, head_dim: int):
    """r, k, v, logw: (B, S, D); u: (H, N). Returns y (B, S, D) and the
    final state (B, H, N, N)."""
    b, s, d = r.shape
    h = d // head_dim
    lc = min(CHUNK, s)
    nc = -(-s // lc)
    pad = nc * lc - s

    def prep(a):
        return F.pad(a, (0, 0, 0, pad)).reshape(b, nc, lc, h, head_dim)
    rr, kk, vv, lw = prep(r), prep(k), prep(v), prep(logw)
    cum = torch.cumsum(lw, dim=2)                     # (B,nc,Lc,H,N)
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                 device=r.device), diagonal=-1)

    S = torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32,
                    device=r.device)
    ys = []
    for c in range(nc):
        rk, kj, vj, cumk, lwk = rr[:, c], kk[:, c], vv[:, c], cum[:, c], \
            lw[:, c]
        cum_prev = cumk - lwk                         # cum_{t-1}
        r_t = rk * torch.exp(cum_prev)                # decay-adjusted queries
        k_t = kj * torch.exp(-cumk)                   # decay-adjusted keys
        A = torch.einsum("bthn,bjhn->bhtj", r_t, k_t)
        A = torch.where(mask[None, None], A, 0.0)
        y = torch.einsum("bhtj,bjhn->bthn", A, vj)
        # bonus (current token)
        bonus = torch.einsum("bthn,hn,bthn->bth", rk, u, kj)
        y = y + bonus[..., None] * vj
        # inter-chunk
        y = y + torch.einsum("bthn,bhnm->bthm", r_t, S)
        # state: S' = diag(wtot) S + sum_j (k_j * exp(cum_L - cum_j))^T v_j
        wtot = torch.exp(cumk[:, -1])                 # (B,H,N)
        kw = kj * torch.exp(cumk[:, -1, None] - cumk)
        S = S * wtot[..., None] + torch.einsum("bjhn,bjhm->bhnm", kw, vj)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * lc, d)[:, :s]
    return y, S


def _wkv_over_ranks(r, k, v, logw, u, head_dim: int, *, mesh):
    """``_wkv_chunked`` on a mesh of processes: heads are independent, so
    each rank runs the recurrence of its own whole heads
    (``common.local_heads``) of its batch shard."""
    b, s, d = r.shape
    ax = heads_over_ranks(mesh, d // head_dim)
    y, S = _wkv_chunked(*(local_heads(t, mesh, head_dim)
                          for t in (r, k, v, logw)),
                        local_shard(u, mesh, logical(ax, None),
                                    split=batch_axes(mesh)),
                        head_dim)
    return (from_local(y, mesh, logical("batch", None, ax), (b, s, d)),
            from_local(S, mesh, logical("batch", ax, None, None),
                       (b, d // head_dim, head_dim, head_dim)))


def _tmix_inputs(p, x, x_prev):
    xs = _shift(x, x_prev)
    xf, xsf = x.float(), xs.float()
    r = _mix(xf, xsf, p["mu_r"]) @ p["Wr"]
    k = _mix(xf, xsf, p["mu_k"]) @ p["Wk"]
    v = _mix(xf, xsf, p["mu_v"]) @ p["Wv"]
    g = _mix(xf, xsf, p["mu_g"]) @ p["Wg"]
    xw = _mix(xf, xsf, p["mu_w"])
    wraw = p["w0"] + torch.tanh(xw @ p["wA"]) @ p["wB"]
    logw = -torch.exp(torch.clamp(wraw, max=WRAW_CLAMP))  # <= -0 per channel
    return r, k, v, g, logw


def _tmix_out(p, y, g, x_dtype, head_dim: int):
    """Per-head norm, ln_w, the silu(g) gate and Wo; y (B, S, D) float32."""
    b, s, d = y.shape
    ones = torch.ones((head_dim,), dtype=torch.float32, device=y.device)
    y = rms_norm(y.reshape(b, s, d // head_dim, head_dim), ones)
    # whole channels on a mesh of processes: Wo's row-parallel gradient
    # arrives channel-sharded, and 'model' need not divide the heads
    y = shard(y.reshape(b, s, d), "batch", None, None) \
        * p["ln_w"][None, None, :]
    y = y * F.silu(g)
    return (y @ p["Wo"]).to(x_dtype)


def apply_rwkv_tmix(p, x, x_prev=None, head_dim: int = 64):
    """x (B, S, D) -> (y, (last_x, S_final)). float32 internals."""
    b, _, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    r, k, v, g, logw = _tmix_inputs(p, x, x_prev)
    mesh = process_mesh()
    wkv = _wkv_chunked if mesh is None else functools.partial(
        _wkv_over_ranks, mesh=mesh)
    y, S = wkv(r, k, v, logw, p["u"], head_dim)
    return _tmix_out(p, y, g, x.dtype, head_dim), (x[:, -1:], S)


def apply_rwkv_cmix(p, x, x_prev=None):
    """x (B, S, D) -> (y, last_x)."""
    b, _, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    xs = _shift(x, x_prev)
    xf, xsf = x.float(), xs.float()
    k = _mix(xf, xsf, p["mu_k"]) @ p["Wk"]
    r = _mix(xf, xsf, p["mu_r"]) @ p["Wr"]
    out = (torch.square(F.relu(k)) @ p["Wv"]) * torch.sigmoid(r)
    return out.to(x.dtype), x[:, -1:]


def decode_rwkv_tmix(p, x, state, head_dim: int = 64):
    """x (B, 1, D); state {'x': (B, 1, D), 'S': (B, H, N, N)} -> (y, new
    state)."""
    b, _, d = x.shape
    r, k, v, g, logw = _tmix_inputs(p, x, state["x"])
    mesh = process_mesh()
    step = _wkv_step if mesh is None else functools.partial(
        _wkv_step_over_ranks, mesh=mesh)
    y, S_new = step(r, k, v, logw, state["S"], p["u"], head_dim)
    return (_tmix_out(p, y.reshape(b, 1, d), g, x.dtype, head_dim),
            {"x": x, "S": S_new})


def _wkv_step(r, k, v, logw, S, u, head_dim: int):
    """One token of the recurrence: r, k, v, logw (B, 1, H * N), S
    (B, H, N, N) -> (y (B, H, N), new S)."""
    b, _, d = r.shape
    h = d // head_dim
    rh = r.reshape(b, h, head_dim)
    kh = k.reshape(b, h, head_dim)
    vh = v.reshape(b, h, head_dim)
    w = torch.exp(logw.reshape(b, h, head_dim))
    kv = torch.einsum("bhn,bhm->bhnm", kh, vh)
    y = torch.einsum("bhn,bhnm->bhm", rh, S + u[None, :, :, None] * kv)
    return y, S * w[..., None] + kv


def _wkv_step_over_ranks(r, k, v, logw, S, u, head_dim: int, *, mesh):
    """``_wkv_step`` on a mesh of processes, each rank on its own heads."""
    b, _, d = r.shape
    h = d // head_dim
    ax = heads_over_ranks(mesh, h)
    y, S = _wkv_step(*(local_heads(t, mesh, head_dim)
                       for t in (r, k, v, logw)),
                     local_shard(S, mesh, logical("batch", ax, None, None),
                                 split=False),
                     local_shard(u, mesh, logical(ax, None),
                                 split=batch_axes(mesh)),
                     head_dim)
    return (from_local(y, mesh, logical("batch", ax, None), (b, h, head_dim)),
            from_local(S, mesh, logical("batch", ax, None, None),
                       (b, h, head_dim, head_dim)))
