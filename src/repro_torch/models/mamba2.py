"""Mamba-2 (SSD) block, chunked parallel scan (the reference's
``models.mamba2``).

Per head h (scalar decay a_t = exp(dt_t * A_h), A_h < 0):
    h_t = a_t * h_{t-1} + dt_t * x_t (outer) B_t        state (dh, ds)
    y_t = h_t @ C_t + D_h * x_t
Chunked form (chunk length Lc): within a chunk the pairwise decay matrix
M_tj = exp(cum_t - cum_j) is a (Lc, Lc) scalar-per-head matrix masked to
j <= t, so the intra-chunk part is one masked product per head; the state
crosses chunks in a plain loop (the reference's ``lax.scan``). The last
chunk is padded with zeros. Everything after the input projection runs in
float32, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed.sharding import batch_axes
from .common import (MODEL_AXIS, dense_init, from_local, local_shard,
                     logical, model_axes, model_rank, model_ranges, own_part,
                     own_range, process_mesh, psum, recut, rms_norm,
                     shard_axes, spec, whole)


def init_mamba2(gen: torch.Generator, d_model: int, *, expand: int = 2,
                head_dim: int = 64, d_state: int = 64, conv_kernel: int = 4):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32)
    return {
        # order: [z (d_inner) | xBC (conv_dim) | dt (n_heads)]
        "in_proj": dense_init(gen, d_model, d_inner + conv_dim + n_heads),
        "conv_w": torch.randn((conv_kernel, conv_dim), generator=gen,
                              dtype=torch.float32)
        * (conv_kernel ** -0.5),
        "conv_b": full((conv_dim,), 0.0),
        "A_log": full((n_heads,), 0.0),          # A = -exp(A_log) = -1
        "D": full((n_heads,), 1.0),
        "dt_bias": full((n_heads,), -2.0),       # softplus ~ 0.12
        "norm_w": full((d_inner,), 1.0),
        "out_proj": dense_init(gen, d_inner, d_model),
    }


def _split_proj(proj, d_inner, d_state):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * (d_inner + d_state)]
    dt = proj[..., 2 * (d_inner + d_state):]
    return z, dt, xbc


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, kernel K: (B, S, C) -> (B, S, C), as K
    shifted multiply-adds in the reference's order (no cuDNN)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def apply_mamba2(p, x, *, head_dim: int = 64, d_state: int = 64,
                 chunk: int = 128):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, final state (B, H, dh, ds)
    float32).

    On a mesh of processes each rank runs it on its own batch rows and its
    own whole heads (``own_range``; zamba2-7b's 112 on 16 ranks: 7 each).
    in_proj's columns lie [z | x B C | dt] and 'model' splits them without
    regard to heads, so each rank gathers the weight (at full width 13 MB
    a rank, where the activations it would exchange are tokens x 14576)
    and multiplies its own rows by its heads' z, x and dt columns and the
    shared B and C. The conv, the scan and the gated norm (whose mean over
    d_inner adds the heads' sums over 'model') run on those heads;
    out_proj's rows are the heads', its partial sums all-reduced. A
    weight's gradient is the rank's own tokens against its own columns,
    summed over the model group and the batch axes."""
    mesh = process_mesh()
    btype = x.dtype
    b, s, d = x.shape
    d_inner = p["norm_w"].shape[0]
    n_heads = p["A_log"].shape[0]
    h0, h1 = own_range(n_heads, mesh)
    hm = model_axes(mesh) if h1 - h0 < n_heads else ()
    bm = batch_axes(mesh) + hm          # the axes whose ranks split the work
    rows = logical("batch", None, None)
    n = (h1 - h0) * head_dim

    def cols(o, w=head_dim):
        """The columns of this rank's heads in a block of ``w`` a head
        that starts at column ``o``."""
        return slice(o + h0 * w, o + h1 * w)

    def own(t, *parts):
        """t's last-dimension ``parts`` (t itself with every head)."""
        if (h0, h1) == (0, n_heads):
            return t
        return torch.cat([t[..., c] for c in parts], dim=-1)

    def heads(t):
        return own_part(t, mesh, 0, h0, h1, bm)
    bc = slice(2 * d_inner, 2 * (d_inner + d_state))       # in_proj's B, C
    conv_bc = slice(d_inner, d_inner + 2 * d_state)        # the conv's
    w = own(whole(p["in_proj"], mesh, bm), cols(0), cols(d_inner), bc,
            cols(bc.stop, 1))
    proj = local_shard(x, mesh, rows, split=hm) @ w.to(btype)
    z, dt_raw, xbc = _split_proj(proj, n, d_state)
    xbc = _causal_conv(
        xbc.float(), own(whole(p["conv_w"], mesh, bm), cols(0), conv_bc),
        own(whole(p["conv_b"], mesh, bm), cols(0), conv_bc))
    x_in = xbc[..., :n]
    B = xbc[..., n:n + d_state]
    C = xbc[..., n + d_state:]

    dt = _softplus(dt_raw.float() + heads(p["dt_bias"]))           # (B,S,H)
    A = -torch.exp(heads(p["A_log"]))                              # (H,)
    loga = dt * A[None, None, :]                                   # <= 0
    y, h = _ssd(x_in, B, C, dt, loga, heads(p["D"]), head_dim=head_dim,
                chunk=chunk)
    y = y.reshape(y.shape[0], s, n)
    # gated RMSNorm + out proj
    y = rms_norm(y * F.silu(z.float()), own(whole(p["norm_w"], mesh, bm),
                                            cols(0)), mesh=mesh, axes=hm,
                 n=d_inner)
    wo = own_part(p["out_proj"], mesh, 0, h0 * head_dim, h1 * head_dim, bm)
    y = psum(y.to(btype) @ wo.to(btype), mesh, hm)
    return (from_local(y, mesh, rows, (b, s, d)),
            from_local(h, mesh, logical("batch", "model" if hm else None,
                                        None, None),
                       (b, n_heads, head_dim, d_state)))


def _ssd(x_in, B, C, dt, loga, D, *, head_dim: int, chunk: int):
    """The chunked scan of x_in (B, S, H * dh) with B, C (B, S, ds) and dt,
    loga (B, S, H): (y (B, S, H, dh) with the D skip, final state
    (B, H, dh, ds))."""
    bsz, s, _ = x_in.shape
    n_heads = dt.shape[-1]
    d_state = B.shape[-1]
    lc = min(chunk, s)
    nc = -(-s // lc)
    pad = nc * lc - s

    def cpad(a):
        return F.pad(a, (0, 0, 0, pad))
    xh = cpad(x_in).reshape(bsz, nc, lc, n_heads, head_dim)
    Bc = cpad(B).reshape(bsz, nc, lc, d_state)
    Cc = cpad(C).reshape(bsz, nc, lc, d_state)
    dtc = cpad(dt).reshape(bsz, nc, lc, n_heads)
    cum = torch.cumsum(cpad(loga).reshape(bsz, nc, lc, n_heads), dim=2)
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                 device=x_in.device))

    h = torch.zeros((bsz, n_heads, head_dim, d_state), dtype=torch.float32,
                    device=x_in.device)
    ys = []
    for c in range(nc):
        xk, Bk, Ck, dtk, cumk = (xh[:, c], Bc[:, c], Cc[:, c], dtc[:, c],
                                 cum[:, c])
        # intra-chunk: S_tj = (C_t . B_j) * exp(cum_t - cum_j) * dt_j, j<=t;
        # above the diagonal the exponent is positive and may overflow to
        # inf, so it is masked by selection (inf * 0 would be NaN)
        CB = torch.einsum("bts,bjs->btj", Ck, Bk)                 # (B,Lc,Lc)
        M = torch.exp(cumk[:, :, None, :] - cumk[:, None, :, :])  # (B,t,j,H)
        M = torch.where(mask[None, :, :, None], M, 0.0)
        S = CB[..., None] * M * dtk[:, None, :, :]
        y_intra = torch.einsum("btjh,bjhd->bthd", S, xk)
        # inter-chunk: y_t += exp(cum_t) * C_t @ h
        y_inter = torch.einsum("bts,bhds,bth->bthd", Ck, h, torch.exp(cumk))
        # state: h' = exp(cum_L) h + sum_j exp(cum_L - cum_j) dt_j x_j B_j
        decay_tot = torch.exp(cumk[:, -1, :])                      # (B,H)
        w_j = torch.exp(cumk[:, -1, None, :] - cumk) * dtk         # (B,Lc,H)
        dB = torch.einsum("bjh,bjhd,bjs->bhds", w_j, xk, Bk)
        h = h * decay_tot[..., None, None] + dB
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * lc, n_heads, head_dim)[:, :s]
    y = y + D[None, None, :, None] * xh.reshape(
        bsz, nc * lc, n_heads, head_dim)[:, :s]
    return y, h


def init_mamba_state(bsz: int, n_heads: int, head_dim: int, d_state: int,
                     conv_dim: int, conv_kernel: int = 4,
                     torch_device: str | torch.device = "cuda"):
    """A zero decode state on ``torch_device``: h (B, H, dh, ds) and the
    conv window (B, K-1, conv_dim), both float32."""
    torch_device = resolve_device(torch_device)
    return {
        "h": torch.zeros((bsz, n_heads, head_dim, d_state),
                         dtype=torch.float32, device=torch_device),
        "conv": torch.zeros((bsz, conv_kernel - 1, conv_dim),
                            dtype=torch.float32, device=torch_device),
    }


def decode_mamba2(p, x, state, *, head_dim: int = 64, d_state: int = 64):
    """Single-token step. x (B, 1, D); state {'h', 'conv'} -> (y, new
    state).

    On a mesh of processes each rank runs its part of the state's layout:
    the heads of its share of h (all of them where the state does not
    split them) and the channels of its share of the conv window, on the
    state's rows. in_proj's own columns are a slice of [z | x B C | dt]
    that follows neither, so the columns that belong to another rank's
    heads or channels move to it (``recut``), and after the conv those of
    x, B and C; XLA moves the same columns with collective-permutes.
    out_proj's rows are the heads', its partial sums all-reduced."""
    mesh = process_mesh()
    btype = x.dtype
    d_inner = p["norm_w"].shape[0]
    n_heads = p["A_log"].shape[0]
    conv_dim = d_inner + 2 * d_state

    def over_model(t, dim: int) -> tuple:
        """('model',) where 'model' alone splits ``t``'s ``dim``."""
        m = (MODEL_AXIS,)
        return m if mesh is not None and shard_axes(t, mesh, dim) == m \
            else ()
    hm, cm, pm = (over_model(state["h"], 1), over_model(state["conv"], 2),
                  over_model(p["in_proj"], 1))
    heads, chans, proj_cols = (model_ranges(n, mesh, bool(m)) for n, m in (
        (n_heads, hm), (conv_dim, cm), (p["in_proj"].shape[1], pm)))
    r = model_rank(mesh)
    h0, h1 = heads(r)
    c0, c1 = chans(r)
    rows = spec(shard_axes(state["h"], mesh, 0) if mesh else None)[0]

    def part(t, dim: int, lo: int, hi: int, m: tuple):
        return own_part(t, mesh, dim, lo, hi, batch_axes(mesh) + m)

    def span(o: int, rng: tuple, w: int = 1) -> tuple:
        return o + rng[0] * w, o + rng[1] * w
    proj = local_shard(x, mesh, (rows, None, None), split=hm) @ part(
        p["in_proj"], 1, *proj_cols(r), pm).to(btype)
    z, xbc, dt_raw = recut(proj, mesh, proj_cols, lambda j: [
        span(0, heads(j), head_dim), span(d_inner, chans(j)),
        span(d_inner + conv_dim, heads(j))])
    # rolling conv buffer
    conv_spec = (rows, None, cm[0] if cm else None)
    window = torch.cat([local_shard(state["conv"], mesh, conv_spec),
                        xbc.float()], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, part(
        p["conv_w"], 1, c0, c1, cm)) + part(p["conv_b"], 0, c0, c1, cm)
    xbc1 = F.silu(conv_out)                                        # (B, conv)
    x_in, B, C = recut(xbc1, mesh, chans, lambda j: [
        span(0, heads(j), head_dim), (d_inner, d_inner + d_state),
        (d_inner + d_state, conv_dim)])
    x_in = x_in.reshape(x_in.shape[0], h1 - h0, head_dim)

    def own(t):
        return part(t, 0, h0, h1, hm)
    dt = _softplus(dt_raw[:, 0].float() + own(p["dt_bias"]))       # (B,H)
    a = torch.exp(dt * (-torch.exp(own(p["A_log"])))[None, :])     # (B,H)
    h_spec = (rows, hm[0] if hm else None, None, None)
    h = local_shard(state["h"], mesh, h_spec) * a[..., None, None] + \
        torch.einsum("bh,bhd,bs->bhds", dt, x_in, B)
    y = torch.einsum("bhds,bs->bhd", h, C) + own(p["D"])[None, :, None] \
        * x_in
    y = y.reshape(y.shape[0], 1, (h1 - h0) * head_dim)
    y = rms_norm(y * F.silu(z.float()),
                 part(p["norm_w"], 0, h0 * head_dim, h1 * head_dim, hm),
                 mesh=mesh, axes=hm, n=d_inner)
    out = psum(y.to(btype) @ part(p["out_proj"], 0, h0 * head_dim,
                                  h1 * head_dim, hm).to(btype), mesh, hm)
    return (from_local(out, mesh, (rows, None, None), x.shape),
            {"h": from_local(h, mesh, h_spec, state["h"].shape),
             "conv": from_local(window[:, 1:], mesh, conv_spec,
                                state["conv"].shape)})
