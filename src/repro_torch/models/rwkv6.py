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

import torch
import torch.nn.functional as F

from ..distributed.sharding import batch_axes, data_size, spec
from .common import (MODEL_AXIS, dense_init, from_local, gather,
                     heads_over_ranks, local_shard, logical, model_axes,
                     model_ranges, model_to_batch, own_part, own_range,
                     process_mesh, psum, psum_scatter, recut, rms_norm)

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


class _Ranks:
    """This rank's share of a block (the reference's partition of its
    column- and row-parallel weights), given per rank so each rank does
    its own share whatever DTensor's propagation would pick. With ``mesh``
    None its helpers return their input and the block is whole. The
    block's channels (d of them) are split over 'model' when its size
    divides d (``cm`` the axes that split them, ``cols`` their spec
    entry). A batch the batch axes divide is split over them (``batch``;
    ``rows`` the spec of a (B, S, D) activation). One they do not divide
    (a single sequence decoding) is whole on every rank, and the batch
    axes split the column-parallel products' contracted channels instead
    (``kax``; ``k`` their spec entry), and the row-parallel products'
    output channels (``rmm``), as XLA partitions the reference's decode
    of one sequence. A block's output (``out``, the residual stream's
    layout between blocks) is split as its input: by rows, or for one
    sequence its channels over ``kax``, which the next block's products
    contract and its norms reduce."""

    def __init__(self, mesh, batch: int, *dims):
        self.mesh = mesh
        self.cm = model_axes(mesh, *dims)
        self.cols = self.cm[0] if self.cm else None
        split = batch % data_size(mesh) == 0
        self.batch = batch_axes(mesh) if split else ()
        self.kax = () if split else batch_axes(mesh)
        self.k = spec(self.kax)[0]
        self.rows = logical("batch", None, None) if split else (None,) * 3
        self.out = self.rows[:2] + (self.k,)

    def input(self, x):
        """An input (B, ..., D) as this rank's rows and its contracted
        channels (all, or its share over ``kax``); its gradient partial
        where the channels are split."""
        return local_shard(x, self.mesh, (self.rows[0],) + (None,) * (
            x.dim() - 2) + (self.k,), split=self.cm)

    def x(self, x, x_prev):
        """The block's input and its token-shifted copy (zeros before the
        first token without ``x_prev``), as ``input``, in float32."""
        xl = self.input(x)
        xp = (torch.zeros((xl.shape[0], 1, xl.shape[2]), dtype=xl.dtype,
                          device=xl.device) if x_prev is None else
              self.input(x_prev))
        xs = _shift(xl, xp)
        return xl.float(), xs.float()

    def vec(self, t):
        """A replicated (D,) parameter over the input's channels."""
        return local_shard(t, self.mesh, (self.k,),
                           split=self.batch + self.cm)

    def part(self, w, s):
        """The parameter ``w`` laid out as spec ``s``; its gradient partial
        over the batch axes that split the rows, or, as ``kax``, the
        row-parallel products' output channels."""
        return local_shard(w, self.mesh, s, split=self.batch + self.kax)

    def mm(self, a, w, split: bool = False):
        """``a`` (its contracted channels) by this rank's columns of the
        column-parallel ``w`` (cast to ``a``'s dtype), summed over
        ``kax``, whose ranks use the sum for their own shares of the work
        (their output channels of a row-parallel product further on)
        where ``split``."""
        return psum(a @ self.part(w, (self.k, self.cols)).to(a.dtype),
                    self.mesh, self.kax, split=split)

    def rmm(self, a, w, own: bool = False):
        """``a`` (this rank's channels) by this rank's rows of the
        row-parallel ``w``, the partial sums added over 'model': every
        output channel, or with ``own`` this rank's (a reduce-scatter).
        Over ``kax`` each rank computes its share of the output channels,
        summed over 'model', which stays its share (``out``)."""
        y = a @ self.part(w, (self.cols, self.k)).to(a.dtype)
        if own and not self.kax:
            return psum_scatter(y, self.mesh, self.cm, 2)
        return psum(y, self.mesh, self.cm)

    def out_cols(self, t):
        """(B_l, S, n) the columns this rank holds of a column-parallel
        product (its chunk over 'model', or all n) -> those of its share
        of the block's output (``out``): the same, or over ``kax`` its
        share of them, taken from the ranks that hold it
        (``model_to_batch``) or sliced from all of them."""
        if not self.kax:
            return t
        if self.cm:
            return model_to_batch(t, self.mesh,
                                  t.shape[-1] * self.mesh.shape[MODEL_AXIS])
        return local_shard(from_local(t, self.mesh, self.rows, t.shape),
                           self.mesh, self.out, split=False)

    def residual(self, x):
        """The residual stream ``x`` (B, S, D), whole over ``kax``, as
        ``out`` lays it out (a rank's share is a slice of it)."""
        if not self.kax:
            return x
        return from_local(local_shard(x, self.mesh, self.out, split=False),
                          self.mesh, self.out, x.shape)

    def norm(self, norm, x, p):
        """``norm(x, p)`` of the residual stream ``x`` as ``out`` lays it
        out; over ``kax`` each rank normalises its share, and ``norm``
        also takes (mesh, axes, channels) to add its sums across them."""
        if not self.kax:
            return norm(x, p)
        w = {k: local_shard(v, self.mesh, (self.k,), split=False)
             for k, v in p.items()}
        y = norm(local_shard(x, self.mesh, self.out, split=False), w,
                 self.mesh, self.kax, x.shape[-1])
        return from_local(y, self.mesh, self.out, x.shape)

    def gather_cols(self, t, batch, split=True):
        """(B_l, S, D / tp) this rank's channels -> every channel, which
        the ranks use for their own shares (``split``) or as a whole."""
        if not self.cm:
            return t
        return gather(t, self.mesh, (self.rows[0], None, self.cols), 2,
                      (batch, t.shape[1], t.shape[2] * self.mesh.shape[
                          MODEL_AXIS]), split=split)

    def own_cols(self, t):
        """(B_l, S, D) -> this rank's channels."""
        if not self.cm:
            return t
        n = t.shape[-1] // self.mesh.shape[MODEL_AXIS]
        i = self.mesh.device_mesh.get_local_rank(MODEL_AXIS)
        return t[..., i * n:(i + 1) * n]


def _tmix(p, x, x_prev, S0, head_dim: int):
    """The time mix of x (B, S, D): (y, (last_x, S)). ``S0`` None runs the
    chunked form (a whole sequence from a zero state); else one token
    from state ``S0``.

    On a mesh of processes each rank runs it on its own batch rows: r, k,
    v, g and the decay from its own channels of the column-parallel Wr /
    Wk / Wv / Wg / wA (the decay lora's 64 wide activations gathered);
    the recurrence over whole heads, ``own_range`` of them (40 heads on 16
    ranks: 3 or fewer a rank, none computed twice), on r, k, v and the
    decay of those heads, whose channels that lie on other ranks move to
    it (``recut``); its output moves back to the ranks' channels for the
    gate and the row-parallel Wo, whose partial sums are all-reduced. A
    decode state's heads are split where its spec splits them, and for
    one sequence, whose new state comes back split so, as the reference's
    step returns it (the rank's heads of a replicated state are a slice
    of it); a split batch's decode state that the cache replicates (40
    heads on 16 ranks) stays whole. Where the batch axes split the
    contractions (one sequence) they also split Wo's output channels,
    which the output keeps (``_Ranks.out``), and every gradient before Wo
    is partial over them."""
    mesh = process_mesh()
    b, s, d = x.shape
    h = d // head_dim
    rk = _Ranks(mesh, b, d, p["wA"].shape[1])
    xf, xsf = rk.x(x, x_prev)

    def mix(name):
        return _mix(xf, xsf, rk.vec(p[name]))
    col = (None, rk.cols)
    r, k, v, g = (rk.mm(mix("mu_" + n), p["W" + n], split=True)
                  for n in "rkvg")
    a = rk.gather_cols(torch.tanh(rk.mm(mix("mu_w"), p["wA"], split=True)),
                       b)
    wraw = rk.part(p["w0"], (rk.cols,)) + a @ rk.part(p["wB"], col)
    logw = -torch.exp(torch.clamp(wraw, max=WRAW_CLAMP))  # <= -0 per channel

    h0, h1 = own_range(h, mesh) if rk.cm and (
        S0 is None or rk.kax or heads_over_ranks(mesh, h) is not None) \
        else (0, h)
    split = h1 - h0 < h
    cols = model_ranges(d, mesh)

    def head_cols(j):
        return [tuple(head_dim * e for e in model_ranges(h, mesh)(j))]
    if split:       # a rank's columns -> its heads' (only the rest move)
        r, k, v, logw = (recut(t, mesh, cols, head_cols)[0]
                         for t in (r, k, v, logw))
    else:
        r, k, v, logw = (rk.gather_cols(t, b) for t in (r, k, v, logw))
    u = own_part(p["u"], mesh, 0, h0, h1,
                 rk.batch + rk.kax + (rk.cm if split else ()))
    hs = (rk.rows[0], "model" if split else None, None, None)
    if S0 is None:
        y, S = _wkv_chunked(r, k, v, logw, u, head_dim)
    else:
        y, S = _wkv_step(r, k, v, logw,
                         local_shard(S0, mesh, hs, split=False), u, head_dim)
    ones = torch.ones((head_dim,), dtype=torch.float32, device=y.device)
    y = rms_norm(y.reshape(y.shape[0], s, h1 - h0, head_dim),
                 ones).flatten(2)
    # the heads' outputs -> the rank's columns, for the gate and Wo
    y = (recut(y, mesh, lambda j: head_cols(j)[0], lambda j: [cols(j)])[0]
         if split else rk.own_cols(y))
    y = y * rk.part(p["ln_w"], (rk.cols,))[None, None, :]
    y = rk.rmm(y * F.silu(g), p["Wo"]).to(x.dtype)
    return (from_local(y, mesh, rk.out, (b, s, d)),
            (x[:, -1:], from_local(S, mesh, hs,
                                   (b, h, head_dim, head_dim))))


def apply_rwkv_tmix(p, x, x_prev=None, head_dim: int = 64):
    """x (B, S, D) -> (y, (last_x, S_final)). float32 internals."""
    return _tmix(p, x, x_prev, None, head_dim)


def apply_rwkv_cmix(p, x, x_prev=None):
    """x (B, S, D) -> (y, last_x). On a mesh of processes each rank runs it
    on its own batch rows and its own columns of the column-parallel Wk /
    Wr (rows of the row-parallel Wv): the partial sums of the Wv product
    are reduce-scattered to the rank's channels, gated by its own r, and
    the result gathered whole. For one sequence each rank's share of the
    output channels is summed over 'model' and gated by r's same
    channels, which move to it (``_Ranks.out_cols``), and stays its
    share."""
    mesh = process_mesh()
    b, s, d = x.shape
    rk = _Ranks(mesh, b, d, p["Wk"].shape[1])
    xf, xsf = rk.x(x, x_prev)
    k = rk.mm(_mix(xf, xsf, rk.vec(p["mu_k"])), p["Wk"], split=True)
    r = rk.mm(_mix(xf, xsf, rk.vec(p["mu_r"])), p["Wr"])
    kv = rk.rmm(torch.square(F.relu(k)), p["Wv"], own=True)
    out = (kv * torch.sigmoid(rk.out_cols(r))).to(x.dtype)
    if not rk.kax:
        out = rk.gather_cols(out, b, split=False)
    return from_local(out, mesh, rk.out, (b, s, d)), x[:, -1:]


def decode_rwkv_tmix(p, x, state, head_dim: int = 64):
    """x (B, 1, D); state {'x': (B, 1, D), 'S': (B, H, N, N)} -> (y, new
    state)."""
    y, (_, S_new) = _tmix(p, x, state["x"], state["S"], head_dim)
    return y, {"x": x, "S": S_new}


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


def head_logits(h, w):
    """``(h @ w).float()`` of the last hidden states h (B, D) and the
    column-parallel head w (D, V); on a mesh of processes the logits of
    this rank's columns, as ``_Ranks`` splits a block's products."""
    b, d = h.shape
    rk = _Ranks(process_mesh(), b, d, w.shape[1])
    out = rk.mm(rk.input(h), w).float()
    return from_local(out, rk.mesh, (rk.rows[0], rk.cols), (b, w.shape[1]))
