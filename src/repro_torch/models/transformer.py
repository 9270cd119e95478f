"""The transformer stacks (the reference's ``models.transformer``): dense
(qwen2, qwen3, chatglm3), MoE (granite, olmoe), the llava backbone (vlm)
and hubert (encoder).

Parameters keep the reference's tree and shapes, so its weights carry
across by copying (``convert.lm_params_from_arrays``):
* blocks stacked on a leading layer axis ((L, ...) leaves), driven by a
  plain loop over the layers;
* attention weights HEAD-MAJOR, wq (L, D, Hp, dh), wo (L, Hp, dh, D), with
  the heads padded to ``cfg.padded_heads`` and the padded heads masked
  (zero wo rows, zeroed outputs), so the padded model is exactly the
  ``n_heads`` model; dropping that TPU padding is later work;
* MoE blocks hold ``models.moe``'s router and (L, E, ...) expert stacks in
  place of the MLP;
* the vocabulary padded to a multiple of 256, sliced off the logits;
* the encoder's conv positional embedding ``pos_conv``: w (128, D/16, D)
  in the reference's WIO layout, kernel 128, 16 groups, "SAME" padding
  (63 left, 64 right), computed in float32. On the card that conv runs
  under cuDNN, whose TF32 default (``torch.backends.cudnn.allow_tf32``)
  rounds its float32 inputs unless the caller turns it off, as
  ``chip_smoke.py`` does.

Weights stay float32 and are cast to ``cfg.dtype`` at use. Each forward
unbinds the stacked leaves once (``layers``). Under grad (training) with
``cfg.remat`` every block runs under activation checkpointing, as the
reference's ``jax.checkpoint``; the serving paths run without grad and
compute exactly what they computed before. ``chunked_ce_loss`` never
holds more than one chunk's (B, c, V) logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.sharding import batch_axes, spec
from ..pytree import tree_map
from .attention import (_expand_kv, decode_attention, flash_attention,
                        write_position)
from .common import (act_fn, apply_rope, batch_rows, dense_init,
                     embed_init, first_columns, from_local, layer_norm,
                     local_shard, logical, model_axes, own_part, own_range,
                     process_mesh, psum, replicated, rms_norm, shard,
                     shard_axes, shard_index, whole)
from .moe import apply_moe, init_moe

#: the families this module builds (zamba and rwkv_model build the others)
FAMILIES = ("dense", "moe", "vlm", "encoder")
#: hubert's conv positional embedding: kernel width and groups
POS_CONV_KERNEL, POS_CONV_GROUPS = 128, 16


def check_family(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a transformer family."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"no transformer family {cfg.family!r}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# Parameter init
# --------------------------------------------------------------------------

def _init_norm(cfg: ModelConfig, d: int):
    w = torch.ones((d,), dtype=torch.float32)
    if cfg.norm == "layernorm":
        return {"w": w, "b": torch.zeros((d,), dtype=torch.float32)}
    return {"w": w}


def _apply_norm(cfg: ModelConfig, p, x, *split):
    """``cfg``'s norm of ``x``; ``split`` (mesh, axes, channels) where the
    ranks of those mesh axes each hold their own channels of it."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps, *split)
    return rms_norm(x, p["w"], cfg.norm_eps, *split)


def init_attn(gen: torch.Generator, cfg: ModelConfig):
    """Attention weights, HEAD-MAJOR: wq (D, Hp, dh), wo (Hp, dh, D); the
    padded heads' wo rows are zero."""
    dh, h, hkv, d = cfg.head_dim, cfg.padded_heads, cfg.n_kv_heads, cfg.d_model
    p = {
        "wq": dense_init(gen, d, h * dh).reshape(d, h, dh),
        "wk": dense_init(gen, d, hkv * dh).reshape(d, hkv, dh),
        "wv": dense_init(gen, d, hkv * dh).reshape(d, hkv, dh),
        "wo": dense_init(gen, h * dh, d,
                         scale=1.0 / (h * dh) ** 0.5).reshape(h, dh, d),
    }
    if h > cfg.n_heads:
        p["wo"][cfg.n_heads:] = 0.0
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, dh), dtype=torch.float32)
        p["bk"] = torch.zeros((hkv, dh), dtype=torch.float32)
        p["bv"] = torch.zeros((hkv, dh), dtype=torch.float32)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=torch.float32)
        p["k_norm"] = torch.ones((dh,), dtype=torch.float32)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    p = {"wi": dense_init(gen, cfg.d_model, cfg.d_ff)}
    if cfg.act == "silu":   # gated (SwiGLU); gelu families use plain MLP
        p["wg"] = dense_init(gen, cfg.d_model, cfg.d_ff)
    p["wo"] = dense_init(gen, cfg.d_ff, cfg.d_model)
    return p


def init_block(gen: torch.Generator, cfg: ModelConfig):
    ffn = (init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts)
           if cfg.n_experts else init_mlp(gen, cfg))
    return {"attn": init_attn(gen, cfg), "ffn": ffn,
            "norm1": _init_norm(cfg, cfg.d_model),
            "norm2": _init_norm(cfg, cfg.d_model)}


def padded_vocab(cfg: ModelConfig) -> int:
    """The vocab rounded up to a multiple of 256 (the reference pads it so
    the head shards over 'model'). Padded ids are never emitted: decode
    slices them off."""
    return cfg.vocab_size + (-cfg.vocab_size) % 256


def place(tree, dev: torch.device):
    """``tree``'s leaves copied to ``dev``."""
    return tree_map(lambda t: t.to(dev), tree)


def init_stacked(make, n: int, dev: torch.device):
    """``n`` layers of ``make()`` (drawn on the CPU) stacked into (n, ...)
    leaves on ``dev``, drawn in layer order. Each layer is copied into the
    stack as it is drawn, so the host holds one layer at a time."""
    layer = make()
    stack = tree_map(lambda t: torch.empty((n,) + tuple(t.shape),
                                           dtype=t.dtype, device=dev),
                     layer)
    for i in range(n):
        if i:
            layer = make()
        tree_map(lambda dst, src: dst[i].copy_(src), stack, layer)
        del layer
    return stack


def layers(tree) -> list:
    """The per-layer trees of a stacked (L, ...) tree, each leaf unbound
    once. Under autograd one ``unbind``'s backward stacks the L grads in
    one op; L selects ``tree[i]`` would each fill a zero tensor the size of
    the whole stack and add all L of them into the leaf's grad."""
    if isinstance(tree, dict):
        per_key = {k: layers(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree))


def remat(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing when ``cfg.remat`` and grad is
    on (the reference's ``jax.checkpoint``): its activations are
    recomputed in backward instead of kept. Without grad, ``fn`` itself."""
    if cfg.remat and torch.is_grad_enabled():
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    return fn


def init_params(gen: torch.Generator, cfg: ModelConfig,
                torch_device: str | torch.device):
    """Random float32 parameters drawn from the CPU generator ``gen`` and
    copied, part by part, to ``torch_device``, in the reference's tree:
    embed, blocks (stacked), final_norm, head."""
    check_family(cfg)
    dev = resolve_device(torch_device)
    params = {
        "embed": embed_init(gen, padded_vocab(cfg), cfg.d_model).to(dev),
        "blocks": init_stacked(lambda: init_block(gen, cfg), cfg.n_layers,
                               dev),
        "final_norm": place(_init_norm(cfg, cfg.d_model), dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model,
                                    padded_vocab(cfg)).to(dev)
    if cfg.family == "encoder":
        d = cfg.d_model
        params["pos_conv"] = place({
            "w": torch.randn((POS_CONV_KERNEL, d // POS_CONV_GROUPS, d),
                             generator=gen, dtype=torch.float32) * 0.01,
            "b": torch.zeros((d,), dtype=torch.float32)}, dev)
    return params


# --------------------------------------------------------------------------
# Forward (prefill)
# --------------------------------------------------------------------------

def _mask_pad_heads(o, cfg: ModelConfig, first: int = 0):
    """Zero the padded attention heads so they carry no function: the
    padded model is EXACTLY the logical n_heads model. ``o``'s heads are
    heads ``first`` on."""
    hp = o.shape[2]
    if first + hp <= cfg.n_heads:
        return o
    mask = (torch.arange(first, first + hp, device=o.device)
            < cfg.n_heads).to(o.dtype)
    return o * mask[None, None, :, None]


def _head_shares(cfg: ModelConfig, mesh):
    """(qm, (q0, q1), (k0, k1)): the mesh axes that split the query heads
    (('model',) where its size divides them, else ()), this rank's query
    heads (``own_range``) and the KV heads they read. Every head with
    ``mesh`` None."""
    hp = cfg.padded_heads
    qm = model_axes(mesh, hp)
    q0, q1 = own_range(hp, mesh) if qm else (0, hp)
    g = hp // cfg.n_kv_heads
    return qm, (q0, q1), (q0 // g, (q1 - 1) // g + 1)


def _qkv(p, cfg: ModelConfig, x, positions, mesh=None, kv_heads=None):
    """q, k, v of x as the reference's ``_qkv`` makes them. With ``mesh``
    None, of every head (plain tensors, or DTensors left to DTensor's
    propagation, as decode's are). On a mesh of processes ``x`` and
    ``positions`` are DTensors and the work this rank's (the reference's
    partition): its rows of x, q of its own query heads from its columns
    of the head-parallel wq, and k, v of the KV heads they read. With
    ``kv_heads`` ([lo, hi)) only k and v, of those KV heads."""
    dt = x.dtype
    qm, q_heads, kv_read = _head_shares(cfg, mesh)
    names = "qkv" if kv_heads is None else "kv"
    heads = {"q": q_heads, "k": kv_heads or kv_read, "v": kv_heads or kv_read}
    split = batch_axes(mesh) + qm
    x = local_shard(x, mesh, logical("batch", None, None), split=qm)

    def part(w, n, dim):
        return own_part(p[w + n], mesh, dim, *heads[n], split).to(dt)
    t = {n: torch.einsum("bsd,dhk->bshk", x, part("w", n, 1)) for n in names}
    if cfg.qkv_bias:
        t = {n: t[n] + part("b", n, 0) for n in names}
    qk = names.replace("v", "")
    if cfg.qk_norm:
        for n in qk:
            t[n] = rms_norm(t[n], whole(p[n + "_norm"], mesh, split),
                            cfg.norm_eps)
    if cfg.rope_fraction > 0:
        pos = local_shard(positions, mesh, logical("batch", None),
                          split=False)
        for n in qk:
            t[n] = apply_rope(t[n], pos, fraction=cfg.rope_fraction,
                              theta=cfg.rope_theta)
    return tuple(t[n] for n in names)


def _attn_out(p, cfg: ModelConfig, o, dt, mesh=None):
    """o @ wo over the heads o holds (``_qkv``'s q heads on ``mesh``): on a
    mesh of processes wo's rows of the rank's heads, whose partial sums
    are all-reduced."""
    qm, (q0, q1), _ = _head_shares(cfg, mesh)
    o = _mask_pad_heads(o, cfg, q0)
    wo = own_part(p["wo"], mesh, 0, q0, q1, batch_axes(mesh) + qm)
    return psum(torch.einsum("bshk,hkd->bsd", o, wo.to(dt)), mesh, qm)


def _attention(p, cfg: ModelConfig, x, positions, keep_kv: bool = False):
    """Self-attention of x (B, S, D): (out, (k, v) if ``keep_kv`` else
    None). On a mesh of processes each rank runs it on its own batch rows
    and its own query heads (``_qkv``), the rank's heads' KV heads
    repeated for them as ``flash_attention`` repeats them all; with
    ``keep_kv`` (prefill's cache) k and v are DTensors whose KV heads are
    split over 'model' as ``own_range`` splits them (a rank's share is the
    heads it reads where 'model' divides them, else computed beside
    those)."""
    mesh = process_mesh()
    hp, hkv = cfg.padded_heads, cfg.n_kv_heads
    qm, (q0, q1), (k0, k1) = _head_shares(cfg, mesh)
    q, k, v = _qkv(p, cfg, x, positions, mesh)
    kq, vq = k, v
    if (q0, q1) != (0, hp):
        g = hp // hkv
        kq, vq = (_expand_kv(t, (k1 - k0) * g)[:, :, q0 - k0 * g:q1 - k0 * g]
                  for t in (k, v))
    o = flash_attention(q, kq, vq, causal=cfg.causal,
                        q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    rows = logical("batch", None, None)
    out = from_local(_attn_out(p, cfg, o, x.dtype, mesh), mesh, rows,
                     x.shape)
    if not keep_kv:
        return out, None
    c0, c1 = own_range(hkv, mesh) if qm else (0, hkv)
    if (c0, c1) != (k0, k1):
        k, v = _qkv(p, cfg, x, positions, mesh, kv_heads=(c0, c1))
    kv_spec = logical("batch", None, "model" if qm else None, None)
    shape = tuple(x.shape[:2]) + (hkv, cfg.head_dim)
    return out, tuple(from_local(t, mesh, kv_spec, shape) for t in (k, v))


def attn_block(p, cfg: ModelConfig, x, positions):
    return _attention(p, cfg, x, positions)[0]


def ffn_block(p, cfg: ModelConfig, x):
    """The MLP (or MoE). On a mesh of processes Megatron's pair (the
    reference's partition): each rank multiplies its own rows by its own
    columns of the column-parallel wi / wg and its rows of the
    row-parallel wo, and the partial sums are all-reduced over 'model'. A
    weight's gradient is the rank's own tokens against its own columns,
    summed over the batch axes."""
    if cfg.n_experts:
        return apply_moe(p, x, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, act=cfg.act)
    mesh = process_mesh()
    dt = x.dtype
    fm = model_axes(mesh, p["wi"].shape[-1])
    fax = fm[0] if fm else None
    rows = (batch_rows(x.shape[0], mesh),) + (None,) * (x.dim() - 1)
    xl = local_shard(x, mesh, rows, split=fm)

    def w(name, s):
        return local_shard(p[name], mesh, s, split=batch_axes(mesh)).to(dt)
    a = act_fn(cfg.act)
    hi = xl @ w("wi", (None, fax))
    hidden = a(xl @ w("wg", (None, fax))) * hi if "wg" in p else a(hi)
    return from_local(psum(hidden @ w("wo", (fax, None)), mesh, fm), mesh,
                      rows, x.shape)


def _embed(params, cfg: ModelConfig, tokens):
    """The token embeddings in cfg.dtype, batch-sharded on a mesh of
    processes. ``F.embedding`` gathers the same rows as indexing, and its
    backward sums a token's repeats in a fixed order on the CPU and the
    card; indexing's backward (``index_put_`` with accumulate) adds them
    atomically across CPU threads, so two identical training runs could
    differ.

    On a mesh of processes Megatron's vocab-parallel embedding: each rank
    looks its own tokens up in its own rows of the table (the vocabulary
    split over 'model'), zeroes the tokens outside them, and the ranks'
    rows are all-reduced over 'model' in ``cfg.dtype`` (exact: one rank
    contributes each token). The table's gradient is then the rank's own
    rows, partial over the batch axes only, as the reference's."""
    table = params["embed"]
    mesh = process_mesh()
    tokens = torch.as_tensor(tokens, device=table.device).long()
    vax = shard_axes(table, mesh, 0) if mesh is not None else ()
    rows = (batch_rows(tokens.shape[0], mesh),) + (None,) * (tokens.dim() - 1)
    tl = local_shard(tokens, mesh, rows)
    wl = local_shard(table, mesh, spec(vax, None),
                     split=batch_axes(mesh) if rows[0] else ())
    if vax:
        lo = shard_index(table, mesh, 0) * wl.shape[0]
        mine = (tl >= lo) & (tl < lo + wl.shape[0])
        x = F.embedding(torch.where(mine, tl - lo, 0), wl)
        x = psum(torch.where(mine[..., None], x, 0).to(_dtype(cfg)), mesh,
                 vax)
    else:
        x = F.embedding(tl, wl).to(_dtype(cfg))
    x = from_local(x, mesh, rows + (None,), tuple(tokens.shape) + (
        table.shape[1],))
    return shard(x, "batch", *([None] * (x.dim() - 1)))


def pos_conv(pc, x):
    """hubert's conv positional embedding of ``x`` (B, S, D), in float32:
    ``conv_general_dilated`` with WIO weights, 16 feature groups and
    "SAME" padding, as ``conv1d`` with (D, D/16, 128) weights over the
    input padded by hand."""
    mesh = process_mesh()
    if mesh is not None:
        return _pos_conv_over_ranks(pc["w"], x, mesh)
    return _pos_conv(pc["w"], x, POS_CONV_GROUPS)


def _pos_conv(w, x, groups: int):
    k = w.shape[0]
    left = (k - 1) // 2                      # "SAME": 63 left, 64 right
    xt = torch.nn.functional.pad(x.float().transpose(1, 2),
                                 (left, k - 1 - left))
    out = torch.nn.functional.conv1d(xt, w.float().permute(2, 1, 0),
                                     groups=groups)
    return out.transpose(1, 2)


def _pos_conv_over_ranks(w, x, mesh):
    """``pos_conv`` on a mesh of processes, with w's output channels over
    'model' (its spec) as XLA runs it: each rank convolves the input
    channels of its own groups (a group's input and output channels are
    the same slice) and the output stays channel-sharded."""
    axes = shard_axes(w, mesh, 2)
    wl = local_shard(w, mesh, spec(None, None, axes))
    d = x.shape[-1]
    n = d // wl.shape[2]                     # channel slices
    i = shard_index(w, mesh, 2)
    x_spec = logical("batch", None, None)
    xl = local_shard(x, mesh, x_spec)[..., i * d // n:(i + 1) * d // n]
    out = _pos_conv(wl, xl, POS_CONV_GROUPS // n)
    return from_local(out, mesh, spec(x_spec[0], None, axes), x.shape)


def _inputs(params, cfg: ModelConfig, tokens, embeds, vision_embeds):
    """The residual stream's input (B, S, D) in cfg.dtype: token embeddings
    or ``embeds``, with ``vision_embeds`` (B, n_vis, D) over the first n_vis
    positions (llava's prefix splice)."""
    dt = _dtype(cfg)
    x = _embed(params, cfg, tokens) if embeds is None else embeds.to(dt)
    if vision_embeds is not None:
        nv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(dt), x[:, nv:]], dim=1)
    return x


def _positions(b: int, s: int, device):
    return shard(replicated(torch.arange(s, dtype=torch.int32, device=device)
                            .expand(b, s)), "batch", None)


def apply_block(p, cfg: ModelConfig, x, positions):
    """One block (the reference's ``apply_block``): the new residual
    stream."""
    return _block_collect(p, cfg, x, positions, keep_kv=False)[0]


def _block_collect(p, cfg: ModelConfig, x, positions, keep_kv: bool = True):
    """One block; returns the new residual stream and the block's (k, v)
    (None unless ``keep_kv``)."""
    a, kv = _attention(p["attn"], cfg, _apply_norm(cfg, p["norm1"], x),
                       positions, keep_kv)
    x = shard(x + a, "batch", None, None)
    x = x + ffn_block(p["ffn"], cfg, _apply_norm(cfg, p["norm2"], x))
    return shard(x, "batch", None, None), kv


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            vision_embeds=None):
    """tokens (B, S) or embeds (B, S, D) -> final-norm hiddens (B, S, D) in
    cfg.dtype; the encoder adds its conv positional embedding first."""
    check_family(cfg)
    x = _inputs(params, cfg, tokens, embeds, vision_embeds)
    if cfg.family == "encoder":
        pc = params["pos_conv"]
        x = x + act_fn("gelu")(pos_conv(pc, x) + pc["b"]).to(x.dtype)
    x = shard(x, "batch", None, None)
    positions = _positions(*x.shape[:2], x.device)
    block = remat(lambda p, x: apply_block(p, cfg, x, positions), cfg)
    for p in layers(params["blocks"]):
        x = block(p, x)
    return _apply_norm(cfg, params["final_norm"], x)


def lm_head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def chunked_ce_loss(params, cfg: ModelConfig, hidden, labels):
    """Mean next-token cross entropy of ``hidden`` (B, S, D) against
    ``labels`` (B, S), -1 = masked (the reference's chunked CE).

    S is padded to whole ``cfg.loss_chunk`` chunks with masked labels; the
    vocab-padded head's padded columns are set to -1e30 before the
    logsumexp. Each chunk runs under activation checkpointing while grad
    is on, so backward recomputes one chunk's (B, c, V) float32 logits at
    a time instead of keeping every chunk's. The chunks' sums add in chunk
    order, in float32.
    """
    w = lm_head_weight(params, cfg).to(hidden.dtype)
    mesh = process_mesh()
    if mesh is not None:
        return _ce_over_ranks(hidden, labels, w, cfg, mesh)
    b, s, _ = hidden.shape
    c = min(cfg.loss_chunk, s)
    n = -(-s // c)
    pad = n * c - s
    hidden = F.pad(hidden, (0, 0, 0, pad))
    labels = F.pad(torch.as_tensor(labels, device=hidden.device).long(),
                   (0, pad), value=-1)

    def nll(*args):
        if torch.is_grad_enabled():
            return checkpoint(_chunk_nll, *args, use_reentrant=False)
        return _chunk_nll(*args)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        t, m = nll(hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
                   w, cfg.vocab_size)
        tot = tot + t
        cnt = cnt + m
    return tot / torch.clamp(cnt, min=1.0)


def _chunk_nll(h, lab, w, vocab: int):
    """(sum of the chunk's masked NLL, its count of unmasked labels)."""
    logits = (h @ w).float()                                   # (B, c, Vp)
    v_pad = w.shape[-1]
    if v_pad > vocab:
        keep = torch.arange(v_pad, device=logits.device) < vocab
        logits = torch.where(keep, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, torch.clamp(lab, min=0)[..., None])[..., 0]
    mask = (lab >= 0).float()
    return ((lse - tgt) * mask).sum(), mask.sum()


def _ce_over_ranks(hidden, labels, w, cfg: ModelConfig, mesh):
    """``chunked_ce_loss`` on a mesh of processes, each rank on its own
    batch rows and slice of a vocab-sharded head (Megatron's
    vocab-parallel cross entropy, what XLA makes of the reference's
    sharded logsumexp): the max, the sum of exponentials and the target
    logit are all-reduced over the vocab slices, and the loss's two sums
    over the batch. Returns the loss as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    v_axes = shard_axes(w, mesh, 1)
    b_axes = batch_axes(mesh)
    hl = local_shard(hidden, mesh, logical("batch", None, None),
                     split=v_axes)
    wl = local_shard(w, mesh, spec(None, v_axes), split=b_axes)
    labl = local_shard(labels, mesh, logical("batch", None),
                       split=False).long()
    s = hl.shape[1]
    c = min(cfg.loss_chunk, s)
    n = -(-s // c)
    pad = n * c - s
    hl = F.pad(hl, (0, 0, 0, pad))
    labl = F.pad(labl, (0, pad), value=-1)
    lo = shard_index(w, mesh, 1) * wl.shape[-1]       # this slice's first id

    def nll(h, lab):
        logits = (h @ wl).float()                               # (B, c, V/n)
        cols = lo + torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(cols < cfg.vocab_size, logits, -1e30)
        m = psum(logits.detach().amax(dim=-1), mesh, v_axes, "max")
        lse = torch.log(psum(torch.exp(logits - m[..., None]).sum(-1), mesh,
                             v_axes)) + m
        own = (lab >= lo) & (lab < lo + logits.shape[-1])
        idx = torch.clamp(lab - lo, 0, logits.shape[-1] - 1)[..., None]
        tgt = psum(torch.where(own, torch.gather(logits, -1, idx)[..., 0],
                               0.0), mesh, v_axes)
        mask = (lab >= 0).float()
        return ((lse - tgt) * mask).sum(), mask.sum()
    tot = torch.zeros((), dtype=torch.float32, device=hl.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hl.device)
    for i in range(n):
        args = (hl[:, i * c:(i + 1) * c], labl[:, i * c:(i + 1) * c])
        t, m = (checkpoint(nll, *args, use_reentrant=False)
                if torch.is_grad_enabled() else nll(*args))
        tot = tot + t
        cnt = cnt + m
    loss = psum(tot, mesh, b_axes) / torch.clamp(psum(cnt, mesh, b_axes),
                                                 min=1.0)
    return DTensor.from_local(loss, mesh.device_mesh,
                              [Replicate()] * mesh.device_mesh.ndim,
                              run_check=False)


def lm_loss(params, cfg: ModelConfig, batch):
    """The LM loss of ``batch``: tokens (or the encoder's ``embeds``, with
    the vlm's ``vision_embeds``) and labels."""
    hidden = forward(params, cfg, batch.get("tokens"),
                     embeds=batch.get("embeds"),
                     vision_embeds=batch.get("vision_embeds"))
    return chunked_ce_loss(params, cfg, hidden, batch["labels"])


def _logits(params, cfg: ModelConfig, h):
    logits = (h @ lm_head_weight(params, cfg).to(h.dtype)).float()
    return first_columns(logits, cfg.vocab_size)  # drop vocab padding


def prefill(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            vision_embeds=None, max_len: int | None = None):
    """Forward pass that ALSO emits the KV cache (serving prefill).

    Returns (last_logits (B, V) float32, cache); ``max_len >= S`` pads the
    cache for the decode steps that follow, whose positions continue from
    S (vision tokens included).
    """
    check_family(cfg)
    x = shard(_inputs(params, cfg, tokens, embeds, vision_embeds),
              "batch", None, None)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    ks, vs = [], []
    for p in layers(params["blocks"]):
        x, (k, v) = _block_collect(p, cfg, x, positions)
        ks.append(k)
        vs.append(v)
    h = _apply_norm(cfg, params["final_norm"], x)[:, -1]
    logits = _logits(params, cfg, h)
    ks, vs = torch.stack(ks), torch.stack(vs)     # (L, B, S, Hkv, dh)
    if max_len and max_len > s:
        pad = (0, 0, 0, 0, 0, max_len - s)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    return logits, {"k": ks, "v": vs, "pos": s}


# --------------------------------------------------------------------------
# Decode (serve step)
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               torch_device: str | torch.device = "cuda"):
    """An empty cache on ``torch_device``: k, v (L, B, max_len, Hkv, dh) in
    ``cfg.dtype`` (or ``dtype``) and ``pos`` 0."""
    dev = resolve_device(torch_device)
    dt = dtype or _dtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": 0}


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens (B,) -> (logits (B, V) float32, cache). Attention runs over
    cache[:pos+1]; the new token's K/V is written at index ``pos``, in
    place in the cache's tensors (the returned cache holds the same tensors
    and ``pos + 1``)."""
    check_family(cfg)
    pos = int(cache["pos"])
    x = shard(_embed(params, cfg, tokens)[:, None, :], "batch", None, None)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    kc, vc = cache["k"], cache["v"]
    for i, p in enumerate(layers(params["blocks"])):
        x = x + decode_attn_block(p["attn"], cfg,
                                  _apply_norm(cfg, p["norm1"], x), positions,
                                  kc[i], vc[i], pos)
        x = x + ffn_block(p["ffn"], cfg, _apply_norm(cfg, p["norm2"], x))
    h = _apply_norm(cfg, params["final_norm"], x)[:, 0]
    return _logits(params, cfg, h), {"k": kc, "v": vc, "pos": pos + 1}


def decode_attn_block(p, cfg: ModelConfig, x, positions, kc, vc, pos: int):
    """One token's self-attention (x (B, 1, D)) against the cache slices
    ``kc`` / ``vc``, into which its k and v are written at ``pos``: the
    block's output. On a mesh of processes the heads of the attention's
    output that are this rank's (``_qkv``'s q heads) meet wo's rows of
    them and the partial sums are all-reduced, Megatron's row-parallel
    half as in ``_attention``, so the residual stream stays whole."""
    mesh = process_mesh()
    q, k, v = _qkv(p, cfg, x, positions)
    write_position(kc, pos, k[:, 0].to(kc.dtype))
    write_position(vc, pos, v[:, 0].to(vc.dtype))
    o = decode_attention(q, kc, vc, pos + 1)
    qm = _head_shares(cfg, mesh)[0]
    rows = batch_rows(x.shape[0], mesh)
    o = local_shard(o, mesh, (rows, None, "model" if qm else None, None),
                    split=False)
    return from_local(_attn_out(p, cfg, o, x.dtype, mesh), mesh,
                      (rows, None, None), x.shape)
