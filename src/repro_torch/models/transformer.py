"""The dense transformer stack (qwen2, qwen3, chatglm3): the reference's
``models.transformer`` for ``family == "dense"``.

Parameters keep the reference's tree and shapes, so its weights carry
across by copying (``convert.transformer_params_from_arrays``):
* blocks stacked on a leading layer axis ((L, ...) leaves), driven by a
  plain loop over the layers;
* attention weights HEAD-MAJOR, wq (L, D, Hp, dh), wo (L, Hp, dh, D), with
  the heads padded to ``cfg.padded_heads`` and the padded heads masked
  (zero wo rows, zeroed outputs), so the padded model is exactly the
  ``n_heads`` model; dropping that TPU padding is later work;
* the vocabulary padded to a multiple of 256, sliced off the logits.

Weights stay float32 and are cast to ``cfg.dtype`` at use. The other
families raise ``NotImplementedError`` naming the part of ROADMAP queue 1,
step 4 that ports them; ``lm_loss`` and ``chunked_ce_loss`` wait for its
training part.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import decode_attention, flash_attention
from .common import (act_fn, apply_rope, dense_init, embed_init, layer_norm,
                     rms_norm)

#: ROADMAP queue 1 step-4 parts that port each family the port lacks
NOT_YET_PORTED = {"moe": "step 4 (the moe family)",
                  "vlm": "step 4 (vlm and encoder)",
                  "encoder": "step 4 (vlm and encoder)",
                  "hybrid": "step 4 (hybrid and rwkv6)",
                  "rwkv": "step 4 (hybrid and rwkv6)"}


def check_family(cfg: ModelConfig) -> None:
    """Raise unless the port builds ``cfg``'s family (dense only so far)."""
    if cfg.family == "dense":
        return
    if cfg.family in NOT_YET_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not yet ported to "
            f"repro_torch (ROADMAP queue 1, {NOT_YET_PORTED[cfg.family]})")
    raise ValueError(f"no model family {cfg.family!r}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# Parameter init
# --------------------------------------------------------------------------

def _init_norm(cfg: ModelConfig, d: int, device):
    w = torch.ones((d,), dtype=torch.float32, device=device)
    if cfg.norm == "layernorm":
        return {"w": w, "b": torch.zeros((d,), dtype=torch.float32,
                                         device=device)}
    return {"w": w}


def _apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def init_attn(gen: torch.Generator, cfg: ModelConfig):
    """Attention weights, HEAD-MAJOR: wq (D, Hp, dh), wo (Hp, dh, D); the
    padded heads' wo rows are zero."""
    dh, h, hkv, d = cfg.head_dim, cfg.padded_heads, cfg.n_kv_heads, cfg.d_model
    dev = gen.device
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
        p["bq"] = torch.zeros((h, dh), dtype=torch.float32, device=dev)
        p["bk"] = torch.zeros((hkv, dh), dtype=torch.float32, device=dev)
        p["bv"] = torch.zeros((hkv, dh), dtype=torch.float32, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((dh,), dtype=torch.float32, device=dev)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    p = {"wi": dense_init(gen, cfg.d_model, cfg.d_ff)}
    if cfg.act == "silu":   # gated (SwiGLU); gelu families use plain MLP
        p["wg"] = dense_init(gen, cfg.d_model, cfg.d_ff)
    p["wo"] = dense_init(gen, cfg.d_ff, cfg.d_model)
    return p


def init_block(gen: torch.Generator, cfg: ModelConfig):
    return {"attn": init_attn(gen, cfg), "ffn": init_mlp(gen, cfg),
            "norm1": _init_norm(cfg, cfg.d_model, gen.device),
            "norm2": _init_norm(cfg, cfg.d_model, gen.device)}


def padded_vocab(cfg: ModelConfig) -> int:
    """The vocab rounded up to a multiple of 256 (the reference pads it so
    the head shards over 'model'). Padded ids are never emitted: decode
    slices them off."""
    return cfg.vocab_size + (-cfg.vocab_size) % 256


def _stack(trees):
    """Stack per-layer dicts of tensors into one dict of (L, ...) tensors."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (L, ...) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random float32 parameters drawn from ``gen`` (on its device), in the
    reference's tree: embed, blocks (stacked), final_norm, head."""
    check_family(cfg)
    params = {
        "embed": embed_init(gen, padded_vocab(cfg), cfg.d_model),
        "blocks": _stack([init_block(gen, cfg)
                          for _ in range(cfg.n_layers)]),
        "final_norm": _init_norm(cfg, cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, padded_vocab(cfg))
    return params


# --------------------------------------------------------------------------
# Forward (prefill)
# --------------------------------------------------------------------------

def _mask_pad_heads(o, cfg: ModelConfig):
    """Zero the padded attention heads so they carry no function: the
    padded model is EXACTLY the logical n_heads model."""
    hp = o.shape[2]
    if hp == cfg.n_heads:
        return o
    mask = (torch.arange(hp, device=o.device) < cfg.n_heads).to(o.dtype)
    return o * mask[None, None, :, None]


def _qkv(p, cfg: ModelConfig, x, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_fraction > 0:
        q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
        k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
    return q, k, v


def _attn_out(p, cfg: ModelConfig, o, dt):
    o = _mask_pad_heads(o, cfg)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))


def ffn_block(p, cfg: ModelConfig, x):
    dt = x.dtype
    a = act_fn(cfg.act)
    hi = x @ p["wi"].to(dt)
    hidden = a(x @ p["wg"].to(dt)) * hi if "wg" in p else a(hi)
    return hidden @ p["wo"].to(dt)


def _embed(params, cfg: ModelConfig, tokens):
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    return params["embed"][tokens].to(_dtype(cfg))


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _block_collect(p, cfg: ModelConfig, x, positions):
    """One block; returns the new residual stream and the block's (k, v)."""
    q, k, v = _qkv(p["attn"], cfg, _apply_norm(cfg, p["norm1"], x),
                   positions)
    o = flash_attention(q, k, v, causal=cfg.causal, q_chunk=cfg.attn_q_chunk,
                        k_chunk=cfg.attn_k_chunk)
    x = x + _attn_out(p["attn"], cfg, o, x.dtype)
    x = x + ffn_block(p["ffn"], cfg, _apply_norm(cfg, p["norm2"], x))
    return x, (k, v)


def forward(params, cfg: ModelConfig, tokens):
    """tokens (B, S) -> final-norm hiddens (B, S, D) in cfg.dtype."""
    check_family(cfg)
    x = _embed(params, cfg, tokens)
    positions = _positions(*x.shape[:2], x.device)
    for i in range(cfg.n_layers):
        x, _ = _block_collect(_layer(params["blocks"], i), cfg, x, positions)
    return _apply_norm(cfg, params["final_norm"], x)


def lm_head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _logits(params, cfg: ModelConfig, h):
    logits = (h @ lm_head_weight(params, cfg).to(h.dtype)).float()
    return logits[:, :cfg.vocab_size]            # drop vocab padding


def prefill(params, cfg: ModelConfig, tokens, max_len: int | None = None):
    """Forward pass that ALSO emits the KV cache (serving prefill).

    Returns (last_logits (B, V) float32, cache); ``max_len >= S`` pads the
    cache for the decode steps that follow.
    """
    check_family(cfg)
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block_collect(_layer(params["blocks"], i), cfg, x,
                                   positions)
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
    x = _embed(params, cfg, tokens)[:, None, :]
    b = x.shape[0]
    dt = x.dtype
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    kc, vc = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        q, k, v = _qkv(p["attn"], cfg, _apply_norm(cfg, p["norm1"], x),
                       positions)
        kc[i, :, pos] = k[:, 0].to(kc.dtype)
        vc[i, :, pos] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc[i], vc[i], pos + 1)
        x = x + _attn_out(p["attn"], cfg, o, dt)
        x = x + ffn_block(p["ffn"], cfg, _apply_norm(cfg, p["norm2"], x))
    h = _apply_norm(cfg, params["final_norm"], x)[:, 0]
    return _logits(params, cfg, h), {"k": kc, "v": vc, "pos": pos + 1}
