"""Zamba2-style hybrid (the reference's ``models.zamba``): a Mamba-2
backbone with ONE shared transformer block (attention + MLP, one set of
weights) applied after every ``attn_every`` Mamba layers.

81 layers with attn_every = 6 are 13 groups of (6 Mamba blocks + the
shared block) and 3 tail Mamba blocks. The shared block's weights appear
once in the tree; its KV cache has one slice per group. The family has no
prefill: serving warms the state token by token through ``decode_step``.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .common import embed_init, shard
from .mamba2 import apply_mamba2, decode_mamba2, init_mamba2
from .transformer import (_apply_norm, _dtype, _embed, _init_norm,
                          _positions, attn_block, chunked_ce_loss,
                          decode_attn_block, ffn_block, init_attn, init_mlp,
                          init_stacked, layers, place, remat)


def _mamba_block_init(gen: torch.Generator, cfg: ModelConfig):
    return {"mamba": init_mamba2(gen, cfg.d_model, expand=cfg.ssm_expand,
                                 head_dim=cfg.ssm_head_dim,
                                 d_state=cfg.ssm_state,
                                 conv_kernel=cfg.conv_kernel),
            "norm": _init_norm(cfg, cfg.d_model)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                torch_device: str | torch.device):
    """Random float32 parameters drawn from the CPU generator ``gen`` and
    copied, part by part, to ``torch_device``, in the reference's tree:
    embed (V, D), blocks (stacked Mamba blocks), shared (one attention +
    MLP block), final_norm, head (D, V)."""
    dev = resolve_device(torch_device)
    params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model).to(dev)}
    params["blocks"] = init_stacked(lambda: _mamba_block_init(gen, cfg),
                                    cfg.n_layers, dev)
    params["shared"] = place({"attn": init_attn(gen, cfg),
                              "mlp": init_mlp(gen, cfg),
                              "norm1": _init_norm(cfg, cfg.d_model),
                              "norm2": _init_norm(cfg, cfg.d_model)}, dev)
    params["final_norm"] = place(_init_norm(cfg, cfg.d_model), dev)
    params["head"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                  generator=gen)
                      / cfg.d_model ** 0.5).to(dev)
    return params


def n_groups(cfg: ModelConfig):
    """(groups, tail layers): 81 layers at attn_every 6 are (13, 3)."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


def _mamba_step(p, cfg: ModelConfig, x):
    y, _ = apply_mamba2(p["mamba"], _apply_norm(cfg, p["norm"], x),
                        head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state)
    return shard(x + y, "batch", None, None)


def _shared_step(p, cfg: ModelConfig, x, positions):
    x = x + attn_block(p["attn"], cfg, _apply_norm(cfg, p["norm1"], x),
                       positions)
    x = x + ffn_block(p["mlp"], cfg, _apply_norm(cfg, p["norm2"], x))
    return shard(x, "batch", None, None)


def forward(params, cfg: ModelConfig, tokens):
    """tokens (B, S) -> final-norm hiddens (B, S, D) in cfg.dtype."""
    x = shard(_embed(params, cfg, tokens), "batch", None, None)
    positions = _positions(*x.shape[:2], x.device)
    mamba = remat(lambda p, x: _mamba_step(p, cfg, x), cfg)
    shared = remat(lambda p, x: _shared_step(p, cfg, x, positions), cfg)
    for i, p in enumerate(layers(params["blocks"])):
        x = mamba(p, x)
        if (i + 1) % cfg.attn_every == 0:      # the end of a group
            x = shared(params["shared"], x)
    return _apply_norm(cfg, params["final_norm"], x)


def lm_loss(params, cfg: ModelConfig, batch):
    hidden = forward(params, cfg, batch["tokens"])
    return chunked_ce_loss(params, cfg, hidden, batch["labels"])


def _logits(params, cfg: ModelConfig, h):
    return (h @ params["head"].to(h.dtype)).float()


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               torch_device: str | torch.device = "cuda"):
    """Per-layer Mamba states h (L, B, H, dh, ds) and conv windows
    (L, B, K-1, conv_dim) in float32; the shared block's KV cache, one
    slice per group, (G, B, max_len, Hkv, dh) in ``cfg.dtype``; pos 0."""
    dev = resolve_device(torch_device)
    dt = dtype or _dtype(cfg)
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    ng, _ = n_groups(cfg)
    kv = (ng, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "h": torch.zeros((cfg.n_layers, batch, n_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32, device=dev),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                             conv_dim), dtype=torch.float32, device=dev),
        "k": torch.zeros(kv, dtype=dt, device=dev),
        "v": torch.zeros(kv, dtype=dt, device=dev),
        "pos": 0,
    }


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens (B,) -> (logits (B, V) float32, cache). The Mamba states and
    the group's KV slice are written in place in the cache's tensors (the
    returned cache holds them and ``pos + 1``)."""
    pos = int(cache["pos"])
    x = _embed(params, cfg, tokens)[:, None, :]
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    shared = params["shared"]
    for i, lp in enumerate(layers(params["blocks"])):
        y, st = decode_mamba2(lp["mamba"], _apply_norm(cfg, lp["norm"], x),
                              {"h": cache["h"][i], "conv": cache["conv"][i]},
                              head_dim=cfg.ssm_head_dim,
                              d_state=cfg.ssm_state)
        cache["h"][i] = st["h"]
        cache["conv"][i] = st["conv"]
        x = x + y
        if (i + 1) % cfg.attn_every:           # not the end of a group
            continue
        g = (i + 1) // cfg.attn_every - 1
        x = x + decode_attn_block(shared["attn"], cfg,
                                  _apply_norm(cfg, shared["norm1"], x),
                                  positions, cache["k"][g], cache["v"][g],
                                  pos)
        x = x + ffn_block(shared["mlp"], cfg,
                          _apply_norm(cfg, shared["norm2"], x))
    h = _apply_norm(cfg, params["final_norm"], x)[:, 0]
    return _logits(params, cfg, h), {**cache, "pos": pos + 1}
