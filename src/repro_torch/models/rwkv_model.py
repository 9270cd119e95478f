"""RWKV-6 (Finch) language model (the reference's ``models.rwkv_model``):
attention-free, O(1)-state decode, no prefill (serving warms the state
token by token through ``decode_step``)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .common import embed_init, process_mesh, shard
from .rwkv6 import (_Ranks, apply_rwkv_cmix, apply_rwkv_tmix,
                    decode_rwkv_tmix, head_logits, init_rwkv_cmix,
                    init_rwkv_tmix)
from .transformer import (_apply_norm, _dtype, _embed, _init_norm,
                          chunked_ce_loss, init_stacked, layers, place,
                          remat)


def _block_init(gen: torch.Generator, cfg: ModelConfig):
    return {"tmix": init_rwkv_tmix(gen, cfg.d_model, cfg.rwkv_head_dim),
            "cmix": init_rwkv_cmix(gen, cfg.d_model, cfg.d_ff),
            "norm1": _init_norm(cfg, cfg.d_model),
            "norm2": _init_norm(cfg, cfg.d_model)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                torch_device: str | torch.device):
    """Random float32 parameters drawn from the CPU generator ``gen`` and
    copied, part by part, to ``torch_device``, in the reference's tree:
    embed (V, D), blocks (stacked tmix / cmix / norms), final_norm, head
    (D, V)."""
    dev = resolve_device(torch_device)
    params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model).to(dev),
              "blocks": init_stacked(lambda: _block_init(gen, cfg),
                                     cfg.n_layers, dev),
              "final_norm": place(_init_norm(cfg, cfg.d_model), dev)}
    params["head"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                  generator=gen)
                      / cfg.d_model ** 0.5).to(dev)
    return params


def _norm(cfg: ModelConfig, p, x):
    """The norm of the residual stream ``x`` as the blocks lay it out
    (``rwkv6._Ranks.out``): on a mesh of processes one sequence's channels
    are split over the batch axes, and each rank normalises its share."""
    return _Ranks(process_mesh(), x.shape[0]).norm(
        lambda x, p, *split: _apply_norm(cfg, p, x, *split), x, p)


def forward(params, cfg: ModelConfig, tokens):
    """tokens (B, S) -> final-norm hiddens (B, S, D) in cfg.dtype."""
    x = shard(_embed(params, cfg, tokens), "batch", None, None)
    block = remat(lambda p, x: _block_step(p, cfg, x), cfg)
    for p in layers(params["blocks"]):
        x = block(p, x)
    return _apply_norm(cfg, params["final_norm"], x)


def _block_step(p, cfg: ModelConfig, x):
    y, _ = apply_rwkv_tmix(p["tmix"], _apply_norm(cfg, p["norm1"], x),
                           head_dim=cfg.rwkv_head_dim)
    x = x + y
    y, _ = apply_rwkv_cmix(p["cmix"], _apply_norm(cfg, p["norm2"], x))
    return shard(x + y, "batch", None, None)


def lm_loss(params, cfg: ModelConfig, batch):
    hidden = forward(params, cfg, batch["tokens"])
    return chunked_ce_loss(params, cfg, hidden, batch["labels"])


# --------------------------------------------------------------------------
# Decode: pure recurrent state, no KV cache
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, dtype=None,
               torch_device: str | torch.device = "cuda"):
    """Token-shift states tmix_x, cmix_x (L, B, 1, D) in ``cfg.dtype`` and
    the WKV state S (L, B, H, N, N) in float32; pos 0. ``max_len`` is
    unused (the state does not grow)."""
    dev = resolve_device(torch_device)
    dt = dtype or _dtype(cfg)
    l, d, n = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
    return {
        "tmix_x": torch.zeros((l, batch, 1, d), dtype=dt, device=dev),
        "cmix_x": torch.zeros((l, batch, 1, d), dtype=dt, device=dev),
        "S": torch.zeros((l, batch, d // n, n, n), dtype=torch.float32,
                         device=dev),
        "pos": 0,
    }


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens (B,) -> (logits (B, V) float32, cache). The states are
    written in place in the cache's tensors, but where the step lays them
    out otherwise: one sequence on a mesh of processes, whose token
    shifts come out split over the batch axes and WKV states by heads
    over 'model' (as the reference's step returns its state). The step
    then returns new stacks of them, which a next step takes as they
    come."""
    x = _embed(params, cfg, tokens)[:, None, :]
    rk = _Ranks(process_mesh(), x.shape[0])
    x = rk.residual(x)
    tx, cx, S = cache["tmix_x"], cache["cmix_x"], cache["S"]
    new = []
    for i, p in enumerate(layers(params["blocks"])):
        xin = _norm(cfg, p["norm1"], x)
        y, st = decode_rwkv_tmix(p["tmix"], xin,
                                 {"x": tx[i].to(xin.dtype), "S": S[i]},
                                 head_dim=cfg.rwkv_head_dim)
        x = x + y
        xin2 = _norm(cfg, p["norm2"], x)
        y2, cx_new = apply_rwkv_cmix(p["cmix"], xin2, cx[i].to(xin2.dtype))
        x = x + y2
        states = (st["x"].to(tx.dtype), cx_new.to(cx.dtype), st["S"])
        if rk.kax:
            new.append(states)
        else:
            tx[i], cx[i], S[i] = states
    if new:
        tx, cx, S = (torch.stack(t) for t in zip(*new))
    h = _norm(cfg, params["final_norm"], x)[:, 0]
    logits = head_logits(h, params["head"])
    return logits, {**cache, "tmix_x": tx, "cmix_x": cx, "S": S,
                    "pos": int(cache["pos"]) + 1}
