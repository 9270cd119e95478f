"""Model facade: one uniform API over the ported architectures (the
reference's ``models.zoo``).

    model = build(get_config("qwen3-0.6b"))
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    loss = model.loss(params, {"tokens": tokens, "labels": labels})
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len=96)
    logits, cache = model.decode_step(params, cache, next_tokens)

``init`` draws on a CPU generator (it refuses any other) and copies the
weights to the device it is given, so one seed gives the same weights on
every device. Every family of the reference's registry but ``ising``
builds. As in the reference, ``prefill`` is None for the encoder and the
recurrent families (hybrid, rwkv), and ``init_cache`` / ``decode_step``
are None for the encoder. ``loss`` takes the reference's batches: tokens
and labels (-1 = masked); the encoder's ``embeds`` in place of tokens;
the vlm's ``vision_embeds`` over the first positions, whose labels the
caller sets to -1. ``input_specs`` / ``cache_specs`` give a cell's
inputs and decode cache as meta tensors, the dry-run's stand-ins.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..pytree import eval_shape
from . import rwkv_model, transformer, zamba


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]                       # (generator, torch_device) -> params
    loss: Callable[..., Any]                       # (params, batch) -> scalar
    forward: Callable[..., Any]                    # (params, batch) -> hiddens
    prefill: Optional[Callable[..., Any]] = None   # (params, batch, max_len) -> (logits, cache)
    init_cache: Optional[Callable[..., Any]] = None  # (batch, max_len, torch_device) -> cache
    decode_step: Optional[Callable[..., Any]] = None  # (params, cache, tokens) -> (logits, cache)


def build(cfg: ModelConfig) -> Model:
    if cfg.family in transformer.FAMILIES:
        def fwd(p, b):
            return transformer.forward(
                p, cfg, b.get("tokens"), embeds=b.get("embeds"),
                vision_embeds=b.get("vision_embeds"))

        def pre(p, b, max_len=None):
            return transformer.prefill(
                p, cfg, b.get("tokens"), embeds=b.get("embeds"),
                vision_embeds=b.get("vision_embeds"), max_len=max_len)

        def cache(b, s, torch_device="cuda"):
            return transformer.init_cache(cfg, b, s,
                                          torch_device=torch_device)
        return Model(
            cfg=cfg, init=lambda gen, torch_device:
            transformer.init_params(gen, cfg, torch_device),
            loss=lambda p, b: transformer.lm_loss(p, cfg, b), forward=fwd,
            prefill=pre if cfg.family != "encoder" else None,
            init_cache=cache if cfg.has_decode else None,
            decode_step=((lambda p, c, t: transformer.decode_step(p, cfg, c, t))
                         if cfg.has_decode else None))
    recurrent = {"hybrid": zamba, "rwkv": rwkv_model}.get(cfg.family)
    if recurrent is None:
        raise ValueError(f"no model family {cfg.family!r}")
    return Model(
        cfg=cfg, init=lambda gen, torch_device: recurrent.init_params(
            gen, cfg, torch_device),
        loss=lambda p, b: recurrent.lm_loss(p, cfg, b),
        forward=lambda p, b: recurrent.forward(p, cfg, b["tokens"]),
        init_cache=lambda b, s, torch_device="cuda": recurrent.init_cache(
            cfg, b, s, torch_device=torch_device),
        decode_step=lambda p, c, t: recurrent.decode_step(p, cfg, c, t))


# --------------------------------------------------------------------------
# Shape stand-ins for the dry-run (no allocation)
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model inputs for an (arch x shape) cell as meta tensors (the
    reference's ``ShapeDtypeStruct`` stand-ins): tokens and labels (the
    encoder's ``embeds`` in place of tokens, the vlm's ``vision_embeds``
    beside them, no labels at prefill), or (b,) tokens at decode."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encoder":
            batch = {"embeds": spec((b, s, cfg.d_model), dt),
                     "labels": spec((b, s), i32)}
        else:
            batch = {"tokens": spec((b, s), i32), "labels": spec((b, s), i32)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = spec((b, cfg.n_vision_tokens,
                                           cfg.d_model), dt)
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
    if shape.kind == "decode":
        return {"tokens": spec((b,), i32)}
    raise ValueError(shape.kind)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The family's decode cache for ``shape`` as meta tensors
    (``pytree.eval_shape`` of ``init_cache``: a 500k-token cache costs
    nothing)."""
    model = build(cfg)
    return eval_shape(model.init_cache, shape.global_batch, shape.seq_len,
                      torch_device="cpu")
