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
caller sets to -1. ``input_specs`` / ``cache_specs`` (the dry-run's shape stand-ins)
wait for the dry-run's slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ..configs.base import ModelConfig
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
