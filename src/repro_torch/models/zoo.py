"""Model facade: one uniform API over the ported architectures (the
reference's ``models.zoo``).

    model = build(get_config("qwen3-0.6b"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len=96)
    logits, cache = model.decode_step(params, cache, next_tokens)

The port builds the ``dense`` family; the others raise
``NotImplementedError`` naming the ROADMAP step that ports them. ``loss``
waits for the training slice, and ``input_specs`` / ``cache_specs`` (the
dry-run's shape stand-ins) for the dry-run's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..configs.base import ModelConfig
from . import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]           # (generator) -> params
    forward: Callable[..., Any]        # (params, batch) -> hiddens
    prefill: Callable[..., Any]        # (params, batch, max_len) -> (logits, cache)
    init_cache: Callable[..., Any]     # (batch, max_len, torch_device) -> cache
    decode_step: Callable[..., Any]    # (params, cache, tokens) -> (logits, cache)


def build(cfg: ModelConfig) -> Model:
    transformer.check_family(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen: transformer.init_params(gen, cfg),
        forward=lambda p, b: transformer.forward(p, cfg, b["tokens"]),
        prefill=lambda p, b, max_len=None: transformer.prefill(
            p, cfg, b["tokens"], max_len=max_len),
        init_cache=lambda b, s, torch_device="cuda": transformer.init_cache(
            cfg, b, s, torch_device=torch_device),
        decode_step=lambda p, c, t: transformer.decode_step(p, cfg, c, t),
    )
