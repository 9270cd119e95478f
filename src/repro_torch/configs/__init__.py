"""Architecture registry: --arch <id> -> ModelConfig (a copy of the
reference's ``configs``). The port builds models of the ``dense`` family
so far (``repro_torch.models``); the other families' configs are here so
that ``REGISTRY`` and ``cells`` stay whole."""
from .base import ModelConfig, ShapeConfig, SHAPES
from . import (chatglm3_6b, granite_moe_3b, hubert_xlarge, ising64,
               llava_next_mistral_7b, olmoe_1b_7b, qwen2_1p5b, qwen2_7b,
               qwen3_0p6b, rwkv6_3b, zamba2_7b)

REGISTRY = {
    "qwen2-7b": qwen2_7b.CONFIG,
    "qwen2-1.5b": qwen2_1p5b.CONFIG,
    "qwen3-0.6b": qwen3_0p6b.CONFIG,
    "chatglm3-6b": chatglm3_6b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
    "rwkv6-3b": rwkv6_3b.CONFIG,
    "ising64": ising64.CONFIG,
}

ISING_SHAPES = ising64.ISING_SHAPES


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells with skip annotations.

    Skips (recorded in DESIGN.md §5): long_500k needs sub-quadratic
    attention; decode shapes need a decode step (encoder-only archs have
    none)."""
    out = []
    for arch, cfg in REGISTRY.items():
        if cfg.family == "ising":
            continue
        for shape_name, shape in SHAPES.items():
            skip = None
            if shape.is_decode and not cfg.has_decode:
                skip = "encoder-only: no decode step"
            elif shape_name == "long_500k" and not cfg.sub_quadratic:
                skip = "full attention: 512k decode assigned to sub-quadratic archs only"
            if skip is None or include_skipped:
                out.append((arch, shape_name, skip))
    return out


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "REGISTRY", "ISING_SHAPES",
           "get_config", "cells"]
