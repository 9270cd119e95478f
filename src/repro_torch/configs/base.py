"""Model / run configuration dataclasses and the shape registry (a copy of
the reference's ``configs.base``, which has no JAX in it).

Every assigned architecture gets a module in this package exporting
``CONFIG``; ``repro_torch.configs.REGISTRY`` maps ``--arch`` ids to them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | rwkv | encoder | vlm | ising
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    d_head: Optional[int] = None          # default d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_fraction: float = 1.0            # chatglm3 2d/partial rotary = 0.5
    rope_theta: float = 10000.0
    causal: bool = True                   # False => encoder (hubert)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0                   # shared attn block every k layers
    # rwkv
    rwkv_head_dim: int = 64
    # vlm
    n_vision_tokens: int = 0
    # misc
    head_pad_multiple: int = 16           # pad attn heads so the head axis
                                          # shards over TP=16 (masked: padded
                                          # heads carry no function/gradient)
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    act: str = "silu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    attn_q_chunk: int = 512
    attn_k_chunk: int = 512
    loss_chunk: int = 512                 # seq chunking for vocab CE
    moe_sort_dispatch: bool = True        # sort-based (active-FLOPs) dispatch

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        m = max(self.head_pad_multiple, 1)
        return self.n_heads + (-self.n_heads) % m

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("hybrid", "rwkv")

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder" and self.family != "ising"

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2) or 2,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads or 4, 2) or 2,
            d_ff=256,
            vocab_size=256,
            d_head=32,
            n_experts=8 if self.n_experts else 0,
            top_k=2 if self.top_k else 0,
            ssm_state=16 if self.ssm_state else 0,
            attn_every=2 if self.attn_every else 0,
            n_vision_tokens=8 if self.n_vision_tokens else 0,
            rwkv_head_dim=32,
            ssm_head_dim=32,
            attn_q_chunk=64, attn_k_chunk=64, loss_chunk=64,
            head_pad_multiple=1,
            dtype="float32",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
