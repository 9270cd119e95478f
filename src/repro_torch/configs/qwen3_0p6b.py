"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family]: dense GQA decoder with qk_norm."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab_size=151936, d_head=128,
    qk_norm=True, rope_theta=1e6,
)
