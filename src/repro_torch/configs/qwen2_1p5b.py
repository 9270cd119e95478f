"""Qwen2-1.5B [arXiv:2407.10671]: dense GQA decoder, QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, d_head=128,
    qkv_bias=True, rope_theta=1e6,
)
