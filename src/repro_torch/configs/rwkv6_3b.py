"""RWKV-6 "Finch" 3B [arXiv:2404.05892]: attention-free, data-dependent decay."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    rwkv_head_dim=64,
)
