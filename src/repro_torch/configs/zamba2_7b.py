"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + shared attention block."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000, d_head=112,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    attn_every=6,
)
