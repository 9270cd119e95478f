"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite]: 40 experts, top-8, d_ff 512."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155, d_head=64,
    n_experts=40, top_k=8,
)
