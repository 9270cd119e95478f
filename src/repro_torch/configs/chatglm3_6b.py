"""ChatGLM3-6B [arXiv:2406.12793]: GQA (kv=2), 2d/partial RoPE (half dims)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024, d_head=128,
    qkv_bias=True, rope_fraction=0.5,
)
