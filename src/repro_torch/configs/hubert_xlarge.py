"""HuBERT X-Large [arXiv:2106.07447]: encoder-only; conv frontend STUBBED —
``input_specs`` supplies precomputed frame embeddings. No decode step."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504, d_head=80,
    causal=False, rope_fraction=0.0,
    norm="layernorm", act="gelu",
)
