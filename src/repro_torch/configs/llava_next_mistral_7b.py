"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone-only per the assignment: the anyres vision tower is a STUB —
``input_specs`` supplies precomputed patch embeddings (576 tokens = one
24x24 tile) that are spliced over the sequence prefix.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, d_head=128,
    rope_theta=1e6, n_vision_tokens=576,
)
