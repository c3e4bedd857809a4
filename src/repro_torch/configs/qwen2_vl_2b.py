"""qwen2-vl-2b — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, M-RoPE
(t/h/w sections), dynamic-resolution vision frontend STUBBED (precomputed
patch embeddings).  [arXiv:2409.12191; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    tied_embeddings=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
)
