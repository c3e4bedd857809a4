"""phi3.5-moe-42b-a6.6b — 32L d=4096 32H (GQA kv=8) d_ff=6400 vocab=32064,
MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    tied_embeddings=False,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=6400),
)
