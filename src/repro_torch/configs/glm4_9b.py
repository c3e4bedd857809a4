"""glm4-9b — 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552, partial
rotary (half the head dim).  [hf:THUDM/glm-4-9b; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    rope_fraction=0.5,
    tied_embeddings=False,
)
