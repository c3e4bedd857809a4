"""deepseek-moe-16b — 28L d=2048 16H (kv=16) d_ff=1408 vocab=102400,
64 routed experts top-6 + 2 shared, fine-grained; layer 0 dense.
[arXiv:2401.06066; hf]"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,          # the dense layer-0 FFN width
    vocab=102400,
    tied_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  layer0_dense=True, router_norm_topk=True),
)
