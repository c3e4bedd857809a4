"""zamba2-1.2b — 38 Mamba2 layers d=2048 + one shared attention block
(32H MHA kv=32, d_ff=8192) applied every 6 layers; ssm_state=64.
[arXiv:2411.15242; hf]  (Simplification noted in DESIGN.md: the shared
block operates at d_model width rather than on concat(hidden, embed).)"""

from .base import ModelConfig, SSMConfig, HybridConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4),
    hybrid=HybridConfig(period=6, shared_d_ff=8192),
)
