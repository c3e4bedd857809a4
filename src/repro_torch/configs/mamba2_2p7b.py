"""mamba2-2.7b — 64 Mamba2 (SSD) layers, d=2560, attn-free, ssm_state=128,
vocab 50280.  [arXiv:2405.21060; unverified]"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,          # unused by the SSM trunk
    n_kv_heads=1,
    d_ff=0,             # no FFN — Mamba2 blocks only
    vocab=50280,
    tied_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4),
)
