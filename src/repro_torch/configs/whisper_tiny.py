"""whisper-tiny — enc-dec, 4 decoder layers (and 4 encoder), d=384 6H
(kv=6) d_ff=1536 vocab=51865; conv frontend STUBBED (precomputed frame
embeddings).  [arXiv:2212.04356; unverified]"""

from .base import ModelConfig, EncDecConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    tied_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=4, frontend_downsample=4),
)
