"""Architecture configs + registry (one module per assigned arch).

The port's own copy of the JAX package's configs, kept identical so both
packages build the same model from one ``--arch`` id (the port imports
nothing of the JAX package, not even its JAX-free modules)."""

from .base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, HybridConfig, EncDecConfig,
    ShapeConfig, SHAPES, SHAPES_BY_NAME, applicable,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)
from .registry import ARCHS, get_config  # noqa: F401
