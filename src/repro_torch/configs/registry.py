"""``--arch`` id → ModelConfig registry for the 10 assigned architectures."""

from __future__ import annotations

from . import (deepseek_moe_16b, gemma_2b, glm4_9b, mamba2_2p7b, phi35_moe,
               qwen2_0p5b, qwen2_vl_2b, whisper_tiny, yi_34b, zamba2_1p2b)
from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (phi35_moe, deepseek_moe_16b, zamba2_1p2b, gemma_2b,
              qwen2_0p5b, yi_34b, glm4_9b, mamba2_2p7b, whisper_tiny,
              qwen2_vl_2b)
}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[arch]
    return cfg.reduce() if reduced else cfg
