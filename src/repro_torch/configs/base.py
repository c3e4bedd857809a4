"""Model / run configuration schema.

Every assigned architecture is a :class:`ModelConfig`; ``reduce()`` derives
the CPU-smoke-test variant of the same family (small dims, same topology).
Input shapes are :class:`ShapeConfig`; the four assigned shapes are module
constants.  ``registry.py`` maps ``--arch`` ids to configs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden dim
    n_shared: int = 0  # always-on shared experts (deepseek)
    layer0_dense: bool = False  # deepseek: first layer is a dense FFN
    capacity_factor: float = 1.25
    router_norm_topk: bool = False  # normalise top-k weights to sum 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 64

    def n_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style: mamba trunk + one *shared* attention block applied every
    ``period`` layers (weights reused at every application point)."""

    period: int = 6
    shared_d_ff: int = 0  # FFN width inside the shared block (0 = none)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    frontend_downsample: int = 4  # stubbed conv frontend: frames = seq // this


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # glm4 rotates half the head dim
    tied_embeddings: bool = True
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    norm_eps: float = 1e-6
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # none | full  (activation checkpointing per layer)
    scan_layers: bool = True
    use_pallas: bool = False  # TPU kernels (interpret-validated on CPU)
    # beyond-paper perf levers (see EXPERIMENTS.md §Perf)
    seq_shard: bool = False  # shard sequence dim of activations (SP)
    moe_ragged: bool = False  # ragged grouped-matmul MoE path (vs capacity)
    loss_chunk: int = 0  # chunked cross-entropy (never materialise full
    # (B,S,V) logits); 0 = off
    fsdp: bool = False  # ZeRO-3: shard weight contracting dims over 'data'
    kv_quant: bool = False  # int8 KV cache (per-position-head scales): ~2x
    # cache memory + bandwidth at decode
    attn_chunk: int = 0  # query-chunked attention: (S,S) logits never
    # materialise (XLA-level flash analogue; the Pallas kernel is the
    # TPU-native path); 0 = off

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k+ context?  (SSM / hybrid trunks.)"""
        return self.family in ("ssm", "hybrid")

    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder (whisper = enc-dec)

    def reduce(self) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        kw = dataclasses.asdict(self)
        hd = 16
        n_heads = max(2, min(4, self.n_heads))
        n_kv = 1 if self.n_kv_heads == 1 else min(2, n_heads)
        kw.update(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=n_heads * 32,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=128,
            vocab=256,
            head_dim=hd if self.head_dim else None,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )
        if self.moe:
            kw["moe"] = MoEConfig(
                n_experts=4, top_k=2, d_expert=64,
                n_shared=min(1, self.moe.n_shared),
                layer0_dense=self.moe.layer0_dense,
                # dropless at smoke scale so forward ≡ prefill+decode
                capacity_factor=4.0,
                router_norm_topk=self.moe.router_norm_topk)
        if self.ssm:
            kw["ssm"] = SSMConfig(d_state=16, head_dim=16,
                                  expand=2, conv_kernel=4,
                                  chunk=16)
        if self.hybrid:
            kw["hybrid"] = HybridConfig(period=2,
                                        shared_d_ff=self.hybrid.shared_d_ff
                                        and 128)
        if self.encdec:
            kw["encdec"] = EncDecConfig(n_enc_layers=2, frontend_downsample=4)
        if self.mrope:
            kw["mrope_sections"] = (4, 6, 6)
        for k in ("moe", "ssm", "hybrid", "encdec"):
            if isinstance(kw[k], dict):
                cls = {"moe": MoEConfig, "ssm": SSMConfig,
                       "hybrid": HybridConfig, "encdec": EncDecConfig}[k]
                kw[k] = cls(**kw[k])
        return ModelConfig(**kw)


# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch × shape) a runnable cell?  (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False, ("full quadratic attention at 524k context is not "
                       "servable; skipped per assignment note")
    return True, ""
