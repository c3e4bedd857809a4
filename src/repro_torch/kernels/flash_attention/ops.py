"""Public flash-attention op: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

On the card the kernel runs or the call raises; nothing falls back to the
plain version.  The kernel masks the ragged ends of Sq and Sk itself and
reads every operand through its strides, so this wrapper pads and copies
nothing (the TPU wrapper pads both lengths to block multiples).  bf16 at
head dims up to 128 runs on the tensor cores, whose 16-byte copies need
16-byte aligned rows: the launch raises ValueError on a tensor that has
none, before the kernel runs.  The
CUDA branch refuses inputs that require grad while grad mode is on (the
kernel has no backward yet); the CPU branch is differentiable.
``mha.launches`` counts the kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _autograd, _launches
from . import kernel, ref

__all__ = ["mha"]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, K, Sk, D).  Same contract as
    :func:`.ref.mha`; the output has q's dtype (and, on the card, q's
    memory layout)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"mha: q (B, H, Sq, D) and k, v (B, K, Sk, D) "
                         f"required, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % K:
        raise ValueError(f"mha: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} (same B and D, K | H)")
    if causal and Sq > Sk:
        raise ValueError(f"mha: causal attention needs Sq <= Sk, got "
                         f"{Sq} > {Sk}")
    scale = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return ref.mha(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha: unsupported device {q.device}")
    if q.dtype not in kernel.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"mha: the CUDA kernel takes q, k, v all float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in kernel.HEAD_DIMS:
        raise ValueError(f"mha: the CUDA kernel takes head dims "
                         f"{kernel.HEAD_DIMS}, got {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("mha: q, k and v must lie on one device")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("mha: the CUDA kernel needs the head dim "
                         "contiguous (stride 1)")
    _autograd.refuse_grad("mha", q, k, v)
    o = torch.empty_like(q)  # keeps q's layout, e.g. the model's (B, S, H, D)
    kernel.launch(q, k, v, o, causal=causal, scale=scale)
    _launches.count(mha)
    return o


mha.launches = 0
