"""Public flash-attention op: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

On the card the kernel runs or the call raises; nothing falls back to the
plain version.  The kernel masks the ragged ends of Sq and Sk itself and
reads every operand through its strides, so this wrapper pads nothing in
the sequence (the TPU wrapper pads both lengths to block multiples).  It
takes float32, bfloat16 and float16.  Each call is one launch; before it
the wrapper makes at most one copy of an operand the kernel cannot read
in place:

* a head dim outside ``kernel.HEAD_DIMS`` (up to 256) is zero-padded to
  the next one, with the scale of the real head dim, and the output sliced
  back: the zero columns add nothing to q·kᵀ, and v's zero columns are cut;
* a head dim that is not contiguous, or (bf16 on the tensor cores, whose
  16-byte copies need 16-byte aligned rows) a base or stride that is not
  16-byte aligned, is copied into a fresh contiguous buffer.

Under grad mode the CUDA branch runs the launch inside a
``torch.autograd.Function`` (:func:`.._autograd.launch`) whose backward is
that of the plain version, recomputed from the saved q, k, v with its
(B, H, Sq, Sk) f32 logits; the CPU branch is the plain version itself.
``mha.launches`` counts the kernel launches.

The launch is the custom op ``torch.ops.repro_torch.flash_attention``.
Given tensors that hold no data on the card's path (fake CUDA tensors, or
fake ones inside :func:`repro_torch.device.card_model`, as the dry-run
traces the card's path) its fake rule returns the output that
:func:`_launch` would allocate, with its shape, dtype and strides, and
builds, calls and counts nothing; ``FlopCounterMode`` counts it by
:func:`flops`, the kernel's own count.  A tensor with data always takes
the launch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ...device import on_card
from ...parallel.axes import is_dtensor
from .. import _autograd, _launches
from . import kernel, ref

__all__ = ["mha", "flops"]


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
    if is_dtensor(q):
        return _mha_sharded(q, k, v, causal=causal, scale=scale)
    if not on_card(q):
        if q.device.type == "cpu":
            return ref.mha(q, k, v, causal=causal, scale=scale)
        raise ValueError(f"mha: unsupported device {q.device}")
    if q.dtype not in kernel.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"mha: the CUDA kernel takes q, k, v all float32, "
                        f"all bfloat16 or all float16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if D > kernel.HEAD_DIMS[-1]:
        raise ValueError(f"mha: the CUDA kernel takes head dims up to "
                         f"{kernel.HEAD_DIMS[-1]}, got {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("mha: q, k and v must lie on one device")
    return _autograd.launch(_kernel_op, ref.mha, q, k, v, causal=causal,
                            scale=scale)


mha.launches = 0


def _mha_sharded(q, k, v, *, causal: bool, scale: float):
    """``mha`` of DTensors: each rank runs the op (the kernel on the card)
    on its own batch rows and query heads, through ``local_map``.

    q keeps a shard of its batch dim (0) or head dim (1) and gathers any
    other; k and v follow q's batch shards, and q's head shards where K
    divides them.  Where it does not, k and v stay whole on the rank, the
    rank takes the KV heads of its own query groups (h // (H/K)), and the
    gradients of k and v are summed over the ranks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = q.device_mesh
    H, K = q.shape[1], k.shape[1]
    qp = [pl if isinstance(pl, Shard) and pl.dim in (0, 1) else Replicate()
          for pl in q.placements]
    head_dims = [i for i, pl in enumerate(qp) if pl == Shard(1)]
    # k and v split their heads as q's only where K divides all the ways
    select = K % math.prod(dm.size(i) for i in head_dims) != 0
    kp = [Replicate() if select and i in head_dims else pl
          for i, pl in enumerate(qp)]
    # each rank's gradient of whole k and v holds only its own heads'
    # share: a partial sum over the head ways, not a replica
    kg = [Partial() if select and i in head_dims else pl
          for i, pl in enumerate(qp)]
    h0 = 0
    for i in head_dims:  # the first query head of this rank
        h0 = h0 * dm.size(i) + dm.get_local_rank(i)

    def local(ql, kl, vl):
        if select:  # the KV head of each local query head, from shapes
            n, G = ql.shape[1], H // K
            heads = [(h0 * n + j) // G for j in range(n)]
            uniq = sorted(set(heads))
            whole = heads == [u for u in uniq for _ in range(n // len(uniq))]
            # made on the device: no copy from the host
            idx = (torch.arange(uniq[0], uniq[-1] + 1, device=kl.device)
                   if whole else  # whole groups: keep the GQA layout
                   torch.div(torch.arange(n, device=kl.device) + h0 * n, G,
                             rounding_mode="floor"))
            kl, vl = kl.index_select(1, idx), vl.index_select(1, idx)
        return mha(ql, kl, vl, causal=causal, scale=scale)

    # a list is the placements of one output (a tuple would be one per
    # output)
    return local_map(local, out_placements=qp, in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kg, kg), device_mesh=dm,
                     redistribute_inputs=True)(q, k, v)


def _launch(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    """One launch on validated CUDA tensors."""
    D = q.shape[3]
    Dk = next(d for d in kernel.HEAD_DIMS if d >= D)
    if Dk != D:  # fresh, contiguous and aligned
        q, k, v = (F.pad(t, (0, Dk - D)) for t in (q, k, v))
    else:
        tc = kernel.tensor_core_path(q.dtype, D)
        q, k, v = (kernel.readable(t, tc) for t in (q, k, v))
    o = torch.empty_like(q)  # keeps q's layout, e.g. the model's (B, S, H, D)
    kernel.launch(q, k, v, o, causal=causal, scale=scale)
    _launches.count(mha)
    return o if Dk == D else o[..., :D]


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _kernel_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, scale: float) -> torch.Tensor:
    return _launch(q, k, v, causal=causal, scale=scale)


@_kernel_op.register_fake
def _(q, k, v, causal, scale):
    """The output :func:`_launch` allocates: q's layout where the kernel
    reads q in place, a fresh contiguous one where q is padded or copied
    (the same rules, read from shapes, strides and offsets alone)."""
    B, H, Sq, D = q.shape
    Dk = next(d for d in kernel.HEAD_DIMS if d >= D)
    if Dk != D:  # o[..., :D] of a contiguous (B, H, Sq, Dk) buffer
        return torch.empty_strided((B, H, Sq, D), (H * Sq * Dk, Sq * Dk, Dk, 1),
                                   dtype=q.dtype, device=q.device)
    if kernel.readable_layout(q, kernel.tensor_core_rule(q.dtype, D)):
        return torch.empty_like(q)
    return q.new_empty(q.shape)


def flops(B: int, H: int, Sq: int, Sk: int, D: int, causal: bool) -> float:
    """The kernel's FLOP count: 4·D per (query, key) pair it computes, the
    pairs of the causal triangle (query i sees keys up to i + Sk - Sq) or
    all Sq·Sk."""
    pairs = (Sq * (Sk - Sq + 1) + Sq * (Sq - 1) // 2) if causal else Sq * Sk
    return 4.0 * D * B * H * pairs


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, scale, *_, out_shape=None,
           **__) -> int:
    B, H, Sq, D = q_shape
    return int(flops(B, H, Sq, k_shape[2], D, causal))
