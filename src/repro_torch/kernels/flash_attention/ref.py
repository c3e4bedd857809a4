"""Plain PyTorch version of causal GQA attention with f32 softmax.

The oracle of the JAX package's flash kernel, mirrored step for step: GQA
through a grouped einsum (repeated KV is never formed), logits in float32,
the causal diagonal aligned to the end of the kv sequence, and the
probabilities cast to v's type before the PV product.  On a CPU tensor the
public op (:mod:`.ops`) runs :func:`mha`; on the card it is the reference the
CUDA kernel is held against.
"""

from __future__ import annotations

from typing import Optional

import torch


def _logits(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.einsum("bkgqd,bkld->bkgql", qg.float(), k.float()) * scale


def _pv(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bkgql,bkld->bkgqd", probs.to(v.dtype).float(),
                        v.float())


def _probs_v(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _pv(torch.softmax(logits, dim=-1), v)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, K, Sk, D) with K | H.  Returns
    (B, H, Sq, D) in q's dtype.

    Grouped-query attention: query head h attends with kv head h // (H // K).
    """
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"mha: {H} query heads are not a multiple of {K} "
                         "kv heads")
    group = H // K
    scale = scale if scale is not None else D ** -0.5
    logits = _logits(q.reshape(B, K, group, Sq, D), k, scale)
    if causal:
        # align the causal diagonal to the *end* of the kv sequence, so a
        # single new query with a long KV cache (decode) attends everywhere
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(ki <= qi), float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    del logits  # the softmax's backward reads only its output: free these
    out = _pv(probs, v)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, scale: Optional[float] = None,
                chunk: int = 256) -> torch.Tensor:
    """Query-chunked attention: the same output as :func:`mha`, but the
    (Sq x Sk) logits never materialise — the peak is (chunk x Sk) per step.

    The softmax of each q chunk runs over the full key axis, so no
    online-softmax carry is needed.  A Python loop over the chunks stands in
    for the reference's ``lax.scan``."""
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    group = H // K
    scale = scale if scale is not None else D ** -0.5
    if Sq % chunk != 0 or Sq <= chunk:
        return mha(q, k, v, causal=causal, scale=scale)
    qg = q.reshape(B, K, group, Sq, D)
    diag = Sk - Sq
    ki = torch.arange(Sk, device=q.device)[None, :]
    blocks = []
    for lo in range(0, Sq, chunk):
        logits = _logits(qg[:, :, :, lo:lo + chunk], k, scale)
        if causal:
            qi = lo + torch.arange(chunk, device=q.device)[:, None] + diag
            logits = logits.masked_fill(~(ki <= qi), float("-inf"))
        blocks.append(_probs_v(logits, v).to(q.dtype))
    return torch.cat(blocks, dim=3).reshape(B, H, Sq, D)
