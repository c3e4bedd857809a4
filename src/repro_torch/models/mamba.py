"""Mamba2 block (SSD, state-space duality, arXiv:2405.21060), in PyTorch.

The JAX package's ``models/mamba.py`` on plain dicts of tensors with the
same leaf names.  The full-sequence path (forward, prefill) runs the chunked
SSD of :mod:`..kernels.ssd_scan`: the hand-written CUDA kernel on the card,
also when prefill asks for the final state, and the plain version on the
CPU.  Decode is the O(1)-per-token recurrence on a carried (conv, ssd)
state, plain tensor code as the JAX package leaves it outside any kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref
from ..parallel.axes import act, is_dtensor
from . import layers

__all__ = ["mamba_init", "mamba_apply", "mamba_cache", "mamba_decode_step"]


def _dims(cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H = di // s.head_dim
    conv_dim = di + 2 * s.n_groups * s.d_state
    return di, H, s.head_dim, s.d_state, s.n_groups, conv_dim, s.conv_kernel


def mamba_init(gen: torch.Generator, cfg, dtype, stack: int = 0) -> dict:
    """Seeded weights, stacked ``stack`` deep; ``dt_bias``, ``A_log`` and
    ``D_skip`` stay float32 whatever ``dtype`` is."""
    D = cfg.d_model
    di, H, P, N, G, conv_dim, ck = _dims(cfg)
    lead = (stack,) if stack else ()
    dev, f32 = gen.device, torch.float32
    proj_out = 2 * di + 2 * G * N + H  # z, xBC, dt
    const = layers._const
    return {
        "in_proj": layers.dense_init(gen, (D, proj_out), dtype, stack=stack),
        "conv_w": layers.normal(gen, lead + (ck, conv_dim), dtype, 0.1),
        "conv_b": const((conv_dim,), 0.0, dtype, dev, stack),
        "dt_bias": const((H,), 0.0, f32, dev, stack),
        "A_log": const((H,), 0.0, f32, dev, stack),  # A = -exp(A_log) = -1
        "D_skip": const((H,), 1.0, f32, dev, stack),
        "gate_norm": {"scale": const((di,), 1.0, dtype, dev, stack)},
        "out_proj": layers.dense_init(gen, (di, D), dtype,
                                      scale=1.0 / math.sqrt(di), stack=stack),
    }


def _split_proj(cfg, proj):
    di, H, P, N, G, conv_dim, ck = _dims(cfg)
    return (proj[..., :di], proj[..., di:di + conv_dim],
            proj[..., di + conv_dim:])


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over seq: xBC (B, S, C), w (k, C).  The taps
    accumulate in f32 in the reference's order j = 0..k-1, from zeros laid
    out as xBC is (a DTensor's own shards, never its global shape)."""
    k = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = torch.zeros_like(xBC, dtype=torch.float32)
    for j in range(k):
        out = out + pad[:, j:j + S, :].float() * w[j].float()
    return F.silu(out + b.float()).to(xBC.dtype)


def mamba_apply(p: dict, cfg, x: torch.Tensor, *, return_state: bool = False):
    """x: (B, S, D) → (B, S, D).  Full-sequence (forward / prefill) path.

    ``return_state=True`` (prefill) also returns the decode cache, its
    ``h`` the scan's final state."""
    B, S, D = x.shape
    di, H, P, N, G, conv_dim, ck = _dims(cfg)
    proj = act(x @ p["in_proj"].to(x.dtype), "batch", "seq", "ff")
    # z, xBC and dt split the ff dim off the ranks' boundaries: on a mesh
    # it is gathered once, before the three slices
    z, xBC_raw, dt = _split_proj(cfg, act(proj, "batch", "seq", None))
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    # views of xBC: the kernel reads them through their strides
    xs = act(xBC[..., :di].reshape(B, S, H, P), "batch", "seq", "heads",
             None)
    Bm = xBC[..., di:di + G * N].reshape(B, S, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, S, G, N)
    dt = act(F.softplus(dt.float() + p["dt_bias"].float()), "batch", "seq",
             "heads")
    A = -torch.exp(p["A_log"].float())  # (H,)
    res = ssd_ops.ssd(xs, dt, A, Bm, Cm, chunk=cfg.ssm.chunk,
                      return_state=return_state)
    y, hT = res if return_state else (res, None)
    y = y.float() + p["D_skip"].float()[None, None, :, None] * xs.float()
    y = y.to(x.dtype).reshape(B, S, di)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = layers.rmsnorm(p["gate_norm"], y * F.silu(z), eps=cfg.norm_eps)
    out = act(y @ p["out_proj"].to(x.dtype), "batch", "seq", "d")
    if return_state:  # the last ck - 1 inputs, zeros in front of a short S
        conv_state = F.pad(xBC_raw[:, -(ck - 1):],
                           (0, 0, max(ck - 1 - S, 0), 0))
        # the sharded op gives the state as (B, H, N, P) already
        return out, {"conv": conv_state, "h": hT.reshape(B, H, N, P)
                     if hT.ndim == 3 else hT}
    return out


def mamba_cache(cfg, batch: int, dtype, device, stack: int = 0) -> dict:
    """Zero decode state: ``conv`` in ``dtype`` (the compute dtype), ``h``
    in f32; ``stack`` > 0 prepends a layer axis."""
    di, H, P, N, G, conv_dim, ck = _dims(cfg)
    lead = (stack,) if stack else ()
    return {
        "conv": torch.zeros(lead + (batch, ck - 1, conv_dim), dtype=dtype,
                            device=device),
        "h": torch.zeros(lead + (batch, H, N, P), dtype=torch.float32,
                         device=device),
    }


def _recurrence(h, xs, dt, A, Bm, Cm):
    """One step of the SSD recurrence on h (B, H, N, P), xs (B, H, P), dt
    (B, H), A (H,), Bm, Cm (B, H, N): (y (B, H, P), h_new).  DTensors run
    it through ``local_map`` on each rank's batch rows and heads (h's
    shards), where the flat (B·H) layout of the step exists only
    locally."""
    def step(h, xs, dt, A, Bm, Cm):
        B, H, N, P = h.shape
        y, h_new = ssd_ref.ssd_decode_step(
            h.reshape(B * H, N, P), xs.reshape(B * H, P), dt.reshape(B * H),
            A.repeat(B), Bm.reshape(B * H, N), Cm.reshape(B * H, N))
        return y.reshape(B, H, P), h_new.reshape(B, H, N, P)

    if not is_dtensor(h):
        return step(h, xs, dt, A, Bm, Cm)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    hp = [pl if isinstance(pl, Shard) and pl.dim in (0, 1) else Replicate()
          for pl in h.placements]
    ap = [Shard(0) if pl == Shard(1) else Replicate() for pl in hp]
    return local_map(step, out_placements=(hp, hp),
                     in_placements=(hp, hp, hp, ap, hp, hp),
                     device_mesh=h.device_mesh,
                     redistribute_inputs=True)(h, xs, dt, A, Bm, Cm)


def mamba_decode_step(p: dict, cfg, x: torch.Tensor, cache: dict,
                      advance=None):
    """x: (B, 1, D) single step.  Returns (out (B, 1, D), new_cache).

    ``advance`` (B,) bool: rows with False keep their old state (continuous
    batching: inactive slots)."""
    B = x.shape[0]
    di, H, P, N, G, conv_dim, ck = _dims(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xBC, dt = _split_proj(cfg, proj)  # (B, 1, ·)
    window = torch.cat([cache["conv"], xBC], dim=1)  # (B, ck, C)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
    xBC_t = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)  # (B, C)
    new_conv = window[:, 1:, :]
    xs = xBC_t[:, :di].reshape(B, H, P)
    Bm = xBC_t[:, di:di + G * N].reshape(B, G, N)
    Cm = xBC_t[:, di + G * N:].reshape(B, G, N)
    if G == 1:
        Bm, Cm = Bm.expand(B, H, N), Cm.expand(B, H, N)
    else:
        Bm = Bm.repeat_interleave(H // G, dim=1)
        Cm = Cm.repeat_interleave(H // G, dim=1)
    dtv = F.softplus(dt.float()[:, 0, :] + p["dt_bias"].float())  # (B, H)
    A = -torch.exp(p["A_log"].float())
    y, h_new = _recurrence(cache["h"], xs, dtv, A, Bm, Cm)
    y = y + p["D_skip"].float()[None, :, None] * xs.float()
    y = y.reshape(B, 1, di).to(x.dtype)
    y = layers.rmsnorm(p["gate_norm"], y * F.silu(z), eps=cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if advance is not None:
        adv = advance.to(x.device)
        new_conv = torch.where(adv[:, None, None], new_conv, cache["conv"])
        h_new = torch.where(adv[:, None, None, None], h_new, cache["h"])
    return out, {"conv": new_conv, "h": h_new}
