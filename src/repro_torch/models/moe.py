"""Mixture-of-Experts FFN in PyTorch: the capacity path and the ragged
grouped-matmul path.

The JAX package's ``models/moe.py`` on plain dicts of tensors with its leaf
names (``router``, ``experts`` {``gate``, ``up``, ``down``} stacked
``(E, D, F)``, ``shared``), stacked once more ``(L, ...)`` in a segment.

* The capacity path (the configs' default): each batch row is a group with
  capacity C = ceil(S · k / E · cf); dispatch and combine are (B, S, E, C)
  one-hots contracted with einsums, and choices past an expert's capacity
  are dropped.  Its aux loss is averaged over the groups.
* The ragged path (``cfg.moe_ragged``): tokens are sorted by expert and
  every expert product is one launch of the grouped-matmul kernel
  (:mod:`..kernels.moe_gmm`) on the card, the plain version on the CPU.  It
  drops nothing, so it equals the capacity path wherever that one is
  dropless.  Its aux loss is global over the tokens.

The router runs in float32; the expert weights enter the products in the
compute dtype (the capacity path casts them, the ragged path's kernel
rounds them in registers and writes no cast copy).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.moe_gmm import ops as gmm_ops
from ..parallel.axes import act, is_dtensor
from . import layers

__all__ = ["moe_init", "moe_apply", "moe_apply_ragged", "capacity"]


def capacity(cfg_moe, seq_len: int) -> int:
    c = int(math.ceil(seq_len * cfg_moe.top_k / cfg_moe.n_experts
                      * cfg_moe.capacity_factor))
    return max(c, cfg_moe.top_k)


def moe_init(gen: torch.Generator, cfg, dtype, stack: int = 0) -> dict:
    """The router (f32), the stacked experts and the shared experts' MLP,
    each stacked ``stack`` deep (0: unstacked)."""
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_expert
    p = {
        "router": layers.dense_init(gen, (D, E), torch.float32, scale=0.02,
                                    stack=stack),
        "experts": {
            "gate": _stack_init(gen, (E, D, Fe), dtype, stack=stack),
            "up": _stack_init(gen, (E, D, Fe), dtype, stack=stack),
            "down": _stack_init(gen, (E, Fe, D), dtype,
                                scale=1.0 / math.sqrt(Fe), stack=stack),
        },
    }
    if m.n_shared:
        p["shared"] = layers.mlp_init(gen, cfg, dtype, d_ff=m.n_shared * Fe,
                                      stack=stack)
    return p


def _stack_init(gen: torch.Generator, shape, dtype,
                scale: Optional[float] = None, *, stack: int = 0):
    """N(0, 1) · scale, scale 1/sqrt(shape[1]) by default.  Scaled in
    place: a full-width expert stack is ~20 GB of f32, and a second copy
    would not fit beside the rest of the weights."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[1])
    full = ((stack,) if stack else ()) + tuple(shape)
    return torch.randn(full, generator=gen, device=gen.device) \
        .mul_(scale).to(dtype)


def _route_groups(probs: torch.Tensor, k: int, C: int):
    """probs: (B, S, E) f32 → dispatch (B, S, E, C) 0/1, combine f32, the
    kept gates' sum (B, S), and each group's aux term.  A loop over
    the k choices, mesh-tf style; a choice at position ≥ C in its expert's
    buffer is dropped (its one-hot row is zero, as ``jax.nn.one_hot`` gives
    for an index out of range)."""
    B, S, E = probs.shape
    cd = probs.dtype
    dispatch = torch.zeros((B, S, E, C), dtype=cd, device=probs.device)
    combine = torch.zeros_like(dispatch)
    count_e = torch.zeros((B, E), dtype=cd, device=probs.device)
    gates_sum = torch.zeros((B, S), dtype=cd, device=probs.device)
    topv, topi = torch.topk(probs, k, dim=-1)  # (B, S, k), descending
    for choice in range(k):
        g = topv[..., choice]
        e_onehot = F.one_hot(topi[..., choice], E).to(cd)
        # position of each token within its expert's capacity buffer
        pos = torch.cumsum(e_onehot, dim=1) - e_onehot + count_e[:, None, :]
        pos_tok = torch.sum(pos * e_onehot, dim=-1)  # (B, S)
        keep = (pos_tok < C).to(cd)
        idx = torch.where(pos_tok < C, pos_tok, 0).long()
        pos_onehot = F.one_hot(idx, C).to(cd) * keep[..., None]
        slot = e_onehot[..., None] * pos_onehot[:, :, None, :]
        dispatch += slot
        combine += slot * g[..., None, None]
        count_e = count_e + torch.sum(e_onehot * keep[..., None], dim=1)
        gates_sum = gates_sum + g * keep
    # aux loss (switch-style): each group's Σ_e f_e · p̄_e (the callers
    # take E times their mean)
    frac_tokens = torch.mean(F.one_hot(topi[..., 0], E).to(cd), dim=1)
    mean_probs = torch.mean(probs, dim=1)
    return dispatch, combine, gates_sum, torch.sum(frac_tokens * mean_probs,
                                                   dim=-1)


def _dispatch_combine(probs: torch.Tensor, k: int, C: int):
    """probs: (B, S, E) f32 → dispatch (B, S, E, C) 0/1, combine f32, the
    kept gates' sum (B, S), and the aux load-balancing loss.  Each group
    (batch row) is routed on its own (:func:`_route_groups`), so DTensor
    probs are routed through ``local_map`` on each rank's rows."""
    if is_dtensor(probs):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        pp = [pl if pl == Shard(0) else Replicate()
              for pl in probs.placements]
        route = local_map(_route_groups, out_placements=(pp,) * 4,
                          in_placements=(pp, None, None),
                          device_mesh=probs.device_mesh,
                          redistribute_inputs=True)
    else:
        route = _route_groups
    dispatch, combine, gates_sum, per_group = route(probs, k, C)
    return dispatch, combine, gates_sum, probs.shape[-1] * torch.mean(
        per_group)


def moe_apply_ragged(p: dict, cfg, x: torch.Tensor):
    """Capacity-free MoE through the grouped-matmul op: one row per
    (token, choice), each expert product one kernel launch on the card.
    x: (B, S, D) → (y, aux)."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    cd = x.dtype
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)  # (T, k)
    if m.router_norm_topk:
        topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    xs_rep = torch.repeat_interleave(xf, k, dim=0)  # (T·k, D)
    eo = topi.reshape(-1)
    w = p["experts"]  # rounded to cd by the op
    g = gmm_ops.moe_apply(xs_rep, eo, w["gate"])
    u = gmm_ops.moe_apply(xs_rep, eo, w["up"])
    h = F.silu(g) * u
    yd = gmm_ops.moe_apply(h, eo, w["down"])
    y = torch.sum(yd.reshape(T, k, D) * topv[..., None].to(yd.dtype), dim=1)
    y = y.reshape(B, S, D).to(cd)
    frac = torch.mean(F.one_hot(topi[:, 0], E).float(), dim=0)
    aux = E * torch.sum(frac * torch.mean(probs, dim=0))
    if m.n_shared:
        y = y + layers.mlp(p["shared"], cfg, x, act_fn="swiglu")
    return act(y, "batch", "seq", "d"), aux


def _combine_experts(combine, ye):
    """y (B, S, D) = Σ_e,c combine (B, S, E, C) · ye (E, B, C, D).  With
    DTensors each rank sums over its own experts and capacity slots
    through ``local_map`` (the einsum's flattened (e, c) dim has no
    sharding rule), leaving a partial sum over the expert ways."""
    if not is_dtensor(ye):
        return torch.einsum("bsec,ebcd->bsd", combine, ye)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    yp = [pl if pl in (Shard(0), Shard(1)) else Replicate()
          for pl in ye.placements]
    cp = [{Shard(0): Shard(2), Shard(1): Shard(0)}.get(pl, pl) for pl in yp]
    op = [{Shard(0): Partial(), Shard(1): Shard(0)}.get(pl, pl) for pl in yp]
    return local_map(lambda c, e: torch.einsum("bsec,ebcd->bsd", c, e),
                     out_placements=op, in_placements=(cp, yp),
                     device_mesh=ye.device_mesh,
                     redistribute_inputs=True)(combine, ye)


def moe_apply(p: dict, cfg, x: torch.Tensor):
    """x: (B, S, D) → (y, aux_loss)."""
    if cfg.moe_ragged:
        return moe_apply_ragged(p, cfg, x)
    m = cfg.moe
    S = x.shape[1]
    k = m.top_k
    C = capacity(m, S)
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, gates_sum, aux = _dispatch_combine(probs, k, C)
    if m.router_norm_topk:
        combine = combine / torch.clamp_min(gates_sum[..., None, None], 1e-9)
    cd = x.dtype
    dispatch = act(dispatch.to(cd), "batch", "seq", "expert", None)
    combine = act(combine.float(), "batch", "seq", "expert", None)
    # gather expert inputs: (E, B, C, D)
    xe = act(torch.einsum("bsec,bsd->ebcd", dispatch, x),
             "expert", "batch", None, "d")
    w = p["experts"]
    g = torch.einsum("ebcd,edf->ebcf", xe, w["gate"].to(cd))
    u = torch.einsum("ebcd,edf->ebcf", xe, w["up"].to(cd))
    h = act(F.silu(g) * u, "expert", "batch", None, "ff")
    ye = act(torch.einsum("ebcf,efd->ebcd", h, w["down"].to(cd)),
             "expert", "batch", None, "d")
    y = _combine_experts(combine.to(cd), ye)
    if m.n_shared:
        y = y + layers.mlp(p["shared"], cfg, x, act_fn="swiglu")
    return act(y, "batch", "seq", "d"), aux
