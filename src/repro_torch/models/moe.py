"""Mixture-of-Experts FFN in PyTorch: the capacity path and the ragged
grouped-matmul path.

The JAX package's ``models/moe.py`` on plain dicts of tensors with its leaf
names (``router``, ``experts`` {``gate``, ``up``, ``down``} stacked
``(E, D, F)``, ``shared``), stacked once more ``(L, ...)`` in a segment.

* The capacity path (the configs' default): each batch row is a group with
  capacity C = ceil(S · k / E · cf); dispatch and combine are (B, S, E, C)
  slots scattered from each token's choices and contracted with einsums,
  and choices past an expert's capacity are dropped.  On a mesh each rank
  builds the slots of its own experts only.  Its aux loss is averaged
  over the groups.
* The ragged path (``cfg.moe_ragged``): tokens are sorted by expert and
  every expert product is one launch of the grouped-matmul kernel
  (:mod:`..kernels.moe_gmm`) on the card, the plain version on the CPU.  It
  drops nothing, so it equals the capacity path wherever that one is
  dropless.  Its aux loss is global over the tokens.  On a mesh each rank
  routes its own tokens and multiplies on its own slice of the experts
  (:func:`_ragged_sharded`), as GSPMD splits the JAX package's.

The router runs in float32; the expert weights enter the products in the
compute dtype (the capacity path casts them, the ragged path's kernel
rounds them in registers and writes no cast copy).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.moe_gmm import ops as gmm_ops
from ..parallel.axes import act, current_ctx, is_dtensor, placements
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
    """N(0, 1) · scale, scale 1/sqrt(shape[1]) by default, through
    :func:`layers.normal`: a full-width expert stack is ~20–40 GB of f32,
    and a second copy would not fit beside the rest of the weights."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[1])
    full = ((stack,) if stack else ()) + tuple(shape)
    return layers.normal(gen, full, dtype, scale)


def _route_choices(probs: torch.Tensor, k: int, C: int):
    """probs: (B, S, E) f32 → each token's k choices, mesh-tf style: the
    gates ``topv`` and experts ``topi`` (B, S, k), each choice's position
    ``pos`` (B, S, k) in its expert's capacity buffer (C where it is
    dropped: position ≥ C), the kept gates' sum (B, S) and each group's
    (batch row's) aux term Σ_e f_e · p̄_e (the callers take E times their
    mean).  Only (B, S, E) tensors: cheap next to the (B, S, E, C) slots."""
    B, S, E = probs.shape
    cd = probs.dtype
    count_e = torch.zeros((B, E), dtype=cd, device=probs.device)
    gates_sum = torch.zeros((B, S), dtype=cd, device=probs.device)
    topv, topi = torch.topk(probs, k, dim=-1)  # (B, S, k), descending
    pos = []
    for choice in range(k):
        g = topv[..., choice]
        e_onehot = F.one_hot(topi[..., choice], E).to(cd)
        # position of each token within its expert's capacity buffer
        at = torch.cumsum(e_onehot, dim=1) - e_onehot + count_e[:, None, :]
        pos_tok = torch.sum(at * e_onehot, dim=-1)  # (B, S)
        keep = (pos_tok < C).to(cd)
        pos.append(torch.where(pos_tok < C, pos_tok, C).long())
        count_e = count_e + torch.sum(e_onehot * keep[..., None], dim=1)
        gates_sum = gates_sum + g * keep
    frac_tokens = torch.mean(F.one_hot(topi[..., 0], E).to(cd), dim=1)
    mean_probs = torch.mean(probs, dim=1)
    return (topv, topi, torch.stack(pos, dim=-1), gates_sum,
            torch.sum(frac_tokens * mean_probs, dim=-1))


def _slots(topv, topi, pos, C: int, lo: int, El: int):
    """dispatch (B, S, El, C) 0/1 and combine f32 of the experts
    [lo, lo + El), scattered from the choices of :func:`_route_choices`:
    a kept choice of one of these experts puts 1 (dispatch) and its gate
    (combine) at (b, s, e − lo, pos); a choice that is dropped or of
    another expert adds 0 at column 0 (a token picks k distinct experts,
    so no entry takes two values)."""
    B, S, k = topi.shape
    mine = (topi >= lo) & (topi < lo + El) & (pos < C)
    col = torch.where(mine, (topi - lo) * C + pos, 0).reshape(B * S, k)
    m = mine.to(topv.dtype).reshape(B * S, k)
    dispatch = topv.new_zeros((B * S, El * C)).scatter_add_(1, col, m)
    combine = topv.new_zeros((B * S, El * C)).scatter_add_(
        1, col, topv.reshape(B * S, k) * m)
    return (dispatch.reshape(B, S, El, C), combine.reshape(B, S, El, C))


def _dispatch_combine(probs: torch.Tensor, k: int, C: int):
    """probs: (B, S, E) f32 → dispatch (B, S, E, C) 0/1, combine f32, the
    kept gates' sum (B, S), and the aux load-balancing loss.  Each group
    (batch row) is routed on its own.

    DTensor probs are routed through ``local_map`` in two steps.  Every
    rank takes the choices of its own rows over all E experts
    (:func:`_route_choices`, on (B, S, E) tensors), so ``keep``, the gates'
    sum and the aux term are whole and equal on the ranks that split the
    experts; then each builds the slots of its own experts only
    (:func:`_slots`), returned ``Shard(2)`` over the expert ways that the
    ``expert`` rule gives (B, S, E, C), so no rank holds all E experts'
    columns.  A gate's gradient comes from the one rank whose columns hold
    it (a partial sum over the expert ways)."""
    if not is_dtensor(probs):
        topv, topi, pos, gates_sum, per_group = _route_choices(probs, k, C)
        dispatch, combine = _slots(topv, topi, pos, C, 0, probs.shape[-1])
    else:
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        dm = probs.device_mesh
        n = dm.ndim
        ctx = current_ctx()
        want = (placements(ctx.act_spec((*probs.shape, C), "batch", "seq",
                                        "expert", None), ctx.mesh)
                if ctx.mesh is not None else [Replicate()] * n)
        ed = [i for i in range(n) if want[i] == Shard(2)]
        rp = [pl if pl == Shard(0) and i not in ed else Replicate()
              for i, pl in enumerate(probs.placements)]
        topv, topi, pos, gates_sum, per_group = local_map(
            functools.partial(_route_choices, k=k, C=C),
            out_placements=(rp,) * 5, in_placements=(rp,), device_mesh=dm,
            redistribute_inputs=True)(probs)
        ways, lo = 1, 0
        for i in ed:  # this rank's first expert: Shard(2) splits in mesh order
            ways *= dm.size(i)
            lo = lo * dm.size(i) + dm.get_local_rank(i)
        El = probs.shape[-1] // ways
        sp = [Shard(2) if i in ed else rp[i] for i in range(n)]
        vg = [Partial() if i in ed else rp[i] for i in range(n)]
        dispatch, combine = local_map(
            functools.partial(_slots, C=C, lo=lo * El, El=El),
            out_placements=(sp, sp), in_placements=(rp, rp, rp),
            in_grad_placements=(vg, rp, rp), device_mesh=dm,
            redistribute_inputs=True)(topv, topi, pos)
    return dispatch, combine, gates_sum, probs.shape[-1] * torch.mean(
        per_group)


def _ragged(x, router, gate, up, down, *, m, lo: int = 0):
    """The ragged path on plain tensors, over the experts ``[lo, lo + E')``
    that ``gate``, ``up`` and ``down`` (E', ...) hold: x (B, S, D) → y
    (B, S, D) in x's dtype, and the aux loss's per-expert sums over these
    tokens, the top-choice counts and the router probabilities (E,) f32.
    A choice of another expert routes as id E' and adds 0 to y (the op's
    contract), and the sums keep only the held experts' columns, so each
    is a share whose sum over the ranks that split the experts is the
    whole."""
    B, S, D = x.shape
    E, El, k = m.n_experts, gate.shape[0], m.top_k
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)  # (T, k)
    if m.router_norm_topk:
        topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    xs_rep = torch.repeat_interleave(xf, k, dim=0)  # (T·k, D)
    eo = topi.reshape(-1)
    if El < E:  # another rank's expert: the op's phantom id El
        eo = torch.where((eo >= lo) & (eo < lo + El), eo - lo, El)
    # the weights are rounded to x's dtype by the op
    h = F.silu(gmm_ops.moe_apply(xs_rep, eo, gate)) \
        * gmm_ops.moe_apply(xs_rep, eo, up)
    yd = gmm_ops.moe_apply(h, eo, down)
    y = torch.sum(yd.reshape(T, k, D) * topv[..., None].to(yd.dtype), dim=1)
    # scatter_add_, not one_hot: on the card one_hot reads its input's
    # range back to the host
    count = probs.new_zeros(E).scatter_add_(0, topi[:, 0],
                                            probs.new_ones(T))
    psum = probs.sum(0)
    if El < E:
        count, psum = (F.pad(t[lo:lo + El], (lo, E - lo - El))
                       for t in (count, psum))
    return y.reshape(B, S, D).to(x.dtype), count, psum


def _ragged_sharded(p: dict, m, x):
    """:func:`_ragged` of DTensors through ``local_map``: each rank routes
    its own tokens (x's batch or sequence shards on the axes that do not
    split the experts; x is gathered over those that do) and runs the
    grouped products (the kernel on the card) on its own slice of the
    experts, sharded on dim 0 by the ``expert`` rule.  y comes back as a
    partial sum over the expert ways, the sums as partial sums over the
    token and expert ways.  Where the rules leave the experts whole, every
    rank holds all of them and y is not partial.  The gradients follow
    the shares: x's is partial over the expert ways, the router's over
    both, the experts' over the token ways."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w = p["experts"]
    dm = x.device_mesh
    n = dm.ndim
    wp = [Shard(0) if pl == Shard(0) else Replicate()
          for pl in w["gate"].placements]
    ed = [i for i in range(n) if wp[i] == Shard(0)]
    xp = [pl if i not in ed and isinstance(pl, Shard) and pl.dim in (0, 1)
          else Replicate() for i, pl in enumerate(x.placements)]
    td = [i for i in range(n) if xp[i] != Replicate()]
    ways, lo = 1, 0
    for i in ed:  # this rank's first expert: Shard(0) splits in mesh order
        ways *= dm.size(i)
        lo = lo * dm.size(i) + dm.get_local_rank(i)
    lo *= m.n_experts // ways
    rep = [Replicate()] * n
    yp = [Partial() if i in ed else pl for i, pl in enumerate(xp)]
    sp = [Partial() if i in ed or i in td else Replicate() for i in range(n)]
    xg = [Partial() if i in ed else pl for i, pl in enumerate(xp)]
    wg = [Partial() if i in td else pl for i, pl in enumerate(wp)]
    y, count, psum = local_map(
        lambda *t: _ragged(*t, m=m, lo=lo), out_placements=(yp, sp, sp),
        in_placements=(xp, rep, wp, wp, wp),
        in_grad_placements=(xg, sp, wg, wg, wg), device_mesh=dm,
        redistribute_inputs=True)(x, p["router"], w["gate"], w["up"],
                                  w["down"])
    return y, count.redistribute(dm, rep), psum.redistribute(dm, rep)


def moe_apply_ragged(p: dict, cfg, x: torch.Tensor):
    """Capacity-free MoE through the grouped-matmul op: one row per
    (token, choice), each expert product one kernel launch on the card.
    x: (B, S, D) → (y, aux).  DTensors go through :func:`_ragged_sharded`;
    the aux loss, E · Σ_e frac_e · mean_prob_e over all the tokens, is
    taken from the sums after they are reduced over the ranks."""
    m = cfg.moe
    if is_dtensor(x):
        y, count, psum = _ragged_sharded(p, m, x)
    else:
        w = p["experts"]
        y, count, psum = _ragged(x, p["router"], w["gate"], w["up"],
                                 w["down"], m=m)
    T = x.shape[0] * x.shape[1]
    aux = m.n_experts * torch.sum((count / T) * (psum / T))
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
        norm = torch.clamp_min(gates_sum[..., None, None], 1e-9)
        # in place where no gradient needs combine as it was
        combine = (combine / norm if combine.requires_grad
                   else combine.div_(norm))
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
