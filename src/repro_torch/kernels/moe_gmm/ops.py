"""Public grouped-matmul op: sort and pad the tokens by expert, run the
CUDA kernel, unsort.  The contract is what the MoE layer's ragged path
needs.

On the card the kernel runs or the call raises; nothing falls back to the
plain version.  The routing stays on the device without a host sync: the
padded capacity ``(⌈T / tile_m⌉ + E + 1) · tile_m`` is a Python int (the
one more group holds the rows of experts past w's E), the
per-expert counts come from ``scatter_add_`` (``bincount`` on CUDA reads
its maximum back to the host), and the number of valid rows of each tile
is computed beside the tile's expert, so the kernel skips the padding.
The weights are rounded to x's dtype before the product (the kernel does
it in registers, the plain version with an explicit cast), so a float32
``w`` and a bfloat16 ``x`` give the numbers of ``w.to(x.dtype)``.
Under grad mode the CUDA branch runs the launch inside a
``torch.autograd.Function`` (:func:`.._autograd.launch`) whose backward is
that of the plain grouped product (:func:`.ref.gmm`), recomputed from the
saved x and w; the routing indices carry no gradient.  The CPU branch is
the plain version itself.  ``moe_apply.launches`` counts the kernel
launches.

The launch is the custom op ``torch.ops.repro_torch.moe_gmm``.  Given
tensors that hold no data on the card's path (see
:func:`repro_torch.device.card_model`) its fake rule returns y (T, F) in
x's dtype and builds, calls and counts nothing; ``FlopCounterMode`` counts
it as 2·T·D·F.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from ...device import on_card
from .. import _autograd, _launches
from . import kernel, ref

__all__ = ["route", "sort_by_expert", "moe_apply"]


def _route(expert_of: torch.Tensor, n_expert: int, tile_m: int):
    """The routing of :func:`sort_by_expert` without touching the tokens:
    ``(order, slot, tile_expert, tile_rows, cap)``, all on the device but
    ``cap`` (a Python int), with no host sync."""
    T = expert_of.shape[0]
    dev = expert_of.device
    e = expert_of.long()
    order = torch.argsort(e, stable=True)
    sorted_e = e[order]
    counts = torch.zeros(n_expert, dtype=torch.long, device=dev) \
        .scatter_add_(0, e, torch.ones_like(e))
    padded = (counts + tile_m - 1) // tile_m * tile_m
    cap = ((T + tile_m - 1) // tile_m + n_expert) * tile_m
    padded_end = torch.cumsum(padded, 0)
    padded_start = padded_end - padded
    group_start = torch.cumsum(counts, 0) - counts
    slot = padded_start[sorted_e] + torch.arange(T, device=dev) \
        - group_start[sorted_e]
    tile_row = torch.arange(cap // tile_m, device=dev) * tile_m
    tile_expert = torch.searchsorted(padded_end, tile_row, right=True) \
        .clamp_(max=n_expert - 1)
    tile_rows = (counts[tile_expert] - (tile_row - padded_start[tile_expert])
                 ).clamp_(0, tile_m)
    return (order, slot, tile_expert.to(torch.int32),
            tile_rows.to(torch.int32), cap)


def route(expert_of: torch.Tensor, n_expert: int, tile_m: int):
    """The routing arguments of ``kernel.launch``: ``(tile_expert,
    tile_rows, row_src)``.  ``row_src`` (cap,) int32 names the token row
    that each valid padded row reads from x and writes in y; its padding
    rows are left unset, since the kernel reads only valid rows."""
    order, slot, tile_expert, tile_rows, cap = _route(expert_of, n_expert,
                                                      tile_m)
    row_src = torch.empty((cap,), dtype=torch.int32,
                          device=expert_of.device) \
        .index_copy_(0, slot, order.to(torch.int32))
    return tile_expert, tile_rows, row_src


def sort_by_expert(x: torch.Tensor, expert_of: torch.Tensor, n_expert: int,
                   tile_m: int):
    """Sort tokens by expert and pad each group to a tile_m multiple.

    Returns ``(x_padded, tile_expert, (order, slot), valid, tile_rows)``:
    ``x_padded`` (cap, ...) holds sorted token ``i`` (``x[order[i]]``) at
    row ``slot[i]`` and zeros elsewhere; ``valid`` (cap,) marks the token
    rows; ``tile_expert`` (cap / tile_m,) int32 is the expert owning each
    row tile (padding tiles past the last group take ``n_expert - 1``) and
    ``tile_rows`` (cap / tile_m,) int32 the number of token rows at the
    head of each tile.  The first four are the JAX package's
    ``sort_by_expert``; ``tile_rows`` is what lets the kernel skip the
    padding.  The op itself builds no padded copy (it routes with
    :func:`route`): this is the JAX-parity surface that the tests hold
    against the reference."""
    order, slot, tile_expert, tile_rows, cap = _route(expert_of, n_expert,
                                                      tile_m)
    x_p = x.new_zeros((cap,) + tuple(x.shape[1:]))
    x_p[slot] = x[order]
    # index_fill_ takes the value as a scalar: ``valid[slot] = True`` would
    # copy it from the host and synchronise
    valid = torch.zeros((cap,), dtype=torch.bool, device=x.device) \
        .index_fill_(0, slot, True)
    return x_p, tile_expert, (order, slot), valid, tile_rows


def moe_apply(x: torch.Tensor, expert_of: torch.Tensor, w: torch.Tensor, *,
              tile_m: int = 128) -> torch.Tensor:
    """Per-token expert matmul.  x: (T, D); expert_of: (T,) int ≥ 0;
    w: (E, D, F).  Returns (T, F) in x's dtype, summed in float32 with w
    rounded to x's dtype.  A row whose expert is ≥ E belongs to an expert
    this rank does not hold (the experts are split over the ranks of a
    mesh): its row of y is 0, and so is its gradient.

    A CPU tensor takes the plain version (:func:`ref.gmm`).  A CUDA tensor
    is routed as :func:`sort_by_expert` routes it and multiplied by the
    kernel (f32, bf16 or f16 x and w; a strided x or w is copied once, an
    f16 w beside a bf16 x is rounded to bf16 once), which reads each
    token's row of x through the routing and writes its row of y in place:
    no padded copy is made, and the padding is never computed.  Rows of
    no local expert are routed as one more group, expert E, whose tiles
    the kernel skips."""
    if x.ndim != 2 or expert_of.ndim != 1 or w.ndim != 3 \
            or expert_of.shape[0] != x.shape[0] or w.shape[1] != x.shape[1]:
        raise ValueError(f"moe_apply: x (T, D), expert_of (T,) and w "
                         f"(E, D, F) required, got {tuple(x.shape)}, "
                         f"{tuple(expert_of.shape)}, {tuple(w.shape)}")
    if expert_of.dtype.is_floating_point or expert_of.dtype == torch.bool:
        raise TypeError(f"moe_apply: expert_of must be an integer tensor, "
                        f"got {expert_of.dtype}")
    if not on_card(x):
        if x.device.type == "cpu":
            return ref.gmm(x, expert_of, w)
        raise ValueError(f"moe_apply: unsupported device {x.device}")
    if expert_of.device != x.device or w.device != x.device:
        raise ValueError("moe_apply: x, expert_of and w must lie on one "
                         "device")
    if x.dtype not in kernel.DTYPES or w.dtype not in kernel.DTYPES:
        raise TypeError(f"moe_apply: the CUDA kernel takes x and w in "
                        f"float32, bfloat16 or float16, got {x.dtype}, "
                        f"{w.dtype}")
    return _autograd.launch(_kernel_op, _plain, x, expert_of, w,
                            tile_m=tile_m)


moe_apply.launches = 0


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=(),
                         device_types="cuda")
def _kernel_op(x: torch.Tensor, expert_of: torch.Tensor, w: torch.Tensor,
               tile_m: int) -> torch.Tensor:
    return _launch(x, expert_of, w, tile_m=tile_m)


@_kernel_op.register_fake
def _(x, expert_of, w, tile_m):
    return x.new_empty((x.shape[0], w.shape[2]))


@register_flop_formula(torch.ops.repro_torch.moe_gmm)
def _flops(x_shape, e_shape, w_shape, *_, out_shape=None, **__) -> int:
    """2·rows·D·F: the kernel computes every token row once and skips the
    padding.  Rows of no local expert count too: the formula is one
    device's work, of which a rank of an expert-split mesh does its
    share."""
    return 2 * x_shape[0] * x_shape[1] * w_shape[2]


def _plain(x, expert_of, w, *, tile_m: int) -> torch.Tensor:
    del tile_m
    return ref.gmm(x, expert_of, w)


def _launch(x, expert_of, w, *, tile_m: int) -> torch.Tensor:
    """One launch on validated CUDA tensors."""
    if x.dtype == torch.bfloat16 and w.dtype == torch.float16:
        # the tensor cores stage w as bf16 bits: round it once here, the
        # cast the plain version makes (w to x's dtype)
        w = w.to(torch.bfloat16)
    # the kernel reads x's rows and w in place: a strided one is copied once
    y = _routed_product(x.contiguous(), expert_of, w.contiguous(), tile_m,
                        kernel.launch)
    _launches.count(moe_apply)
    return y


def _routed_product(x, expert_of, w, tile_m, launch):
    """Route (:func:`route`) and ``launch(x, tile_expert, tile_rows,
    row_src, w, y, tile_m)``: the kernel gathers x's rows and scatters y's
    itself, so no padded copy of either is made.  Rows of an expert ≥ E
    form group E, whose tiles the kernel skips (``e >= n_expert``): y
    starts zeroed, so their rows stay 0."""
    E = w.shape[0]
    tile_expert, tile_rows, row_src = route(expert_of.clamp(max=E), E + 1,
                                            tile_m)
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    launch(x, tile_expert, tile_rows, row_src, w, y, tile_m)
    return y
