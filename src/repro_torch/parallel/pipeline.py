"""Pipeline parallelism — the paper's Pipeline functional at cluster scale.

The JAX package's ``parallel/pipeline.py``.  GPipe schedule over a
``stage`` mesh axis: stage s holds layers [s·L/S, (s+1)·L/S); microbatches
stream through in M + S − 1 ticks; the stage-to-stage channel is a
point-to-point send (:func:`.collectives.ppermute`) — a synchronous,
unbuffered, point-to-point communication, i.e. *exactly* a CSP channel
between Worker processes.  The bubble fraction is (S-1)/(M+S-1).

Every rank runs the same program on the whole (replicated) input and the
whole stacked parameter tree, takes its own stage's slice of it, and gets
the last stage's output back (a broadcast along the stage axis), as the
reference's caller reads the last stage's buffer.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils._pytree as pytree

from ..core.stream import stack_microbatches
from .collectives import broadcast, ppermute

__all__ = ["pipeline_forward", "split_stages"]


def split_stages(stacked_params, n_stages: int):
    """(L, ...) layer-stacked params → (n_stages, L/S, ...)."""

    def _split(leaf):
        L = leaf.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return leaf.reshape(n_stages, L // n_stages, *leaf.shape[1:])

    return pytree.tree_map(_split, stacked_params)


def pipeline_forward(block_fn: Callable, stage_params, x, *, mesh,
                     n_stages: int, n_micro: int, stage_axis: str = "stage"):
    """Run ``x`` through all stages with a GPipe schedule.

    block_fn(local_params, h) -> h  applies one stage's layer stack
    stage_params: pytree with leading (n_stages, L/S, ...)
    x: (B, S, D) with B % n_micro == 0.

    Returns (B, S, D) on every rank, numerically identical to applying all
    layers in order.
    """
    if mesh.shape[stage_axis] != n_stages:
        raise ValueError(f"pipeline_forward: axis {stage_axis!r} has "
                         f"{mesh.shape[stage_axis]} ranks, not {n_stages}")
    B = x.shape[0]
    # the streaming runtime's microbatch schedule
    x_mb = stack_microbatches(x, n_micro)
    sid = mesh.coord(stage_axis)
    params_local = pytree.tree_map(lambda l: l[sid], stage_params)
    first, last = sid == 0, sid == n_stages - 1
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    out = torch.zeros_like(x_mb)
    recv = torch.zeros_like(x_mb[0])
    for t in range(n_micro + n_stages - 1):
        m = t - sid  # microbatch index this stage works on
        m_c = min(max(m, 0), n_micro - 1)
        h_out = block_fn(params_local, x_mb[m_c] if first else recv)
        if last and 0 <= m < n_micro:  # last stage: its finished microbatch
            out[m_c] = h_out
        # channel to the next stage (CSP rendezvous)
        recv = ppermute(h_out, mesh, stage_axis, perm)
    out = broadcast(out, mesh, stage_axis, src=n_stages - 1)
    return out.reshape(B, *x.shape[1:])
