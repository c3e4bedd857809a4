"""Plain PyTorch versions of the grouped expert matmul (the MoE hotspot).

:func:`gmm` is the oracle: every token through its own expert, computed in
float32 with the weights first rounded to the tokens' dtype, and the result
stored in the tokens' dtype.  The JAX package's oracle gathers a (T, D, F)
weight tensor; here the same function is a loop over the experts present,
which at the deepseek-moe-16b forward's shape (T·k = 49,152 rows, D 2048,
F 1408) avoids a 141 G-element gather.  :func:`gmm_tiled_ref` is the tile
contract of the kernel at small sizes.  On a CPU tensor the public op
(:mod:`.ops`) runs :func:`gmm`; on the card it is the reference the CUDA
kernel is held against.
"""

from __future__ import annotations

import torch


def gmm(x: torch.Tensor, expert_of: torch.Tensor,
        w: torch.Tensor) -> torch.Tensor:
    """x: (T, D) tokens; expert_of: (T,) int expert id per token; w:
    (E, D, F).  Returns (T, F) in x's dtype: each token through its own
    expert, ``(x.float() @ w[e].to(x.dtype).float()).to(x.dtype)``, and 0
    for a token of an expert ≥ E (one this rank does not hold)."""
    T, E, F = x.shape[0], w.shape[0], w.shape[2]
    order = torch.argsort(expert_of, stable=True)
    # ids ≥ E sort last and are counted apart: their rows stay 0
    counts = torch.bincount(expert_of.long().clamp(max=E),
                            minlength=E + 1)[:E].tolist()
    xs = x[order]
    ys = torch.zeros((T, F), dtype=x.dtype, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            rows = slice(start, start + n)
            ys[rows] = (xs[rows].float()
                        @ w[e].to(x.dtype).float()).to(x.dtype)
            start += n
    y = torch.empty_like(ys)
    y[order] = ys
    return y


def gmm_tiled_ref(x: torch.Tensor, tile_expert: torch.Tensor,
                  w: torch.Tensor, tile_m: int) -> torch.Tensor:
    """Tile-aligned contract of the kernel: x (T, D) sorted by expert and
    group-padded so row tile i belongs entirely to expert
    ``tile_expert[i]``.  Returns (T, F) in x's dtype (every row, padding
    included); a tile of an expert ≥ E, which the kernel skips, gives 0."""
    T, D = x.shape
    E = w.shape[0]
    n = T // tile_m
    te = tile_expert.long()
    xt = x.reshape(n, tile_m, D).float()
    wt = w[te.clamp(max=E - 1)].to(x.dtype).float()  # (n, D, F)
    y = torch.where(te[:, None, None] < E, torch.bmm(xt, wt), 0.0)
    return y.reshape(T, -1).to(x.dtype)
