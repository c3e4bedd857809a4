"""Plain PyTorch version of the Mandelbrot escape-time counts (paper §6.6).

The same masked iteration as the JAX oracle: every pixel runs
``max_iterations`` steps of ``z <- z^2 + c``; a step counts while
``|z|^2 <= 4`` and leaves ``z`` unchanged once the pixel has escaped.  Each
product and sum is its own operation, so nothing is contracted into an FMA;
the CUDA kernel rounds in the same order and agrees exactly.
"""

from __future__ import annotations

from typing import Optional

import torch


def mandelbrot(height: int, width: int, *, x0: float = -2.25,
               y0: float = -1.25, pixel_delta: float = 0.005,
               max_iterations: int = 100,
               row0: Optional[torch.Tensor] = None,
               device="cpu") -> torch.Tensor:
    """Iteration counts (escape value = max_iterations), int32 (H, W).

    ``row0`` (an int32 scalar tensor) shifts the window down by that many
    rows: the top edge is ``y0 + pixel_delta * row0``, computed in float32.
    """
    f32 = torch.float32
    if row0 is not None:
        device = row0.device
    delta = torch.tensor(pixel_delta, dtype=f32, device=device)
    top = torch.tensor(y0, dtype=f32, device=device)
    if row0 is not None:
        top = top + delta * row0.to(f32)
    ys = top + delta * torch.arange(height, dtype=f32, device=device)
    xs = torch.tensor(x0, dtype=f32, device=device) \
        + delta * torch.arange(width, dtype=f32, device=device)
    cr = xs[None, :].expand(height, width)
    ci = ys[:, None].expand(height, width)
    zr = torch.zeros((height, width), dtype=f32, device=device)
    zi = torch.zeros_like(zr)
    cnt = torch.zeros((height, width), dtype=torch.int32, device=device)
    for _ in range(max_iterations):
        zr2, zi2 = zr * zr, zi * zi
        inside = (zr2 + zi2) <= 4.0
        zr, zi = (torch.where(inside, zr2 - zi2 + cr, zr),
                  torch.where(inside, 2.0 * zr * zi + ci, zi))
        cnt = cnt + inside.to(torch.int32)
    return cnt
