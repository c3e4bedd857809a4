"""Plain PyTorch version of the 2-D stencil (paper §6.4 image kernels).

Zero-padded ("same") cross-correlation with a small square kernel of
constant taps, accumulated in float32 over the taps in (dr, dc) order with
zero taps skipped, then cast back to the image's type — the order the CUDA
kernel follows, so the two agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def taps_of(kernel) -> tuple:
    """A (k, k) kernel (tuple of rows, numpy array or tensor) as a host tuple
    of float32-valued rows.  Stencil engines call this once, when they are
    built, so no call reads the taps back from the device."""
    if isinstance(kernel, torch.Tensor):
        kernel = kernel.detach().to("cpu", torch.float32).numpy()
    a = np.asarray(kernel, dtype=np.float32)
    if a.ndim != 2 or a.shape[0] != a.shape[1] or a.shape[0] % 2 != 1:
        raise ValueError(f"stencil: square odd kernel required, got shape "
                         f"{a.shape}")
    return tuple(tuple(float(w) for w in row) for row in a)


def stencil2d(img: torch.Tensor, taps: tuple) -> torch.Tensor:
    """``img`` (H, W); ``taps`` from :func:`taps_of`.  Returns (H, W) in
    ``img``'s dtype."""
    k = len(taps)
    h = k // 2
    H, W = img.shape
    padded = F.pad(img.to(torch.float32), (h, h, h, h))
    out = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    for dr in range(k):
        for dc in range(k):
            w = taps[dr][dc]
            if w == 0.0:
                continue
            out = out + w * padded[dr:dr + H, dc:dc + W]
    return out.to(img.dtype)
