"""Plain PyTorch version of the 2-D stencil (paper §6.4 image kernels).

Zero-padded ("same") cross-correlation with a small square kernel of
constant taps, accumulated in float32 over the taps in (dr, dc) order with
zero taps skipped, then cast back to the image's type — the order the CUDA
kernel follows, so the two agree exactly.

Integer images (uint8, int8, int16, int32) are converted to float32 (round
to nearest, as XLA's promotion converts an int32 above 2^24), summed the
same way, and converted back as XLA converts float32 to an integer
(:func:`saturate_to`), so the result is the JAX package's bit for bit.
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


INT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32)


def saturate_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 ``x`` as ``dtype``.  For an integer type this is XLA's
    conversion: NaN becomes 0, the rest is truncated toward zero and
    saturates at the type's range.  (A plain ``.to`` is undefined out of
    range, and the float32 bound 2^31 - 1 rounds up to 2^31, so both bounds
    are tested in float32 against exact powers of two.)"""
    if dtype not in INT_DTYPES:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    t = torch.where(torch.isnan(x), 0.0, x).trunc()
    over = t >= float(info.max) + 1.0   # 256, 128, 32768, 2^31: exact
    under = t < float(info.min)
    out = torch.where(over | under, 0.0, t).to(dtype)
    out = torch.where(over, info.max, out)
    return torch.where(under, info.min, out).to(dtype)


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
    return saturate_to(out, img.dtype)
