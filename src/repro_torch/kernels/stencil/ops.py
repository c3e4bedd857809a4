"""Public stencil op: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.

On the card the kernel runs or the call raises; nothing falls back to the
plain version.  The kernel takes every odd k, as the plain version does.
The CUDA branch refuses an image that requires grad while grad mode is on
(the kernel has no backward yet); the CPU branch is differentiable.
``stencil2d.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import _autograd
from . import kernel, ref
from .ref import taps_of

__all__ = ["stencil2d", "taps_of"]


def stencil2d(img: torch.Tensor, taps) -> torch.Tensor:
    """2-D same-padding stencil of ``img`` (H, W), float32 or bfloat16.

    ``taps`` is a (k, k) kernel with odd k; pass the host tuple of
    :func:`taps_of` to keep the call free of any device-to-host copy."""
    if not (isinstance(taps, tuple) and all(isinstance(r, tuple)
                                            for r in taps)):
        taps = taps_of(taps)
    if img.ndim != 2 or img.numel() == 0:
        raise ValueError(f"stencil2d: image must be a non-empty (H, W), got "
                         f"{tuple(img.shape)}")
    if img.dtype not in kernel.DTYPES:
        raise TypeError(f"stencil2d: float32 or bfloat16 image required, "
                        f"got {img.dtype}")
    if img.device.type == "cpu":
        return ref.stencil2d(img, taps)
    if img.device.type != "cuda":
        raise ValueError(f"stencil2d: unsupported device {img.device}")
    if not img.is_contiguous():
        raise ValueError("stencil2d: the CUDA kernel needs a contiguous image")
    _autograd.refuse_grad("stencil2d", img)
    out = torch.empty_like(img)
    kernel.launch(img, out, taps)
    stencil2d.launches += 1
    return out


stencil2d.launches = 0
