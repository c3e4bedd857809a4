"""Public stencil op: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.

On the card the kernel runs or the call raises; nothing falls back to the
plain version.  The kernel takes every odd k, as the plain version does.
An integer image (uint8, int8, int16, int32) goes through the float32
kernel: converted to float32, summed there, and converted back by
:func:`.ref.saturate_to`, XLA's saturating conversion, as the JAX package
computes it.  A bool image goes the same way and comes back as ``!= 0``
(the JAX package's cast of its float32 sum to bool).  int64 images are
refused: JAX without 64-bit mode returns no int64, so nothing holds that
type to a reference.  A non-contiguous image is copied once.
Under grad mode a float image that requires grad runs the launch inside a
``torch.autograd.Function`` (:func:`.._autograd.launch`) whose backward is
that of the plain version; integer and bool images carry no gradient, as
in torch.  The CPU branch is the plain version itself.
``stencil2d.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import _autograd, _launches
from . import kernel, ref
from .ref import INT_DTYPES, saturate_to, taps_of

__all__ = ["stencil2d", "taps_of"]


def stencil2d(img: torch.Tensor, taps) -> torch.Tensor:
    """2-D same-padding stencil of ``img`` (H, W), float32, bfloat16,
    float16, uint8, int8, int16, int32 or bool, summed in float32 and
    converted once to the image's type.

    ``taps`` is a (k, k) kernel with odd k; pass the host tuple of
    :func:`taps_of` to keep the call free of any device-to-host copy."""
    if not (isinstance(taps, tuple) and all(isinstance(r, tuple)
                                            for r in taps)):
        taps = taps_of(taps)
    if img.ndim != 2 or img.numel() == 0:
        raise ValueError(f"stencil2d: image must be a non-empty (H, W), got "
                         f"{tuple(img.shape)}")
    if img.dtype not in kernel.DTYPES and img.dtype not in INT_DTYPES \
            and img.dtype != torch.bool:
        raise TypeError(f"stencil2d: float32, bfloat16, float16, uint8, "
                        f"int8, int16, int32 or bool image required, got "
                        f"{img.dtype}")
    if img.device.type == "cpu":
        return ref.stencil2d(img, taps)
    if img.device.type != "cuda":
        raise ValueError(f"stencil2d: unsupported device {img.device}")
    return _autograd.launch(_launch, ref.stencil2d, img, taps)


stencil2d.launches = 0


def _launch(img: torch.Tensor, taps: tuple) -> torch.Tensor:
    """One launch on a validated CUDA image."""
    src = (img.contiguous() if img.dtype in kernel.DTYPES
           else img.to(torch.float32, memory_format=torch.contiguous_format))
    out = torch.empty_like(src)
    kernel.launch(src, out, taps)
    _launches.count(stencil2d)
    return out if src.dtype == img.dtype else saturate_to(out, img.dtype)
