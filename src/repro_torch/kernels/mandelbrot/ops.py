"""Public Mandelbrot op: the CUDA kernel for the card, the plain version on
the CPU.

The device is that of ``row0`` when one is given, else ``device``
(``None`` means the card).  On a CUDA device the kernel runs or the call
raises; nothing falls back to the plain version.  ``mandelbrot.launches``
counts the kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...device import resolve_device
from .. import _launches
from . import kernel, ref


def mandelbrot(height: int, width: int, *, x0: float = -2.25,
               y0: float = -1.25, pixel_delta: float = 0.005,
               max_iterations: int = 100,
               row0: Optional[torch.Tensor] = None,
               device=None) -> torch.Tensor:
    """int32 (H, W) escape counts of the window whose top-left pixel is
    ``(x0, y0 + pixel_delta * row0)`` (``row0`` an int32 scalar tensor, or
    None for 0).  ``max_iterations <= 0`` runs no step: all zeros, as in
    the JAX op."""
    if height <= 0 or width <= 0:
        raise ValueError(f"mandelbrot: empty image {height}x{width}")
    if row0 is not None:
        if row0.dtype != torch.int32 or row0.numel() != 1:
            raise ValueError("mandelbrot: row0 must be one int32 value, got "
                             f"{row0.dtype} of shape {tuple(row0.shape)}")
        if device is not None and torch.device(device) != row0.device:
            raise ValueError(f"mandelbrot: row0 lies on {row0.device}, "
                             f"device={device!r} was asked for")
        dev = row0.device
    else:
        dev = resolve_device(device)
    if dev.type == "cpu":
        return ref.mandelbrot(height, width, x0=x0, y0=y0,
                              pixel_delta=pixel_delta,
                              max_iterations=max_iterations, row0=row0,
                              device=dev)
    if dev.type != "cuda":
        raise ValueError(f"mandelbrot: unsupported device {dev}")
    out = torch.empty((height, width), dtype=torch.int32, device=dev)
    kernel.launch(out, x0=x0, y0=y0, pixel_delta=pixel_delta,
                  max_iterations=max_iterations,
                  row0=None if row0 is None else row0.reshape(()))
    _launches.count(mandelbrot)
    return out


mandelbrot.launches = 0
