"""ctypes binding of ``csrc/mandelbrot.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("mandelbrot")
    if lib.mandelbrot_launch.argtypes is None:
        lib.mandelbrot_launch.argtypes = [
            _c_void_p, _c_int, _c_int, _c_float, _c_float, _c_float,
            _c_void_p, _c_int, _c_int, _c_void_p]
        lib.mandelbrot_launch.restype = _c_int
        lib.mandelbrot_error_string.argtypes = [_c_int]
        lib.mandelbrot_error_string.restype = ctypes.c_char_p
    return lib


def launch(out: torch.Tensor, *, x0: float, y0: float, pixel_delta: float,
           max_iterations: int, row0: Optional[torch.Tensor]) -> None:
    """Fill the contiguous int32 CUDA tensor ``out`` (H, W) with escape
    counts, on the current stream.  Raises if the launch is refused."""
    lib = _lib()
    height, width = out.shape
    err = lib.mandelbrot_launch(
        out.data_ptr(), height, width, x0, y0, pixel_delta,
        None if row0 is None else row0.data_ptr(), max_iterations,
        out.device.index, torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError("mandelbrot kernel launch failed: "
                           + lib.mandelbrot_error_string(err).decode())
