"""ctypes binding of ``csrc/stencil.cu`` (built at first use)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_STATIC_K = 9  # csrc/stencil.cu: larger odd k read their taps from a
                  # device buffer


def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil")
    if lib.stencil2d_launch.argtypes is None:
        lib.stencil2d_launch.argtypes = [
            _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int,
            ctypes.POINTER(ctypes.c_float), _c_void_p, _c_int, _c_void_p]
        lib.stencil2d_launch.restype = _c_int
        lib.stencil2d_error_string.argtypes = [_c_int]
        lib.stencil2d_error_string.restype = ctypes.c_char_p
    return lib


def launch(img: torch.Tensor, out: torch.Tensor, taps: tuple) -> None:
    """Write the stencil of the contiguous CUDA tensor ``img`` (H, W) into
    ``out`` (same shape and dtype), on the current stream, for any odd k.
    Up to :data:`MAX_STATIC_K` the taps go into the kernel's parameters;
    beyond, into a device buffer filled from the host tuple (a
    host-to-device copy on the current stream, nothing read back).  Raises
    if the launch is refused."""
    lib = _lib()
    k = len(taps)
    values = [w for row in taps for w in row]
    flat = taps_dev = None
    if k > MAX_STATIC_K:
        taps_dev = torch.tensor(values, dtype=torch.float32).to(img.device)
    else:
        flat = (ctypes.c_float * (k * k))(*values)
    height, width = img.shape
    err = lib.stencil2d_launch(
        img.data_ptr(), out.data_ptr(), height, width, k, DTYPES[img.dtype],
        flat, None if taps_dev is None else taps_dev.data_ptr(),
        img.device.index,
        torch.cuda.current_stream(img.device).cuda_stream)
    if err:
        raise RuntimeError("stencil kernel launch failed: "
                           + lib.stencil2d_error_string(err).decode())
