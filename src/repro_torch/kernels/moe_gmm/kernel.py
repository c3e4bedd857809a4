"""ctypes binding of ``csrc/moe_gmm.cu`` (built at first use)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_gmm")
    if lib.moe_gmm_launch.argtypes is None:
        lib.moe_gmm_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
            _c_void_p]
        lib.moe_gmm_launch.restype = _c_int
        lib.moe_gmm_error_string.argtypes = [_c_int]
        lib.moe_gmm_error_string.restype = ctypes.c_char_p
    return lib


def launch(x: torch.Tensor, tile_expert: torch.Tensor,
           tile_rows: torch.Tensor, row_src: torch.Tensor, w: torch.Tensor,
           y: torch.Tensor, tile_m: int) -> None:
    """The grouped product over a padded row space of
    ``len(tile_expert) · tile_m`` rows, row tile t through expert
    ``tile_expert[t]`` for its first ``tile_rows[t]`` rows, on the current
    stream: valid padded row i reads row ``row_src[i]`` of x (T, D) and
    writes that row of y (T, F) (the three int32).  w is (E, D, F); all
    contiguous CUDA tensors, y in x's dtype.  bf16 x runs on the tensor
    cores (f32 w rounded to bf16 as it is staged into shared memory; f16 w
    is not taken), f32 and f16 x on the FMA units (f16 x with w rounded to
    f16).  The grid is one-dimensional, so any number of row
    tiles launches.  Raises if the launch is refused."""
    lib = _lib()
    E, D, F = w.shape
    err = lib.moe_gmm_launch(
        x.data_ptr(), tile_expert.data_ptr(), tile_rows.data_ptr(),
        row_src.data_ptr(), w.data_ptr(), y.data_ptr(), tile_expert.shape[0],
        tile_m, E, D, F,
        DTYPES[x.dtype], DTYPES[w.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("moe gmm kernel launch failed: "
                           + lib.moe_gmm_error_string(err).decode())
