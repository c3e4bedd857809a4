"""ctypes binding of ``csrc/moe_gmm.cu`` (built at first use)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_gmm")
    if lib.moe_gmm_launch.argtypes is None:
        lib.moe_gmm_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
            _c_void_p]
        lib.moe_gmm_launch.restype = _c_int
        lib.moe_gmm_error_string.argtypes = [_c_int]
        lib.moe_gmm_error_string.restype = ctypes.c_char_p
    return lib


def launch(x: torch.Tensor, tile_expert: torch.Tensor,
           tile_rows: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
           tile_m: int) -> None:
    """Write the valid rows of the grouped product of the contiguous CUDA
    tensors x (n_tiles·tile_m, D) and w (E, D, F) into ``y``
    (n_tiles·tile_m, F, x's dtype), tile t through expert
    ``tile_expert[t]`` for its first ``tile_rows[t]`` rows (both int32),
    on the current stream.  Raises if the launch is refused (also for more
    than 65,535 row blocks: row tiles times 64-row slices of a tile)."""
    lib = _lib()
    E, D, F = w.shape
    err = lib.moe_gmm_launch(
        x.data_ptr(), tile_expert.data_ptr(), tile_rows.data_ptr(),
        w.data_ptr(), y.data_ptr(), tile_expert.shape[0], tile_m, E, D, F,
        DTYPES[x.dtype], DTYPES[w.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("moe gmm kernel launch failed: "
                           + lib.moe_gmm_error_string(err).decode())
