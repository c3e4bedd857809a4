"""ctypes binding of ``csrc/flash_attention.cu`` (built at first use)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int,
            ctypes.POINTER(ctypes.c_longlong), _c_int, _c_void_p]
        lib.flash_attention_launch.restype = _c_int
        lib.flash_attention_error_string.argtypes = [_c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, *, causal: bool, scale: float) -> None:
    """Write attention of the CUDA tensors q (B, H, Sq, D), k and v
    (B, K, Sk, D) into ``o`` (q's shape and dtype), on the current stream.
    Each tensor is read through its strides; its last axis must be
    contiguous.  Raises if the launch is refused."""
    lib = _lib()
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, H // K,
        Sq, Sk, D, int(causal), float(scale), DTYPES[q.dtype], strides,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
