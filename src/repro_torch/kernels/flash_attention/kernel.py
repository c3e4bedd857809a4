"""ctypes binding of ``csrc/flash_attention.cu`` (built at first use)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)


def tensor_core_path(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether ``csrc/flash_attention.cu`` runs this call on the tensor
    cores (else on the f32 FMA units); the C code owns the rule."""
    return bool(_lib().flash_attention_tensor_cores(DTYPES[dtype], head_dim))


def readable(t: torch.Tensor, tensor_cores: bool) -> torch.Tensor:
    """``t`` if :func:`launch` can read it in place (head dim contiguous
    and, on the tensor cores, a 16-byte aligned base with batch, head and
    seq strides multiples of 8 elements: ``aligned_rows`` in the C code),
    else a copy in a fresh contiguous buffer, which has both."""
    ok = t.stride(3) == 1
    if ok and tensor_cores:
        ok = t.data_ptr() % 16 == 0 and all(
            t.stride(i) % 8 == 0 for i in range(3) if t.shape[i] > 1)
    if ok:
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


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
        lib.flash_attention_tensor_cores.argtypes = [_c_int, _c_int]
        lib.flash_attention_tensor_cores.restype = _c_int
        lib.flash_attention_unaligned_rows.argtypes = []
        lib.flash_attention_unaligned_rows.restype = _c_int
    return lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, *, causal: bool, scale: float) -> None:
    """Write attention of the CUDA tensors q (B, H, Sq, D), k and v
    (B, K, Sk, D) into ``o`` (q's shape and dtype), on the current stream.
    Each tensor is read through its strides; its last axis must be
    contiguous.  Raises ValueError, with nothing launched, on rows the
    tensor-core path cannot copy (see ``flash_attention_launch``), and
    RuntimeError if the launch is refused otherwise."""
    lib = _lib()
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, H // K,
        Sq, Sk, D, int(causal), float(scale), DTYPES[q.dtype], strides,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err == lib.flash_attention_unaligned_rows():
        raise ValueError(
            lib.flash_attention_error_string(err).decode()
            + f"; got strides {[t.stride() for t in (q, k, v, o)]}, base "
            f"addresses mod 16 {[t.data_ptr() % 16 for t in (q, k, v, o)]}")
    if err:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
