"""ctypes binding of ``csrc/ssd_scan.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_P, MAX_N = 64, 128  # one launch; ops.ssd splits a wider scan


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if lib.ssd_scan_launch.argtypes is None:
        lib.ssd_scan_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
            ctypes.POINTER(ctypes.c_longlong), _c_int, _c_void_p]
        lib.ssd_scan_launch.restype = _c_int
        lib.ssd_scan_error_string.argtypes = [_c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, y: torch.Tensor,
           hT: Optional[torch.Tensor]) -> None:
    """Write the SSD scan of the CUDA tensors x (batch, S, H, P), dt
    (batch, S, H) f32, A (H,) f32 contiguous, B and C (batch, S, G, N) into
    ``y`` (x's shape and dtype) and, unless it is None, the final state into
    ``hT`` ((batch·H, N, P) f32, contiguous), on the current stream: bf16
    on the tensor cores, f32 and f16 on the FMA units.  P <= MAX_P, N <= MAX_N.
    x, dt, B, C and y are read through their strides; the last axis of x,
    B, C and y must be contiguous.  Raises if the launch is refused."""
    lib = _lib()
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (x, dt, B, C, y) for s in t.stride()[:3]))
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), None if hT is None else hT.data_ptr(), b, S, H, G, P,
        N, DTYPES[x.dtype], strides, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("ssd scan kernel launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
