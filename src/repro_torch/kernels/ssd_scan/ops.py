"""Public SSD op: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

On the card the kernel runs or the call raises; nothing falls back to the
plain version, also when the final state is asked for (the kernel writes
it, where the JAX package's TPU kernel returns none and its prefill takes
the jnp path).  The kernel forms the log-decays dt·A itself, reads B and C
by group and every operand through its strides, and masks a ragged last
chunk, so this wrapper broadcasts, pads and copies nothing.
``ssd.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from . import kernel, ref

__all__ = ["ssd"]


def ssd(x, dt, A, B, C, *, chunk: int = 64, return_state: bool = False):
    """Multi-head SSD.

    x: (batch, S, H, P); dt: (batch, S, H); A: (H,); B, C: (batch, S, G, N)
    with G dividing H (head h reads group h // (H // G)).  Returns y:
    (batch, S, H, P) in x's dtype; with ``return_state`` also the final
    state (batch·H, N, P) in f32.

    ``chunk`` is the plain version's chunk length (a sequence that is not a
    multiple of it is one chunk, as in the JAX package); the kernel always
    runs chunks of 64 steps and masks the last one.  The two compute the
    same function up to the order of the sums."""
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B.ndim != 4 \
            or B.shape != C.shape:
        raise ValueError(f"ssd: x (batch, S, H, P), dt (batch, S, H), A (H,) "
                         f"and B, C (batch, S, G, N) required, got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,) \
            or tuple(B.shape[:2]) != (b, S) or H % G:
        raise ValueError(f"ssd: x {tuple(x.shape)} does not fit dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} (same batch and S, G | H)")
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A, B, C, chunk=chunk, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("ssd: x, dt, A, B and C must lie on one device")
    if x.dtype not in kernel.DTYPES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"ssd: the CUDA kernel takes x, B, C all float32 or "
                        f"all bfloat16, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd: the CUDA kernel takes dt and A in float32, "
                        f"got {dt.dtype}, {A.dtype}")
    if S == 0 or P > kernel.MAX_P or N > kernel.MAX_N:
        raise ValueError(f"ssd: the CUDA kernel takes S >= 1, P <= "
                         f"{kernel.MAX_P} and N <= {kernel.MAX_N}, got S={S}, "
                         f"P={P}, N={N}")
    if any(t.stride(3) != 1 for t in (x, B, C)) or not A.is_contiguous():
        raise ValueError("ssd: the CUDA kernel needs the P and N axes of x, "
                         "B, C contiguous (stride 1) and A contiguous")
    y = torch.empty((b, S, H, P), dtype=x.dtype, device=x.device)
    hT = (torch.empty((b * H, N, P), dtype=torch.float32, device=x.device)
          if return_state else None)
    kernel.launch(x, dt, A, B, C, y, hT)
    ssd.launches += 1
    return (y, hT) if return_state else y


ssd.launches = 0
