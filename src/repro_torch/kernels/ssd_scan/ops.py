"""Public SSD op: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

On the card the kernel runs or the call raises; nothing falls back to the
plain version, also when the final state is asked for (the kernel writes
it, where the JAX package's TPU kernel returns none and its prefill takes
the jnp path).  The CUDA branch refuses inputs that require grad while
grad mode is on (the kernel has no backward yet); the CPU branch is
differentiable.  The kernel forms the log-decays dt·A itself, reads B and C
by group and every operand through its strides, and masks a ragged last
chunk, so this wrapper broadcasts and pads nothing.  x, B and C may be
float32, bfloat16 or float16 (one type); dt and A are cast to float32, as
the plain version computes them; an x, B or C whose P or N axis is not
contiguous is copied once.  S = 0 launches nothing: y is empty and the
state zero, as the plain version returns them.

One launch takes P <= ``kernel.MAX_P`` and N <= ``kernel.MAX_N``; a wider
input runs as several launches (:func:`_pieces`), since the scan's P columns
are independent and its N rows enter y only through sums over N.
``ssd.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import _autograd, _launches
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
        raise TypeError(f"ssd: the CUDA kernel takes x, B, C all float32, "
                        f"all bfloat16 or all float16, got {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if not (dt.dtype.is_floating_point and A.dtype.is_floating_point):
        raise TypeError(f"ssd: dt and A must be floating point, got "
                        f"{dt.dtype}, {A.dtype}")
    _autograd.refuse_grad("ssd", x, dt, A, B, C)
    if S == 0:
        y = torch.empty((b, 0, H, P), dtype=x.dtype, device=x.device)
        hT = torch.zeros((b * H, N, P), dtype=torch.float32, device=x.device)
        return (y, hT) if return_state else y
    x, B, C = (t if t.stride(3) == 1 else t.contiguous() for t in (x, B, C))
    dt, A = dt.float(), A.float().contiguous()
    y, hT = _pieces(_launch, x, dt, A, B, C, return_state)
    return (y, hT) if return_state else y


ssd.launches = 0


def _launch(x, dt, A, B, C, y, hT) -> None:
    kernel.launch(x, dt, A, B, C, y, hT)
    _launches.count(ssd)


def _pieces(run, x, dt, A, B, C, return_state: bool):
    """y and (with ``return_state``, else None) the final state of the scan,
    from ``run(x, dt, A, B, C, y, hT)`` calls that each take P <=
    ``kernel.MAX_P`` and N <= ``kernel.MAX_N`` and write y (x's shape and
    dtype, through its strides) and hT ((batch·H, N, P) f32, contiguous, or
    None).

    P wider than one launch: P-slices of x and y, as views (their last axis
    keeps stride 1); each slice's state goes into its own contiguous buffer
    and is copied into its columns of hT.  N wider: y is the sum over
    N-blocks of the scan with B and C cut to the block, since C·Bᵀ and C·h
    are sums over N and each block of the state evolves alone; the blocks
    run in f32 (x, B, C cast), their y are summed in f32 and cast to x's
    dtype once, and hT is the blocks' states side by side.  At P <= MAX_P
    and N <= MAX_N this is one ``run`` straight into y and hT."""
    b, S, H, P = x.shape
    N = B.shape[3]
    dev = x.device
    hT = (torch.empty((b * H, N, P), dtype=torch.float32, device=dev)
          if return_state else None)
    if N > kernel.MAX_N:
        xf, y = x.float(), torch.zeros((b, S, H, P), dtype=torch.float32,
                                       device=dev)
        for n0 in range(0, N, kernel.MAX_N):
            n1 = min(N, n0 + kernel.MAX_N)
            yb, hb = _pieces(run, xf, dt, A, B[..., n0:n1].float(),
                             C[..., n0:n1].float(), return_state)
            y += yb
            if return_state:
                hT[:, n0:n1] = hb
        return y.to(x.dtype), hT
    y = torch.empty((b, S, H, P), dtype=x.dtype, device=dev)
    if P <= kernel.MAX_P:
        run(x, dt, A, B, C, y, hT)
        return y, hT
    for p0 in range(0, P, kernel.MAX_P):
        p1 = min(P, p0 + kernel.MAX_P)
        hp = (torch.empty((b * H, N, p1 - p0), dtype=torch.float32,
                          device=dev) if return_state else None)
        run(x[..., p0:p1], dt, A, B, C, y[..., p0:p1], hp)
        if return_state:
            hT[:, :, p0:p1] = hp
    return y, hT
