"""Public SSD op: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

On the card the kernel runs or the call raises; nothing falls back to the
plain version, also when the final state is asked for (the kernel writes
it, where the JAX package's TPU kernel returns none and its prefill takes
the jnp path).  Under grad mode the CUDA branch runs the whole op (every
launch of a split input) inside a ``torch.autograd.Function``
(:func:`.._autograd.launch`) whose backward is that of the plain version,
recomputed from the saved x, dt, A, B, C; the CPU branch is the plain
version itself.  The kernel forms the log-decays dt·A itself, reads B and C
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

The launches are the custom ops ``torch.ops.repro_torch.ssd_scan`` (y) and
``ssd_scan_state`` (y and the state).  Given tensors that hold no data on
the card's path (see :func:`repro_torch.device.card_model`) their fake
rules return the outputs :func:`_op` allocates and build, call and count
nothing; ``FlopCounterMode`` counts them by :func:`flops`.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from ...device import on_card
from ...parallel.axes import is_dtensor
from .. import _autograd, _launches
from . import kernel, ref

__all__ = ["ssd", "flops"]


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
    if is_dtensor(x):
        return _ssd_sharded(x, dt, A, B, C, chunk=chunk,
                            return_state=return_state)
    if not on_card(x):
        if x.device.type == "cpu":
            return ref.ssd(x, dt, A, B, C, chunk=chunk,
                           return_state=return_state)
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
    return _autograd.launch(_kernel_op, ref.ssd, x, dt, A, B, C,
                            chunk=chunk, return_state=return_state)


ssd.launches = 0


def _ssd_sharded(x, dt, A, B, C, *, chunk: int, return_state: bool):
    """``ssd`` of DTensors: each rank runs the op (the kernel on the card)
    on its own batch rows and heads, through ``local_map``.  x keeps a
    shard of its batch dim (0) or head dim (2) and gathers any other; dt
    and A follow it; B and C follow its batch shards and split their
    groups with its heads where the head ways divide G, else stay whole
    (each rank's heads then read group 0 of G = 1, or the groups are
    gathered with the heads); the gradients of inputs a rank holds whole
    are summed over the ranks that split the work.  The state comes back
    as (batch, H, N, P): one dim cannot carry both the batch and the head
    shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = x.device_mesh
    H, G = x.shape[2], B.shape[2]
    xp = [pl if isinstance(pl, Shard) and pl.dim in (0, 2) else Replicate()
          for pl in x.placements]
    head_ways = math.prod(dm.size(i) for i, pl in enumerate(xp)
                          if pl == Shard(2))
    if G > 1 and G % head_ways:  # groups cannot follow the heads' split
        xp = [Replicate() if pl == Shard(2) else pl for pl in xp]
    bp = xp if G > 1 else [Replicate() if pl == Shard(2) else pl
                           for pl in xp]
    ap = [Shard(0) if pl == Shard(2) else Replicate() for pl in xp]

    def local(xl, dtl, Al, Bl, Cl):
        res = ssd(xl, dtl, Al, Bl, Cl, chunk=chunk,
                  return_state=return_state)
        if not return_state:
            return res
        y, hT = res
        b, _, h, p = xl.shape
        return y, hT.reshape(b, h, Bl.shape[3], p)

    # a rank's gradient of a whole input holds only its own rows' or
    # heads' share: A's is a partial sum over the batch ways, B's and C's
    # over the head ways they do not split with
    ag = [Partial() if pl == Shard(0) else a for pl, a in zip(xp, ap)]
    bg = [Partial() if pl == Shard(2) and b == Replicate() else b
          for pl, b in zip(xp, bp)]
    hp = [Shard(1) if pl == Shard(2) else pl for pl in xp]
    return local_map(local, out_placements=(xp, hp) if return_state else xp,
                     in_placements=(xp, xp, ap, bp, bp),
                     in_grad_placements=(xp, xp, ag, bg, bg), device_mesh=dm,
                     redistribute_inputs=True)(x, dt, A, B, C)


def _kernel_op(x, dt, A, B, C, *, chunk: int, return_state: bool):
    """:func:`_op` as a custom op: one for y alone, one for y and the
    state."""
    del chunk
    if return_state:
        return torch.ops.repro_torch.ssd_scan_state(x, dt, A, B, C)
    return torch.ops.repro_torch.ssd_scan(x, dt, A, B, C)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cuda")
def _scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
          B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    return _op(x, dt, A, B, C, chunk=64, return_state=False)


@torch.library.custom_op("repro_torch::ssd_scan_state", mutates_args=(),
                         device_types="cuda")
def _scan_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    return _op(x, dt, A, B, C, chunk=64, return_state=True)


@_scan.register_fake
def _(x, dt, A, B, C):
    return x.new_empty(x.shape)  # y as _op allocates it: contiguous


@_scan_state.register_fake
def _(x, dt, A, B, C):
    b, _, H, P = x.shape
    return x.new_empty(x.shape), x.new_empty((b * H, B.shape[3], P),
                                             dtype=torch.float32)


def flops(b: int, S: int, H: int, P: int, G: int, N: int,
          chunk: int = 64) -> float:
    """The kernel's FLOP count (its chunks of 64 steps): C·Bᵀ once per group
    over the causal pairs of each chunk, W·x over the same pairs per head,
    C·h and the state update N·P multiply-adds a step per head."""
    rows = [chunk] * (S // chunk) + ([S % chunk] if S % chunk else [])
    pairs = sum(r * (r + 1) // 2 for r in rows)
    return 2.0 * b * G * N * pairs + b * H * (2.0 * P * pairs
                                              + 4.0 * N * P * S)


def _flop_formula(x_shape, dt_shape, A_shape, B_shape, C_shape, *_,
                  out_shape=None, **__) -> int:
    b, S, H, P = x_shape
    return int(flops(b, S, H, P, B_shape[2], B_shape[3]))


register_flop_formula(torch.ops.repro_torch.ssd_scan)(_flop_formula)
register_flop_formula(torch.ops.repro_torch.ssd_scan_state)(_flop_formula)


def _op(x, dt, A, B, C, *, chunk: int, return_state: bool):
    """The op's launches on validated CUDA tensors (``chunk`` is the plain
    version's; the kernel's is 64)."""
    del chunk
    b, S, H, P = x.shape
    N = B.shape[3]
    if S == 0:
        y = torch.empty((b, 0, H, P), dtype=x.dtype, device=x.device)
        hT = torch.zeros((b * H, N, P), dtype=torch.float32, device=x.device)
        return (y, hT) if return_state else y
    x, B, C = (t if t.stride(3) == 1 else t.contiguous() for t in (x, B, C))
    dt, A = dt.float(), A.float().contiguous()
    y, hT = _pieces(_launch, x, dt, A, B, C, return_state)
    return (y, hT) if return_state else y


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
