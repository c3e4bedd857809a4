"""AdamW, learning-rate schedules and global-norm clipping over parameter
trees.

The JAX package's ``train/optimizer.py`` on trees of tensors.  ``update``
writes nothing into its inputs: it returns new parameters and a new state,
as the reference's pure pytree transforms do, so a caller may step twice
from the same parameters.  ``update_`` is its donating form, what the
reference's step jitted with ``donate_argnums=(0, 1)`` does: the new
parameters and moments go into the storage of the old ones, bit for bit
those of ``update``.  The state is a plain tree (``m`` and ``v`` in
float32, ``step`` a 0-d int32 tensor), the reference's own, so it
checkpoints like the parameters and crosses between the packages through
:func:`repro_torch.interop.params_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree

from ..parallel.axes import is_dtensor

__all__ = ["AdamW", "cosine_warmup", "linear_warmup", "global_norm",
           "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm of every leaf of ``tree`` taken together."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in pytree.tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """``tree`` scaled down to a global norm of at most ``max_norm`` (each
    leaf in float32, back in its dtype), and the norm before clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return pytree.tree_map(lambda x: (x.float() * scale).to(x.dtype),
                           tree), norm


# the most elements ``update_`` takes of a leaf at once along its leading
# axis (at least one row): one layer of a stacked leaf, or a band of an
# embedding's rows, so its temporaries stay two such chunks
CHUNK_ELEMS = 1 << 24


def _chunks(t: torch.Tensor) -> list:
    """Indices that cut ``t`` along its leading axis into runs of rows of
    at most :data:`CHUNK_ELEMS` elements (one row at least)."""
    if t.dim() == 0:
        return [...]
    rows = t.shape[0]
    per = max(1, CHUNK_ELEMS // max(t[0].numel(), 1))
    return [slice(i, min(i + per, rows)) for i in range(0, rows, per)]


def _local(t):
    """A DTensor's local shard (a view of its storage), else ``t``: the
    update is elementwise, and a parameter, its moments and its gradient
    share their placements."""
    return t.to_local() if is_dtensor(t) else t


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def cosine_warmup(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor · peak_lr`` at ``total``; a float32 tensor on the
    step's device."""
    def lr(step):
        step = _steps(step)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def linear_warmup(peak_lr: float, warmup: int) -> Callable:
    def lr(step):
        return peak_lr * torch.clamp(_steps(step) / max(warmup, 1), max=1.0)

    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        # filled on the device: no copy from the host each step
        return torch.full((), self.lr, dtype=torch.float32,
                          device=step.device)

    def init(self, params) -> dict:
        """Zero moments in float32 beside each parameter, and step 0."""
        leaves = pytree.tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")

        def zeros():
            return pytree.tree_map(
                lambda x: torch.zeros_like(x, dtype=torch.float32), params)

        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads, state, params):
        """Returns (new_params, new_state, stats), in the reference's order
        of operations: clip, the moments, bias correction, then the step
        with decoupled weight decay.  :meth:`update_` repeats this
        arithmetic in place and is held to its bits, so a change here is
        made there too."""
        step = state["step"] + 1
        if self.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        else:
            gnorm = global_norm(grads)
        b1, b2 = self.b1, self.b2
        m = pytree.tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.float(),
                            state["m"], grads)
        v = pytree.tree_map(
            lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.float()),
            state["v"], grads)
        sf = step.float()
        bc1 = 1 - torch.pow(b1, sf)
        bc2 = 1 - torch.pow(b2, sf)
        lr = self._lr(step)

        def upd(p, mm, vv):
            mhat = mm / bc1
            vhat = vv / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype)

        new_params = pytree.tree_map(upd, params, m, v)
        return new_params, {"m": m, "v": v, "step": step}, {
            "grad_norm": gnorm, "lr": lr}

    def update_(self, grads, state, params):
        """:meth:`update` that consumes ``params`` and ``state``: the new
        parameters and moments are written into their storage, and the
        same trees come back (with a new step count) beside the stats.

        It works leaf by leaf and, within a leaf, along its leading axis
        (:func:`_chunks`), scaling each chunk of the gradient by the clip
        factor inside the loop, so no clipped tree is built and at most two
        chunks of temporaries are live.  The global norm is
        :func:`global_norm`'s and every element goes through
        :meth:`update`'s operations in its order (clip, the moments, bias
        correction, the step with decoupled weight decay), so the bits are
        :meth:`update`'s.  ``grads`` is a tree, or a list of its leaves in
        ``params``' order; a list is emptied as it goes (each entry set to
        None once its leaf is applied), so a caller that hands over the
        only reference frees each gradient as soon as it is used."""
        if not isinstance(grads, list):
            grads = pytree.tree_leaves(grads)
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = None if self.clip_norm is None else _local(
            torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0))
        sf = step.float()
        bc1 = _local(1 - torch.pow(self.b1, sf))
        bc2 = _local(1 - torch.pow(self.b2, sf))
        lr = self._lr(step)
        lr_l = _local(lr)
        trees = (pytree.tree_leaves(params), pytree.tree_leaves(state["m"]),
                 pytree.tree_leaves(state["v"]))
        for i, leaves in enumerate(zip(*trees)):
            g, grads[i] = _local(grads[i]), None
            p, m, v = (_local(t) for t in leaves)
            for rows in _chunks(p):
                self._apply_chunk(p[rows], m[rows], v[rows], g[rows], scale,
                                  bc1, bc2, lr_l)
            del g
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": lr}

    def _apply_chunk(self, p, m, v, g, scale, bc1, bc2, lr) -> None:
        """One chunk of :meth:`update_`, written into ``p``, ``m`` and
        ``v``: :meth:`update`'s expressions with each result stored in
        place (a product's operands in either order give the same bits;
        no operation is fused)."""
        g = g.float() if scale is None else \
            (g.float() * scale).to(g.dtype).float()
        m.mul_(self.b1).add_(g * (1 - self.b1))
        v.mul_(self.b2).add_(torch.square(g).mul_(1 - self.b2))
        del g
        delta = m / bc1
        den = v / bc2
        delta.div_(den.sqrt_().add_(self.eps))
        del den
        delta.add_(p.float() * self.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)
