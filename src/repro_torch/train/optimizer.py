"""AdamW, learning-rate schedules and global-norm clipping, as pure
functions over parameter trees.

The JAX package's ``train/optimizer.py`` on trees of tensors.  Nothing here
writes into its inputs: ``update`` returns new parameters and a new state,
as the reference's pure pytree transforms do, so a caller may step twice
from the same parameters.  The state is a plain tree (``m`` and ``v`` in
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
        with decoupled weight decay."""
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
