"""Where the port runs: on the card unless the caller asks for the CPU.

Every entry point (``build``, ``run_sequential``, the kernel wrappers that
take no tensor) resolves its ``device`` argument here, so a machine without
a GPU fails loudly instead of quietly running the plain CPU versions.
"""

from __future__ import annotations

import contextlib
import contextvars
import numbers

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["resolve_device", "to_device", "as_tensor_tree", "card_model",
           "on_card"]

_CARD_MODEL: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_card_model", default=False)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the GPU by "
                "default; pass device='cpu' to run it on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(tree, device: torch.device):
    """Move every tensor leaf of ``tree`` to ``device``; other leaves stay."""
    return pytree.tree_map(
        lambda l: l.to(device) if isinstance(l, torch.Tensor) else l, tree)


def as_tensor_tree(tree, device: torch.device):
    """An emitted item on ``device``: tensors are moved, numpy arrays and
    numbers become tensors (as ``jnp.stack`` would make them arrays)."""
    def _one(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.to(device)
        if isinstance(leaf, (np.ndarray, np.generic, numbers.Number)):
            return torch.as_tensor(leaf, device=device)
        return leaf

    return pytree.tree_map(_one, tree)


@contextlib.contextmanager
def card_model():
    """Inside this block a tensor that holds no data (a fake or meta
    tensor) on the CPU stands for one on the card: :func:`on_card` says so,
    and the kernel ops give their kernels' outputs as tensors without data
    (their fake rules).  The dry-run traces the card's path this way on a
    host without CUDA, where PyTorch's autograd cannot take fake CUDA
    tensors.  A tensor with data is never affected."""
    tok = _CARD_MODEL.set(True)
    try:
        yield
    finally:
        _CARD_MODEL.reset(tok)


def _holds_no_data(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return t.is_meta or is_fake(t)


def on_card(t: torch.Tensor) -> bool:
    """Does ``t`` take the card's path: a CUDA tensor, or, inside
    :func:`card_model`, a tensor that holds no data?"""
    return t.device.type == "cuda" or (_CARD_MODEL.get()
                                       and _holds_no_data(t))
