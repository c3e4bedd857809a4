"""Where the port runs: on the card unless the caller asks for the CPU.

Every entry point (``build``, ``run_sequential``, the kernel wrappers that
take no tensor) resolves its ``device`` argument here, so a machine without
a GPU fails loudly instead of quietly running the plain CPU versions.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["resolve_device", "to_device", "as_tensor_tree"]


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
