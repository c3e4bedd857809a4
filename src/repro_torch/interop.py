"""Carry the JAX package's inputs across: numpy pytrees to tensors.

The networks of both packages consume pytrees of arrays (images, Jacobi
systems, stencil taps, seeds).  Built once with numpy from a seed, the same
pytree feeds the JAX reference and, through :func:`tree_from_numpy`, the
port, so the two are compared on identical inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["tree_from_numpy"]


def tree_from_numpy(tree, device, dtype_map: Optional[dict] = None):
    """Turn every numpy array (or numpy scalar) leaf into a tensor on
    ``device``.

    ``dtype_map`` maps a numpy dtype to the torch dtype its arrays become,
    e.g. ``{np.float32: torch.bfloat16}``: numpy has no bf16, so bf16 inputs
    are an explicit cast from float32.  Other leaves are left alone.
    """
    cast = {np.dtype(k): v for k, v in (dtype_map or {}).items()}

    def _one(leaf):
        if not isinstance(leaf, (np.ndarray, np.generic)):
            return leaf
        t = torch.from_numpy(np.ascontiguousarray(leaf))
        target = cast.get(leaf.dtype)
        if target is not None:
            t = t.to(target)
        return t.to(device)

    return pytree.tree_map(_one, tree)
