"""Carry the JAX package's inputs across: numpy pytrees to tensors.

The networks of both packages consume pytrees of arrays (images, Jacobi
systems, stencil taps, seeds).  Built once with numpy from a seed, the same
pytree feeds the JAX reference and, through :func:`tree_from_numpy`, the
port, so the two are compared on identical inputs.  Model weights and KV
caches cross with :func:`params_from_numpy`, which also checks them against
the port's own tree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["tree_from_numpy", "params_from_numpy"]


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
        t = _leaf_tensor(leaf)
        target = cast.get(leaf.dtype)
        if target is not None:
            t = t.to(target)
        return t.to(device)

    return pytree.tree_map(_one, tree)


def _leaf_tensor(leaf) -> torch.Tensor:
    a = np.asarray(leaf)  # keeps a 0-d leaf 0-d (ascontiguousarray: (1,))
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")  # e.g. a JAX array's buffer: never alias
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: numpy cannot carry it
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device, *, like):
    """The JAX package's parameter (or cache) tree, as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), as the port's tree of
    the same structure on ``device``.

    ``like`` is the port's own tree for the same config (``Model.init`` or
    ``Model.init_cache`` on the CPU at a small size): the key paths must be
    the same and every leaf must have its shape; each leaf takes its dtype
    (bf16 included).  Raises ``ValueError`` on any mismatch.
    """
    ours, our_spec = pytree.tree_flatten_with_path(like)
    theirs = {pytree.keystr(p): leaf
              for p, leaf in pytree.tree_flatten_with_path(tree)[0]}
    our_paths = [pytree.keystr(p) for p, _ in ours]
    if set(our_paths) != set(theirs):
        raise ValueError(
            "params_from_numpy: tree structure differs; only in the given "
            f"tree: {sorted(set(theirs) - set(our_paths))}, only in the "
            f"port's: {sorted(set(our_paths) - set(theirs))}")
    leaves = []
    for path, (_, want) in zip(our_paths, ours):
        t = _leaf_tensor(theirs[path])
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"params_from_numpy: {path} has shape "
                             f"{tuple(t.shape)}, the port's is "
                             f"{tuple(want.shape)}")
        leaves.append(t.to(device=device, dtype=want.dtype))
    return pytree.tree_unflatten(leaves, our_spec)
