"""Parameter sharding rules: param-tree paths → partition specs.

The JAX package's ``parallel/sharding.py``.  Leaf names are the contract
(see models/layers.py): the table below assigns *logical* axes to each
leaf's trailing dims; leading dims (the stacked layers) are unsharded.
Logical axes are resolved against a :class:`.axes.ShardingRules` and
mesh-axis sizes that do not divide a dim fall back to replication — one
definition for every mesh, the GPP property again.

A spec is a :class:`P`: a tuple with one entry per leading tensor dim (a
mesh axis, a tuple of them, or None), entry for entry JAX's
``PartitionSpec``.  The derivation reads only shapes and ``mesh.shape``, so
it runs on fake or meta trees (the JAX package's ``eval_shape`` trees) and
on a mesh that has no world.  :func:`to_shardings` turns specs into
:class:`NamedSharding`\\ s, which place a tensor as a ``DTensor`` on the
mesh's ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils._pytree as pytree

from .axes import ShardingRules, is_dtensor, placements

__all__ = ["P", "NamedSharding", "param_specs", "param_shardings",
           "cache_specs", "batch_specs", "to_shardings", "place",
           "LEAF_RULES", "CACHE_RULES"]


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 over ``data``.
    An entry naming one axis in a tuple is that axis, as JAX writes it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: :meth:`place` puts a tensor there as a DTensor."""

    mesh: Any
    spec: P

    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, x: torch.Tensor):
        """``x`` (the whole tensor, the same on every rank, or a DTensor)
        as a DTensor with these placements, on the mesh's device."""
        from torch.distributed.tensor import distribute_tensor
        dm = self.mesh.device_mesh()
        if is_dtensor(x):
            return x.redistribute(dm, self.placements())
        # every rank holds the whole tensor (SPMD): each keeps its own
        # shard, with no scatter from a source rank
        return distribute_tensor(x.to(self.mesh.device), dm,
                                 self.placements(), src_data_rank=None)


# leaf name → logical axes of the TRAILING dims
LEAF_RULES: dict[str, tuple] = {
    # embeddings
    "embed": ("vocab", "d"),
    "lm_head": ("d", "vocab"),
    "dec_pos": (None, "d"),
    # attention
    "wq": ("d", "heads"),
    "wk": ("d", "heads"),
    "wv": ("d", "heads"),
    "wo": ("heads", "d"),
    "bq": ("heads",),
    "bk": ("heads",),
    "bv": ("heads",),
    # mlp
    "gate": ("d", "ff"),
    "up": ("d", "ff"),
    "down": ("ff", "d"),
    "up_b": ("ff",),
    "down_b": ("d",),
    # moe
    "router": ("d", None),
    # mamba
    "in_proj": ("d", "ff"),
    "out_proj": ("ff", "d"),
    "conv_w": (None, "ff"),
    "conv_b": ("ff",),
    "dt_bias": (None,),
    "A_log": (None,),
    "D_skip": (None,),
    # norms
    "scale": ("d",),
    "bias": ("d",),
}

# leaves under an "experts" subtree get the expert axis prepended
_EXPERT_PARENT = "experts"


def _path_names(path) -> list[str]:
    names = []
    for k in path:
        if hasattr(k, "key"):
            names.append(str(k.key))
        elif hasattr(k, "idx"):
            names.append(str(k.idx))
        else:  # pragma: no cover
            names.append(str(k))
    return names


def _spec_for(path, leaf, rules: ShardingRules, mesh) -> P:
    names = _path_names(path)
    leaf_name = names[-1] if names else ""
    logical = LEAF_RULES.get(leaf_name)
    if logical is None:
        return P()  # unknown leaves replicate (safe default)
    if _EXPERT_PARENT in names[:-1]:
        logical = ("expert",) + logical
    ndim = leaf.ndim
    shape = leaf.shape
    n_lead = ndim - len(logical)
    if n_lead < 0:  # leaf smaller than rule (e.g. squeezed) → replicate
        return P()
    axes: list = [None] * n_lead
    used: set = set()  # a mesh axis shards at most one dim (EP beats TP
    # inside expert stacks: the expert axis comes first in the rule tuple)
    for dim, ax in zip(shape[n_lead:], logical):
        m = rules.of(ax) if ax else None
        m = _filter_axes(m, mesh)
        if m is not None:
            maxes = m if isinstance(m, tuple) else (m,)
            if any(a in used for a in maxes):
                m = None
        if m is None:
            axes.append(None)
            continue
        maxes = m if isinstance(m, tuple) else (m,)
        size = 1
        for a in maxes:
            size *= mesh.shape[a]
        if dim % size == 0:
            axes.append(m)
            used.update(maxes)
        else:
            axes.append(None)
    return P(*axes)


def _filter_axes(m, mesh):
    """Drop mesh axes absent from this mesh (e.g. 'pod' on single-pod)."""
    if m is None:
        return None
    axes = m if isinstance(m, tuple) else (m,)
    present = tuple(a for a in axes if a in mesh.shape)
    if not present:
        return None
    return present if isinstance(m, tuple) else present[0]


def _is_spec(x) -> bool:
    return isinstance(x, P)


def param_specs(params: Any, mesh, rules: ShardingRules = ShardingRules()):
    """Tree of :class:`P` mirroring ``params`` (fake and meta tensors
    too)."""
    return pytree.tree_map_with_path(
        lambda path, leaf: _spec_for(path, leaf, rules, mesh), params)


def param_shardings(params: Any, mesh,
                    rules: ShardingRules = ShardingRules()):
    return to_shardings(param_specs(params, mesh, rules), mesh)


# --------------------------------------------------------------------------
# KV-cache / batch sharding (serving)
# --------------------------------------------------------------------------

# cache leaf name → logical axes of the trailing dims.  With batch=1
# (long-context) the batch axis won't divide and falls back to replication,
# and ``kv_seq`` (set to a mesh axis in the serve rules) carries the shard —
# flash-decoding style sequence sharding of the cache.
CACHE_RULES: dict[str, tuple] = {
    "k": ("batch", "kv_seq", "heads", None),
    "v": ("batch", "kv_seq", "heads", None),
    "k_scale": ("batch", "kv_seq", "heads"),
    "v_scale": ("batch", "kv_seq", "heads"),
    "index": ("batch",),
    "conv": ("batch", None, "ff"),
    "h": ("batch", "heads", None, None),
    "enc_out": ("batch", None, "d"),
    "step": ("batch",),
}


def cache_specs(cache: Any, mesh, rules: ShardingRules = ShardingRules()):
    def spec(path, leaf):
        names = _path_names(path)
        logical = CACHE_RULES.get(names[-1] if names else "")
        if logical is None:
            return P()
        ndim = leaf.ndim
        n_lead = ndim - len(logical)
        if n_lead < 0:
            return P()
        axes: list = [None] * n_lead
        used: set = set()  # a mesh axis may shard at most one dim
        for dim, ax in zip(leaf.shape[n_lead:], logical):
            m = _filter_axes(rules.of(ax) if ax else None, mesh)
            if m is not None:
                maxes = m if isinstance(m, tuple) else (m,)
                if any(a in used for a in maxes):
                    m = None
            if m is None:
                axes.append(None)
                continue
            size = 1
            for a in (m if isinstance(m, tuple) else (m,)):
                size *= mesh.shape[a]
            if dim % size == 0:
                axes.append(m)
                used.update(m if isinstance(m, tuple) else (m,))
            else:
                axes.append(None)
        return P(*axes)

    return pytree.tree_map_with_path(spec, cache)


def batch_specs(batch: Any, mesh, rules: ShardingRules = ShardingRules()):
    """Token batches: leading dim = batch, rest unsharded."""
    def spec(leaf):
        m = _filter_axes(rules.batch, mesh)
        if m is None or leaf.ndim == 0:
            return P()
        size = 1
        for a in (m if isinstance(m, tuple) else (m,)):
            size *= mesh.shape[a]
        if leaf.shape[0] % size:
            return P()
        return P(m, *([None] * (leaf.ndim - 1)))

    return pytree.tree_map(spec, batch)


def to_shardings(spec_tree: Any, mesh):
    return pytree.tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                           is_leaf=_is_spec)


def place(tree: Any, shardings: Any):
    """Every tensor leaf of ``tree`` placed by its :class:`NamedSharding`
    in ``shardings`` (a tree of the same structure)."""
    return pytree.tree_map(
        lambda leaf, sh: sh.place(leaf) if isinstance(leaf, torch.Tensor)
        else leaf, tree, shardings,
        is_leaf=lambda x: isinstance(x, NamedSharding))
