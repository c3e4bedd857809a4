"""Logical-axis sharding context.

Models annotate activations with *logical* axes ("batch", "seq", "heads",
"ff", ...); a :class:`ShardCtx` installed by the launcher maps those to mesh
axes.  The JAX package applies ``with_sharding_constraint``; here an
activation that is a ``DTensor`` (the model runs on DTensor parameters and
batches, :mod:`.sharding`) is redistributed to the placements the rules
give.  With no context installed the annotations are no-ops (after the
rank check), so the same model code runs on one device, in tests, and under
any mesh — the GPP property that one process definition serves every
topology (paper §11.7).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional

__all__ = ["ShardingRules", "ShardCtx", "shard_ctx", "current_ctx", "act",
           "is_dtensor", "placements"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical activation/param axis → mesh axis (or tuple, or None)."""

    batch: Any = ("pod", "data")
    seq: Any = None          # "model" under sequence parallelism
    heads: Any = "model"     # attention-head / mamba-head sharding (TP)
    ff: Any = "model"        # FFN hidden
    d: Any = None            # embedding/residual dim
    vocab: Any = "model"     # embedding-table rows / logits cols
    expert: Any = "model"    # MoE expert axis (EP)
    kv_seq: Any = None       # KV-cache sequence (flash-decoding over chips)
    stage: Any = None        # pipeline-parallel stage axis

    def of(self, logical: Optional[str]):
        if logical is None:
            return None
        return getattr(self, logical)


def is_dtensor(x) -> bool:
    """Is ``x`` a ``torch.distributed.tensor.DTensor``?"""
    return type(x).__name__ == "DTensor"


def placements(spec, mesh) -> tuple:
    """The DTensor placements of a spec (one entry per tensor dim: a mesh
    axis, a tuple of them, or None) on ``mesh``: one placement per mesh
    axis, ``Shard(dim)`` where the spec names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = {a: Replicate() for a in mesh.axis_names}
    for dim, m in enumerate(spec):
        for a in (() if m is None else m if isinstance(m, tuple) else (m,)):
            out[a] = Shard(dim)
    return tuple(out[a] for a in mesh.axis_names)


@dataclasses.dataclass
class ShardCtx:
    mesh: Any  # a repro_torch.launch.mesh.Mesh, or None
    rules: ShardingRules = ShardingRules()

    def spec(self, *logical: Optional[str]) -> tuple:
        return tuple(self.rules.of(ax) for ax in logical)

    def _filter(self, m):
        """Drop mesh axes the current mesh doesn't have (e.g. no 'pod')."""
        axes = m if isinstance(m, tuple) else (m,)
        present = tuple(a for a in axes if a in self.mesh.shape)
        if not present:
            return None
        return present if isinstance(m, tuple) else present[0]

    def _axis_size(self, m) -> int:
        axes = m if isinstance(m, tuple) else (m,)
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    def act_spec(self, shape, *logical: Optional[str]) -> tuple:
        """The spec :meth:`act` gives a tensor of ``shape``: mesh axes that
        do not divide the dim are dropped (e.g. 8 KV heads on a 16-way model
        axis fall back to replication), and a mesh axis shards at most one
        dim."""
        spec_axes = []
        used: set = set()
        for dim, ax in zip(shape, logical):
            m = self.rules.of(ax)
            m = self._filter(m) if m is not None else None
            if m is not None:
                maxes = m if isinstance(m, tuple) else (m,)
                if any(a in used for a in maxes):
                    m = None
            if m is None or dim % self._axis_size(m) != 0:
                spec_axes.append(None)
            else:
                spec_axes.append(m)
                used.update(m if isinstance(m, tuple) else (m,))
        return tuple(spec_axes)

    def act(self, x, *logical: Optional[str]):
        """Constrain activation ``x`` whose dims carry ``logical`` axes: a
        DTensor is redistributed to the placements of :meth:`act_spec`; a
        plain tensor is returned as it is (it is the same on every rank)."""
        if x is None:
            return x
        if x.ndim != len(logical):
            raise ValueError(
                f"act: rank {x.ndim} vs {len(logical)} logical axes")
        if self.mesh is None or not is_dtensor(x):
            return x
        want = placements(self.act_spec(x.shape, *logical), self.mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


_NULL = ShardCtx(mesh=None)
_ctx: contextvars.ContextVar[ShardCtx] = contextvars.ContextVar(
    "repro_torch_shard_ctx", default=_NULL)


def current_ctx() -> ShardCtx:
    return _ctx.get()


@contextlib.contextmanager
def shard_ctx(mesh, rules: ShardingRules = ShardingRules()):
    """Install ``rules`` over ``mesh`` for the models' :func:`act`.  Inside
    a world, plain tensors met by DTensor operations count as replicated
    (``implicit_replication``), as an unsharded array does under JAX."""
    tok = _ctx.set(ShardCtx(mesh=mesh, rules=rules))
    try:
        with contextlib.ExitStack() as stack:
            if mesh is not None and mesh.in_world():
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
            yield _ctx.get()
    finally:
        _ctx.reset(tok)


def act(x, *logical: Optional[str]):
    """Annotate activation dims with logical axes (no-op without a ctx)."""
    return current_ctx().act(x, *logical)
