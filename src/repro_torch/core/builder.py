"""NetworkBuilder — the gppBuilder analogue, on PyTorch.

Two execution semantics for the *same* declarative network, mirroring the
paper's key property P4 (the same user methods run sequentially and in
parallel):

* :func:`run_sequential` — host-level denotational semantics (the paper's
  Listing-4 oracle): item by item, in declaration order.
* :func:`build` → :class:`CompiledNetwork` — the network is verified
  (``verify``), then run as one fused program over the whole item batch:
  connectors become splits and interleavings of the batch axis, a farm's
  workers become the batch dimension.

Both run on one device, the card unless the caller passes ``device="cpu"``;
the emitted items are moved there.  Built over a mesh
(:class:`repro_torch.launch.mesh.Mesh`, inside a world of its ranks), the
fused and streaming runs are one SPMD program: a FAN with an ``axis`` gives
each rank its block of the batch, the stages run on the local block, and
every point where the batch must be whole again (a cast, a MERGE with an
axis, a COMBINE, a Collect, an Engine with an axis of its own) gathers the
blocks in rank order (:func:`repro_torch.parallel.collectives.merge_gather`)
— the folds then run in item order as on one device, so results stay
bit-identical.  PyTorch runs eagerly, so a non-batched Worker (and every
Engine) runs as a loop over the items of the batch
followed by ``torch.stack`` — the same per-item calls as the oracle, which
is what keeps the two bit-identical even where the stage launches a
hand-written kernel that ``torch.func.vmap`` could not batch.

Logged execution (paper §8): ``CompiledNetwork.run(..., logged=True)``
executes stage by stage, timing each stage (CUDA events on the card) and
counting its FLOPs with ``torch.utils.flop_counter`` — exactly GPP's "two
versions of every process" trade (observability for peak speed).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time
from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from ..device import as_tensor_tree, resolve_device, to_device
from ..parallel.collectives import block, merge_gather
from .dataflow import Distribution, Kind, Network, NetworkError, ProcessDef
from .verify import verify

__all__ = ["run_sequential", "build", "CompiledNetwork", "StageLog",
           "make_emit_batch"]


# ==========================================================================
# Sequential oracle (denotational list semantics)
# ==========================================================================

def run_sequential(net: Network, instances: int, *, device=None):
    """Execute the network item by item, in declaration order, on
    ``device`` (``None``: the card).

    Returns ``{collect_name: finalised_value}``.  This is the correctness
    oracle: the fused and streaming runs must produce identical results.
    """
    dev = resolve_device(device)
    verify(net)
    order = net.toposort()
    # each value on a wire is a list of (orig_index, item) pairs
    wires: dict[tuple[str, str], list] = {}
    results: dict[str, Any] = {}

    def _inputs(name: str) -> list[list]:
        return [wires[(p, name)] for p in net.predecessors(name)]

    for name in order:
        p = net.procs[name]
        succs = net.successors(name)
        if p.kind is Kind.EMIT:
            stream = [(i, as_tensor_tree(item, dev))
                      for i, item in enumerate(_emit_items(p, instances))]
            out_streams = _spread_fan(stream, len(succs))
            for j, s in enumerate(succs):
                wires[(name, s)] = out_streams[j]
        elif p.kind is Kind.SPREADER:
            (stream,) = _inputs(name)
            if p.distribution is Distribution.FAN:
                outs = _spread_fan(stream, len(succs))
            else:  # casts: every successor gets a (deep) copy of the stream
                outs = [[(i, copy.deepcopy(v)) for (i, v) in stream]
                        for _ in succs]
            for j, s in enumerate(succs):
                wires[(name, s)] = outs[j]
        elif p.kind in (Kind.WORKER, Kind.ENGINE):
            (stream,) = _inputs(name)
            fn = p.fn if p.kind is Kind.WORKER else p.engine.as_worker_fn()
            out = [(i, fn(v, *p.modifier)) for (i, v) in stream]
            for s in succs:  # worker has exactly one successor (verified)
                wires[(name, s)] = out
        elif p.kind is Kind.REDUCER:
            streams = _inputs(name)
            if p.distribution is Distribution.COMBINE:
                flat = sorted((pair for s in streams for pair in s),
                              key=lambda t: t[0])
                acc = flat[0][1]
                for _, v in flat[1:]:
                    acc = p.fn(acc, v)
                out = [(0, acc)]
            else:  # MERGE: re-interleave by original index (fairSelect order)
                out = sorted((pair for s in streams for pair in s),
                             key=lambda t: t[0])
            for s in succs:
                wires[(name, s)] = out
        elif p.kind is Kind.COLLECT:
            streams = _inputs(name)
            flat = sorted((pair for s in streams for pair in s),
                          key=lambda t: t[0])
            acc = to_device(copy.deepcopy(p.init), dev)
            for _, v in flat:
                acc = p.fn(acc, v)
            results[name] = p.finalise(acc) if p.finalise else acc
    return results


def _emit_items(e: ProcessDef, instances: int) -> list:
    """The Emit's ``create(i)`` outputs, threading EmitWithLocal state."""
    if not e.modifier:
        return [e.fn(i) for i in range(instances)]
    local = e.modifier[0]()
    items = []
    for i in range(instances):
        item, local = e.fn(i, local)
        items.append(item)
    return items


def _spread_fan(stream: list, n_succ: int) -> list[list]:
    """Round-robin split preserving original indices (OneFanList semantics)."""
    if n_succ <= 1:
        return [list(stream)]
    return [stream[j::n_succ] for j in range(n_succ)]


# ==========================================================================
# Fused mode
# ==========================================================================

@dataclasses.dataclass
class StageLog:
    """One logged stage record (paper §8 analogue).  ``flops`` is None when
    the count would be wrong: the stage launched a hand-written kernel the
    counter cannot see, or counted nothing (elementwise work only)."""

    stage: str
    kind: str
    wall_s: float
    flops: float | None = None
    bytes_accessed: float | None = None

    def row(self) -> str:
        f = f"{self.flops:.3e}" if self.flops is not None else "-"
        b = f"{self.bytes_accessed:.3e}" if self.bytes_accessed is not None else "-"
        return f"{self.stage:<24} {self.kind:<9} {self.wall_s*1e3:10.3f}ms  flops={f} bytes={b}"


class CompiledNetwork:
    """A verified network bound to one device (and optionally a mesh of
    ranks), executable as one fused program (``run``), stage by stage with
    logging (``run(logged=True)``) or as a stream of microbatches
    (``run_streaming``).
    """

    def __init__(self, net: Network, mesh=None, device=None):
        self.net = net
        self.mesh = mesh
        if mesh is not None:
            mesh.device_mesh()  # raises outside a world of the mesh's size
            if device is None:
                device = mesh.device
            elif torch.device(device).type != mesh.device.type:
                raise NetworkError(f"device {device} is not the mesh's "
                                   f"{mesh.device}")
        self.device = resolve_device(device)
        self.report = verify(net)
        self.order = net.toposort()
        self.logs: list[StageLog] = []
        self.stream_stats = None  # set by run_streaming
        self._streams: dict = {}  # StreamExecutor cache (stage fns persist)

    # -- the mesh: where a wire's batch lies ---------------------------------
    def _mesh_axis(self, axis):
        """``axis`` cut to the axes of the mesh (None without a mesh or
        when none of them is there)."""
        if self.mesh is None or axis is None:
            return None
        axes = tuple(a for a in (axis if isinstance(axis, tuple) else (axis,))
                     if a in self.mesh.shape)
        if not axes:
            return None
        return axes if isinstance(axis, tuple) else axes[0]

    def _scatter(self, x, axis):
        """(this rank's block of the batch ``x`` over ``axis``, the axis it
        is sharded over).  A batch that does not split into the axis' ranks
        stays whole on every rank: ``(x, None)``."""
        ax = self._mesh_axis(axis)
        if ax is None:
            return x, None
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= self.mesh.shape[a]
        if _leading(x) % n:
            return x, None
        return pytree.tree_map(
            lambda l: block(l, self.mesh, ax) if isinstance(l, torch.Tensor)
            else l, x), ax

    def _whole(self, x, ax):
        """The whole batch of a wire sharded over ``ax`` (None: it is)."""
        if ax is None:
            return x
        return pytree.tree_map(
            lambda l: merge_gather(l, self.mesh, ax)
            if isinstance(l, torch.Tensor) else l, x)

    def _engine_axis(self, p: ProcessDef) -> bool:
        """Does the Engine shard its item over the mesh itself?"""
        return (p.kind is Kind.ENGINE and self.mesh is not None
                and getattr(p.engine, "axis", None) is not None)

    # -- shared stage path ---------------------------------------------------
    def stage_fn(self, name: str) -> Optional[Callable]:
        """The callable for one computational stage, on the batched value.

        This is the single stage path shared by all three execution modes:
        fused ``_trace`` calls it on the whole batch, logged execution times
        it, and the streaming executor (:mod:`.stream`) calls it per chunk.
        Structural stages (Emit, spreaders, MERGE reducers) return None:
        they are wiring, realised by each mode.
        """
        p = self.net.procs[name]
        if p.kind is Kind.WORKER:
            if p.batched:
                return lambda x: p.fn(x, *p.modifier)
            return lambda x: map_items(lambda v: p.fn(v, *p.modifier), x)
        if p.kind is Kind.ENGINE:
            return lambda x: map_items(
                lambda it: p.engine.apply(it, mesh=self.mesh), x)
        if p.kind is Kind.REDUCER and p.distribution is Distribution.COMBINE:
            def _comb(*vals):
                acc = vals[0]
                for v in vals[1:]:
                    acc = p.fn(acc, v)
                return _fold_batch(p.fn, acc)
            return _comb
        if p.kind is Kind.COLLECT and p.jit_combine:
            return lambda x: _fold_batch(p.fn, x,
                                         init=to_device(p.init, self.device))
        return None

    def collect_carry_fn(self, name: str) -> Callable:
        """Streaming variant of the Collect fold: ``(acc, chunk) -> acc``.

        Folds a microbatch into the running accumulator in item order, so a
        chain of carry folds over chunks is the *same* linear left fold as
        the fused ``stage_fn`` over the whole batch — bit-identical results.
        """
        p = self.net.procs[name]
        return lambda acc, x: _fold_batch(p.fn, x, init=acc)

    def combine_carry_fn(self, name: str) -> Callable:
        """Streaming variant of the COMBINE reducer: ``(acc, *chunks) -> acc``.

        Same shape as ``collect_carry_fn``: elementwise across branches, then
        a linear fold continued from the carried accumulator, preserving the
        fused mode's exact float association across chunk boundaries.
        """
        p = self.net.procs[name]

        def _carry(acc, *vals):
            x = vals[0]
            for v in vals[1:]:
                x = p.fn(x, v)
            return _fold_batch(p.fn, x, init=acc)

        return _carry

    # -- the fused program ---------------------------------------------------
    def _run_stages(self, batch, call: Callable):
        """Evaluate the network on a batched input pytree, calling each
        computational stage as ``call(name, kind, fn, *args)``.

        Returns (results_dict, host_streams_dict) where host_streams carries
        batched outputs destined for host-side collectors.
        """
        net = self.net
        # each wire: (value, the mesh axis its batch is sharded over or None)
        wires: dict[tuple[str, str], Any] = {}
        results: dict[str, Any] = {}
        host_streams: dict[str, Any] = {}

        def _in(name: str) -> list:
            return [wires[(p, name)] for p in net.predecessors(name)]

        def _whole_in(name: str) -> list:
            return [self._whole(x, ax) for x, ax in _in(name)]

        for name in self.order:
            p = net.procs[name]
            succs = net.successors(name)
            if p.kind is Kind.EMIT:
                for s in succs:
                    wires[(name, s)] = (batch, None)
            elif p.kind is Kind.SPREADER:
                (x,) = _whole_in(name)
                if p.distribution is Distribution.FAN:
                    outs = (_fan_split(x, len(succs)) if len(succs) > 1
                            else [x])
                    outs = [self._scatter(o, p.axis) for o in outs]
                else:  # casts: all read the same whole value
                    outs = [(x, None) for _ in succs]
                for j, s in enumerate(succs):
                    wires[(name, s)] = outs[j]
            elif p.kind in (Kind.WORKER, Kind.ENGINE):
                ((x, ax),) = _in(name)
                if self._engine_axis(p):  # it shards each whole item itself
                    x, ax = self._whole(x, ax), None
                out = call(name, p.kind.value, self.stage_fn(name), x)
                for s in succs:
                    wires[(name, s)] = (out, ax)
            elif p.kind is Kind.REDUCER:
                if p.distribution is Distribution.COMBINE:
                    # fold across branches, then across the batch axis
                    out = (call(name, "reducer", self.stage_fn(name),
                                *_whole_in(name)), None)
                elif len(net.predecessors(name)) == 1 and (
                        self._mesh_axis(p.axis) is None):
                    (out,) = _in(name)  # MERGE of one stream: a wire
                else:  # MERGE
                    xs = _whole_in(name)
                    out = (xs[0] if len(xs) == 1 else _fan_merge(xs), None)
                for s in succs:
                    wires[(name, s)] = out
            elif p.kind is Kind.COLLECT:
                xs = _whole_in(name)
                x = xs[0] if len(xs) == 1 else _fan_merge(xs)
                if p.jit_combine:
                    results[name] = call(name, "collect",
                                         self.stage_fn(name), x)
                else:
                    host_streams[name] = x  # fold host-side after the run
        return results, host_streams

    # -- public API ----------------------------------------------------------
    def make_batch(self, instances: int):
        """Build the batched Emit output on this network's device."""
        return make_emit_batch(self.net, instances, device=self.device)

    def run(self, batch=None, *, instances: Optional[int] = None,
            logged: bool = False):
        """Execute.  Provide either a pre-batched pytree or ``instances``."""
        if batch is None:
            if instances is None:
                raise NetworkError("run() needs batch= or instances=")
            batch = self.make_batch(instances)
        else:
            batch = to_device(batch, self.device)
        if logged:
            self.logs = []
            results, host_streams = self._run_stages(batch, self._timed)
        else:
            results, host_streams = self._run_stages(
                batch, lambda name, kind, fn, *args: fn(*args))
        return self._finalise(results, host_streams)

    def run_streaming(self, batch=None, *, instances: Optional[int] = None,
                      microbatch_size: int = 8,
                      max_in_flight: Optional[int] = None,
                      lanes: Optional[int] = None, fuse: bool = True):
        """Execute as a pipeline of microbatches (paper's process-oriented
        streaming, :mod:`.stream`): items are split into ``microbatch_size``
        chunks, each stage runs per chunk, chunks are dispatched without
        waiting for the device and only the retirement of a chunk at the
        Collect synchronises.  ``max_in_flight`` bounds the number of
        unretired chunks (defaults to the network's minimum positive channel
        capacity); ``lanes`` sets the work-stealing lane count for OneFanAny.

        Every Collect (and COMBINE reducer) folds chunks through a carried
        accumulator in the same linear order as the whole-batch fold, so
        results are bit-identical to the fused and logged runs.  Scheduling
        telemetry lands in ``self.stream_stats``.

        ``fuse`` (default on) runs each maximal linear Worker/Engine run as
        ONE composed stage (:func:`.stream.fused_chains`) — same op
        sequence, one dispatch per chain; the fused chains appear in
        ``stream_stats.fused``.
        """
        from .stream import StreamExecutor
        if batch is None:
            if instances is None:
                raise NetworkError("run_streaming() needs batch= or instances=")
            batch = self.make_batch(instances)
        else:
            batch = to_device(batch, self.device)
        key = (microbatch_size, max_in_flight, lanes, fuse)
        ex = self._streams.get(key)
        if ex is None:
            ex = self._streams[key] = StreamExecutor(
                self, microbatch_size=microbatch_size,
                max_in_flight=max_in_flight, lanes=lanes, fuse=fuse)
        out = ex.run(batch)
        self.stream_stats = ex.stats
        return out

    def _finalise(self, results, host_streams):
        out: dict[str, Any] = {}
        for p in self.net.collects():
            if p.jit_combine:
                val = results[p.name]
            else:
                val = fold_host(p, to_device(copy.deepcopy(p.init),
                                             self.device),
                                host_streams[p.name])
            out[p.name] = p.finalise(val) if p.finalise else val
        return out

    # -- logged (per-stage) execution: paper §8 ------------------------------
    def _timed(self, stage: str, kind: str, fn: Callable, *args):
        """Run one stage, waiting for the device, and log its time and FLOPs.

        Deliberately unfused (the paper's logged processes forgo
        @CompileStatic); use for bottleneck hunting, not for peak numbers.
        """
        from ..kernels import launch_counts
        _warm_flop_counter()
        launched = sum(launch_counts().values())
        counter = FlopCounterMode(display=False)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with counter:
                start.record()
                out = fn(*args)
                end.record()
            end.synchronize()
            wall = start.elapsed_time(end) / 1e3
        else:
            t0 = time.monotonic()
            with counter:
                out = fn(*args)
            wall = time.monotonic() - t0
        flops = counter.get_total_flops()
        if flops == 0 or sum(launch_counts().values()) != launched:
            flops = None  # nothing counted, or a kernel it cannot see ran
        self.logs.append(StageLog(stage, kind, wall, flops))
        return out

    def log_report(self) -> str:
        lines = [f"== netlog: {self.net.name} =="]
        total = sum(l.wall_s for l in self.logs) or 1e-12
        for l in self.logs:
            lines.append(l.row() + f"  ({100*l.wall_s/total:5.1f}%)")
        bottleneck = max(self.logs, key=lambda l: l.wall_s, default=None)
        if bottleneck:
            lines.append(f"-- bottleneck: {bottleneck.stage} "
                         f"({bottleneck.wall_s*1e3:.3f}ms)")
        return "\n".join(lines)


@functools.cache
def _warm_flop_counter() -> None:
    """The first operation under a FlopCounterMode pays a one-time set-up
    of seconds; pay it here, outside any timed stage."""
    with FlopCounterMode(display=False):
        torch.zeros(1) + 1


# -- batch/stream manipulation helpers -------------------------------------

def _leading(x) -> int:
    """Length of the leading (item) axis of a batched pytree."""
    leaves = [l for l in pytree.tree_leaves(x) if isinstance(l, torch.Tensor)]
    if not leaves or leaves[0].ndim == 0:
        raise NetworkError("batched value has no leading item axis")
    return leaves[0].shape[0]


def item_at(x, i: int):
    """Item ``i`` of a batched pytree (tensor leaves indexed, others kept)."""
    return pytree.tree_map(
        lambda l: l[i] if isinstance(l, torch.Tensor) else l, x)


def stack_trees(items: list):
    """Stack a list of equally-shaped pytrees along a new leading axis."""
    flat = [pytree.tree_flatten(it) for it in items]
    spec = flat[0][1]
    cols = zip(*(leaves for leaves, _ in flat))
    stacked = [None if col[0] is None else
               torch.stack([torch.as_tensor(l) for l in col]) for col in cols]
    return pytree.tree_unflatten(stacked, spec)


def map_items(fn: Callable, x):
    """Apply ``fn`` to every item of the batched pytree ``x`` in order and
    stack the results (the eager counterpart of ``jax.vmap``/``lax.map``)."""
    return stack_trees([fn(item_at(x, i)) for i in range(_leading(x))])


def fold_host(p: ProcessDef, acc, stream):
    """Fold a host-side Collect over the items of a batched stream."""
    for i in range(_leading(stream)):
        acc = p.fn(acc, item_at(stream, i))
    return acc


def make_emit_batch(net: Network, instances: int, *, device=None,
                    emit: Optional[ProcessDef] = None):
    """Materialise the single Emit's output (or ``emit``'s, for a network
    with several, as a cluster partition has) as a stacked batch pytree on
    ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    if emit is None:
        emits = net.emits()
        if len(emits) != 1:
            raise NetworkError("make_batch requires exactly one Emit")
        emit = emits[0]
    if instances <= 0:
        raise NetworkError(f"make_batch needs instances > 0, got {instances}")
    return stack_trees([as_tensor_tree(item, dev)
                        for item in _emit_items(emit, instances)])


def _fan_split(x, k: int):
    """Round-robin split of the leading axis into k streams (OneFanList)."""

    def _split(leaf, j):
        if leaf.shape[0] % k != 0:
            raise NetworkError(
                f"compiled FAN to {k} heterogeneous branches requires batch "
                f"divisible by {k}, got {leaf.shape[0]}")
        return leaf[j::k]

    return [pytree.tree_map(lambda l: _split(l, j), x) for j in range(k)]


def _fan_merge(xs):
    """Inverse of _fan_split: interleave k equal streams back in order."""

    def _merge(*leaves):
        stacked = torch.stack(leaves, dim=1)  # (n/k, k, ...)
        return stacked.reshape((-1,) + tuple(stacked.shape[2:]))

    return pytree.tree_map(_merge, *xs)


def _fold_batch(combine: Callable, x, init=None):
    """Left fold of ``combine`` over the leading batch axis, in item order.

    The order is what makes the fused, streaming and sequential runs
    bit-identical; a length-1 batch folds its only item.
    """
    leaves = pytree.tree_leaves(x)
    if not leaves or leaves[0].ndim == 0 or leaves[0].shape[0] == 1:
        item = pytree.tree_map(
            lambda l: l[0] if (isinstance(l, torch.Tensor) and l.ndim > 0)
            else l, x)
        return combine(init, item) if init is not None else item
    acc = item_at(x, 0)
    if init is not None:
        acc = combine(init, acc)
    for i in range(1, leaves[0].shape[0]):
        acc = combine(acc, item_at(x, i))
    return acc


def build(net: Network, mesh=None, *, device=None) -> CompiledNetwork:
    """Verify + bind the network to ``device`` (``None``: the card, or the
    mesh's device) and, optionally, to a ``mesh`` of ranks (inside a world
    of its size) — the gppBuilder entry point."""
    return CompiledNetwork(net, mesh=mesh, device=device)
