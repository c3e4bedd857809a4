"""Streaming microbatch executor — the process-oriented half of the paper.

The fused builder (:mod:`.builder`) materialises the whole item batch and
runs the network as one program; the paper's GPP runtime instead *streams*
items through Emit → Worker/Engine → Collect concurrently.  This module
recovers that throughput model on top of the GPU's asynchronous launches:

* the item batch is split into ``microbatch_size`` chunks
  (:func:`microbatch_plan` — the last chunk may be smaller);
* every computational stage runs per chunk through the builder's shared
  ``stage_fn`` path;
* chunks are dispatched through the stage DAG without waiting: the host
  queues each chunk's kernels on the current CUDA stream, records an event
  behind them, and waits on that event only when the chunk *retires* at
  Collect, so host scheduling overlaps device compute;
* the number of un-retired chunks in flight is bounded (backpressure): the
  depth defaults to the network's minimum positive CSP channel capacity
  (:meth:`Network.min_capacity`), so a tight channel throttles the whole
  pipeline exactly as a buffered CSP chain would;
* ``OneFanAny`` becomes work-stealing chunk assignment: each chunk goes to
  the least-loaded lane (with explicit per-worker branches, the whole chunk
  is routed down that branch), and the schedule is recorded in
  :class:`StreamStats`.

Correctness is anchored two ways.  Numerically, every Collect and COMBINE
reducer folds chunks with a carried accumulator in item order — the same
linear left fold as the whole-batch run, so results are bit-identical to
the fused and logged runs.  Formally, :func:`streaming_abstract_model`
builds the CSP model of this schedule (chunks as items, lanes as concurrent
stage chains) and :func:`.csp.trace_equivalent` checks it against
:func:`synchronous_abstract_model` — the paper's §6.1.1 ``[T=`` refinement
story applied to our own runtime.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import deque
from typing import Any, Optional

import torch
import torch.utils._pytree as pytree

from ..device import to_device
from . import trace as _trace
from .builder import CompiledNetwork, _fan_merge, _fan_split, fold_host
from .dataflow import Distribution, Kind, Network, NetworkError
from .processes import AnyFanOne, Collect, Emit, OneFanAny, Worker

__all__ = [
    "microbatch_plan",
    "slice_microbatch",
    "stack_microbatches",
    "SlotEvent",
    "SlotPlan",
    "fused_chains",
    "plan_depth_lanes",
    "coalesced_capacity",
    "EmitChunks",
    "StreamStats",
    "StreamExecutor",
    "streaming_abstract_model",
    "synchronous_abstract_model",
]

_SKIP = object()  # sentinel: no chunk flowed down this branch


class EmitChunks(dict):
    """Chunk values keyed by Emit process name (cluster partitions feed
    several boundary-ingress Emits per chunk).  A dedicated type: a plain
    dict is a legal *pytree batch* and must reach every Emit whole."""


# ==========================================================================
# Microbatch planning
# ==========================================================================

def microbatch_plan(n_items: int, microbatch_size: int) -> list[tuple[int, int]]:
    """``[(lo, hi), ...]`` half-open chunk bounds covering ``[0, n_items)``.

    The last chunk may be smaller than ``microbatch_size``; callers that need
    uniform chunks use :func:`stack_microbatches`.
    """
    if microbatch_size <= 0:
        raise NetworkError(f"microbatch_size must be > 0, got {microbatch_size}")
    if n_items < 0:
        raise NetworkError(f"n_items must be >= 0, got {n_items}")
    return [(lo, min(lo + microbatch_size, n_items))
            for lo in range(0, n_items, microbatch_size)]


def slice_microbatch(batch, lo: int, hi: int):
    """Slice ``[lo, hi)`` off the leading axis of every tensor leaf."""
    return pytree.tree_map(
        lambda l: l[lo:hi] if isinstance(l, torch.Tensor) else l, batch)


def stack_microbatches(batch, n_micro: int):
    """``(B, ...)`` leaves → ``(n_micro, B // n_micro, ...)``.

    The uniform-chunk reshape of the same microbatch schedule, used where the
    chunk axis must be looped over as a whole (pipeline stages, gradient
    accumulation).
    """

    def _one(leaf):
        b = leaf.shape[0]
        if n_micro <= 0 or b % n_micro:
            raise NetworkError(
                f"batch axis {b} not divisible into {n_micro} microbatches")
        return leaf.reshape(n_micro, b // n_micro, *leaf.shape[1:])

    return pytree.tree_map(_one, batch)


# ==========================================================================
# Slot-batch plans (continuous batching: requests join/leave between chunks)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class SlotEvent:
    """One admission-queue transition: request ``rid`` joined or left slot
    ``slot`` between decode chunks ``step - 1`` and ``step``."""

    step: int
    kind: str   # "join" | "leave"
    slot: int
    rid: int


class SlotPlan:
    """Which request owns which row of a slot-batched decode step.

    The serving engine's counterpart of :func:`microbatch_plan`: where a
    batch plan schedules a *fixed* item set into chunks, a slot plan
    schedules an *open-ended* request stream into a fixed row set — requests
    ``claim`` the lowest free slot when they join between decode chunks
    (the OneFanAny any-channel at request level) and ``release`` it when
    they finish, and every transition lands in :attr:`events` so an
    admission trace can be replayed or audited."""

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise NetworkError(f"SlotPlan: n_slots must be > 0, got {n_slots}")
        self.n_slots = n_slots
        self.step = 0                       # decode chunks ticked so far
        self.events: list[SlotEvent] = []
        self._owner: list[Optional[int]] = [None] * n_slots

    @property
    def n_free(self) -> int:
        return sum(o is None for o in self._owner)

    def owner(self, slot: int) -> Optional[int]:
        return self._owner[slot]

    def claim(self, rid: int) -> int:
        """Seat ``rid`` in the lowest free slot; raises when the batch is
        full (admission must wait for a leave)."""
        for s, owner in enumerate(self._owner):
            if owner is None:
                self._owner[s] = rid
                self.events.append(SlotEvent(self.step, "join", s, rid))
                return s
        raise NetworkError(f"SlotPlan: no free slot for request {rid}")

    def release(self, slot: int) -> int:
        """Free ``slot``; returns the rid that held it."""
        rid = self._owner[slot]
        if rid is None:
            raise NetworkError(f"SlotPlan: slot {slot} is already free")
        self._owner[slot] = None
        self.events.append(SlotEvent(self.step, "leave", slot, rid))
        return rid

    def active(self) -> list[tuple[int, int]]:
        """``[(slot, rid), ...]`` for the occupied rows, slot order."""
        return [(s, r) for s, r in enumerate(self._owner) if r is not None]

    def mask(self) -> torch.Tensor:
        """(n_slots,) bool advance mask for the batched decode step."""
        return torch.tensor([o is not None for o in self._owner],
                            dtype=torch.bool)

    def tick(self) -> None:
        """One decode chunk retired; joins/leaves now belong to the gap
        before the next chunk."""
        self.step += 1


# ==========================================================================
# Chain fusion planning (shared by the executor and the CSP abstraction)
# ==========================================================================

def fused_chains(net: Network) -> list[tuple[str, ...]]:
    """Maximal linear runs of functional stages that may run as one stage.

    A run ``a -> b -> ...`` fuses when every member is a Worker/Engine, every
    link is the sole successor of its source and the sole predecessor of its
    destination, and no connector (fan/cast/reducer) sits inside the run —
    i.e. the stages form a straight pipe with no observable interleaving
    point between them.  Fusing such a run into one per-chunk call preserves
    results exactly (same op sequence) while cutting per-chunk dispatch to
    one call per chain instead of one per stage.

    Only runs of length >= 2 are returned; each is a tuple of stage names in
    dataflow order.
    """
    chains: list[tuple[str, ...]] = []
    in_chain: set[str] = set()
    for name in net.toposort():
        if name in in_chain:
            continue
        if net.procs[name].kind not in (Kind.WORKER, Kind.ENGINE):
            continue
        chain = [name]
        node = name
        while True:
            succs = net.successors(node)
            if len(succs) != 1:
                break
            nxt = succs[0]
            if (net.procs[nxt].kind not in (Kind.WORKER, Kind.ENGINE)
                    or len(net.predecessors(nxt)) != 1):
                break
            chain.append(nxt)
            node = nxt
        if len(chain) > 1:
            chains.append(tuple(chain))
            in_chain.update(chain)
    return chains


def plan_depth_lanes(net: Network, max_in_flight: Optional[int],
                     lanes: Optional[int]) -> tuple[int, int]:
    """The (in-flight depth, lane count) a StreamExecutor will run with.

    Depth defaults to the network's minimum positive CSP channel capacity
    (rendezvous networks get 2); lanes default to the widest OneFanAny (or
    the depth when no fan is present).
    """
    if max_in_flight is not None:
        depth = max_in_flight
    else:
        depth = net.min_capacity() or 2
    if depth < 1:
        raise NetworkError(f"max_in_flight must be >= 1, got {depth}")
    if lanes is not None and lanes < 1:
        raise NetworkError(f"lanes must be >= 1, got {lanes}")
    fan_widths = [
        len(net.successors(n)) for n, p in net.procs.items()
        if (p.kind is Kind.SPREADER and p.distribution is Distribution.FAN
            and p.fan_any)]
    n_lanes = lanes if lanes is not None else max(fan_widths + [depth])
    return depth, n_lanes


def coalesced_capacity(depth: int, lanes: int, record_bytes: int,
                       coalesce_bytes: int, floor: int = 2) -> int:
    """FIFO slot count for a cut channel whose transport coalesces records.

    With a ``coalesce_bytes`` budget, one queue slot carries
    ``budget // record_bytes`` records, so the consumer's in-flight appetite
    (``max(depth, lanes)`` records) fits in proportionally fewer slots —
    never below the rendezvous floor of 2.  ``floor`` is the transport's
    uncoalesced default capacity: when records are larger than the budget
    each ships alone (one record per slot), and the channel gets exactly
    the uncoalesced sizing ``max(floor, depth, lanes)``."""
    per_slot = max(1, coalesce_bytes // max(1, record_bytes))
    if per_slot == 1:
        return max(floor, depth, lanes)  # degraded: uncoalesced sizing
    appetite = max(depth, lanes, 2)
    return max(2, -(-appetite // per_slot))


# ==========================================================================
# The executor
# ==========================================================================

@dataclasses.dataclass
class StreamStats:
    """Telemetry of one streaming run."""

    n_items: int = 0
    microbatch_size: int = 0
    n_chunks: int = 0
    depth: int = 0  # bounded in-flight chunks (backpressure)
    lanes: int = 1
    schedule: list = dataclasses.field(default_factory=list)  # (chunk, lane)
    stalls: int = 0  # times the dispatcher blocked on backpressure
    # live progress, incremented at retirement (the only synchronisation
    # point).  Unlike ``n_items``/``n_chunks`` — plan totals preset when the
    # run starts — these count what actually finished.
    chunks_done: int = 0
    items_done: int = 0
    # per-stage buffer-donation outcomes: {stage: [chunks_requested,
    # chunks_honoured]}.  The port donates nothing (PyTorch has no buffer
    # donation to request), so every count stays 0; the keys still list the
    # stages that ran.
    donation: dict = dataclasses.field(default_factory=dict)
    donation_enabled: bool = False
    # fused-chain composition: one tuple of stage names per linear run that
    # ran as a single per-chunk stage (empty when nothing fused)
    fused: list = dataclasses.field(default_factory=list)
    # chunk-replay bookkeeping (cluster recovery): how many times this run
    # was resumed after an interrupted stream, and from which chunk
    replays: int = 0
    resumed_at: Optional[int] = None

    def donation_summary(self) -> str:
        if not self.donation_enabled:
            return "donation: disabled (PyTorch has no buffer donation)"
        per = " ".join(f"{s}={h}/{r}" for s, (r, h) in
                       sorted(self.donation.items()))
        return f"donation: {per or '(no functional stages)'}"

    def fused_summary(self) -> str:
        if not self.fused:
            return "fused: (no chains)"
        per = " ".join("+".join(chain) for chain in self.fused)
        return f"fused: {per}"

    def summary(self) -> str:
        req = sum(r for r, _ in self.donation.values())
        hon = sum(h for _, h in self.donation.values())
        replay = (f", replays={self.replays}@chunk{self.resumed_at}"
                  if self.replays else "")
        return (f"stream: {self.n_chunks} chunks × ≤{self.microbatch_size} "
                f"items, depth={self.depth}, lanes={self.lanes}, "
                f"stalls={self.stalls}, donated={hon}/{req}, "
                f"fused_chains={len(self.fused)}{replay}")


@dataclasses.dataclass
class _ReplayState:
    """What survives an interrupted streaming run.  Captured when the
    interruption happened *before* the chunk had any effect (a cluster
    host's ingress recv failed because its producer host failed): chunks
    ``< next_ci`` are folded into the accumulators, chunk ``next_ci``
    onwards never entered the DAG.  A host holding one reports itself
    *stalled* (a survivor of a peer's failure) rather than failed, and
    :meth:`StreamExecutor.resume_plan` picks the run up at ``next_ci``."""

    next_ci: int          # first chunk that was NOT folded
    plan: list            # full bounds of the interrupted run
    jit_accs: dict        # per-Collect fold accumulators
    host_accs: dict       # per-Collect host-side fold accumulators
    combine_carry: dict   # per-COMBINE carried accumulators
    stats: "StreamStats"  # telemetry of the interrupted run


class StreamExecutor:
    """Run a :class:`CompiledNetwork` as a pipeline of microbatches."""

    # exception types whose mid-run capture leaves a :class:`_ReplayState`:
    # raised by _chunk_inputs BEFORE the chunk had any effect (the cluster
    # PartitionExecutor sets this to its transport error type)
    _resumable_errors: tuple = ()

    def __init__(self, compiled: CompiledNetwork, *, microbatch_size: int,
                 max_in_flight: Optional[int] = None,
                 lanes: Optional[int] = None, fuse: bool = True,
                 recorder: Optional[_trace.TraceRecorder] = None):
        self.cn = compiled
        self.net = compiled.net
        self.order = compiled.order
        self.mb = microbatch_size
        # observability: the process-default TraceRecorder (disabled unless
        # trace.enable()) or an explicitly owned one (cluster hosts get one
        # each, so spans carry the right host even for thread hosts)
        self.rec = recorder if recorder is not None else _trace.current()
        # depth: bounded in-flight chunks; lanes: work-stealing lane count
        # (explicit OneFanAny branches define it, otherwise as many lanes as
        # chunks can be in flight)
        self.depth, self.lanes = plan_depth_lanes(
            self.net, max_in_flight, lanes)
        self._outstanding = [0] * self.lanes
        self._combine_carry: dict = {}  # per-run COMBINE accumulators
        self.replay_state: Optional[_ReplayState] = None  # interrupted run
        # durability: with a snapshotter (a train.checkpoint.Checkpointer)
        # attached, the drive loop persists the fold accumulators every
        # `snapshot_every` chunks, so an interrupted batch replays from the
        # last snapshot instead of chunk 0 (and a fresh controller can adopt
        # the on-disk state).  `snapshot_tag` is (batch_id, epoch), stamped
        # by the cluster host loop; `on_snapshot` is a pre-write hook (a
        # fault injector can die there, mid-snapshot)
        self.snapshotter = None
        self.snapshot_every: int = 0
        self.snapshot_tag: tuple = (0, 1)
        self.on_snapshot = None
        self._snap_seq = 0
        # per-stage callables persist across runs; jit_builds counts their
        # first builds, so a warm executor stays at the same number
        self._fns: dict = {}
        self.jit_builds = 0
        # chain fusion: a straight Worker/Engine run executes as ONE
        # per-chunk stage (composed via the shared stage_fn path)
        self._chains = fused_chains(self.net) if fuse else []
        self._chain_of_head = {c[0]: c for c in self._chains}
        self._chain_members = {n for c in self._chains for n in c[1:]}
        self.stats = self._new_stats(0, 0)

    def _new_stats(self, n_items: int, n_chunks: int) -> StreamStats:
        return StreamStats(n_items=n_items, microbatch_size=self.mb,
                           n_chunks=n_chunks, depth=self.depth,
                           lanes=self.lanes, fused=list(self._chains))

    def _stage_label(self, name: str) -> str:
        """Telemetry key for a stage: fused chains report as one unit."""
        chain = self._chain_of_head.get(name)
        return "+".join(chain) if chain else name

    # -- per-stage callable cache (shared stage_fn path) -------------------
    def _cached(self, key, make):
        fn = self._fns.get(key)
        if fn is None:
            self.jit_builds += 1
            fn = self._fns[key] = make()
        return fn

    def _stage_call(self, name: str):
        """The callable for ``name`` — for a fused-chain head, the
        composition of every member's ``stage_fn``."""
        def make():
            chain = self._chain_of_head.get(name)
            if chain is None:
                return self.cn.stage_fn(name)
            fns = tuple(self.cn.stage_fn(m) for m in chain)

            def fused(x):
                for f in fns:
                    x = f(x)
                return x

            return fused

        return self._cached(name, make)

    def _carry_call(self, name: str):
        return self._cached(("carry", name),
                            lambda: self.cn.collect_carry_fn(name))

    def _combine_carry_call(self, name: str):
        return self._cached(("comb", name),
                            lambda: self.cn.combine_carry_fn(name))

    # -- work stealing ------------------------------------------------------
    def _steal_lane(self, chunk_idx: int) -> int:
        """OneFanAny chunk assignment: the least-loaded lane takes the chunk
        (any-channel semantics at microbatch granularity)."""
        lane = min(range(self.lanes), key=self._outstanding.__getitem__)
        self._outstanding[lane] += 1
        self.stats.schedule.append((chunk_idx, lane))
        return lane

    def _check_fan_divisibility(self, plan) -> None:
        """Fail fast (before any dispatch) when a heterogeneous FAN cannot
        split some chunk evenly — and name the knob the caller must turn."""
        for name in self.order:
            p = self.net.procs[name]
            succs = self.net.successors(name)
            if (p.kind is Kind.SPREADER
                    and p.distribution is Distribution.FAN
                    and len(succs) > 1 and not p.fan_any
                    and not self._homogeneous_fan(name)):
                k = len(succs)
                bad = sorted({hi - lo for lo, hi in plan if (hi - lo) % k})
                if bad:
                    raise NetworkError(
                        f"streaming over heterogeneous FAN {name!r} "
                        f"({k} branches) needs every microbatch divisible "
                        f"by {k}; microbatch_size={self.mb} yields chunk "
                        f"sizes {bad} — pick a microbatch_size (and item "
                        f"count) divisible by {k}")

    def _branch_signature(self, start: str):
        """The tag sequence of the functional chain from ``start`` down to
        the join node, or None when the branch itself branches (give up)."""
        sig: list = []
        node = start
        while True:
            p = self.net.procs[node]
            if p.kind not in (Kind.WORKER, Kind.ENGINE):
                sig.append(("join", node))
                return tuple(sig)
            # untagged workers count as unique (conservative: heterogeneous)
            sig.append(p.tag if p.tag is not None else node)
            succs = self.net.successors(node)
            if len(succs) != 1:
                return None
            node = succs[0]

    def _homogeneous_fan(self, name: str) -> bool:
        """True when every branch of a FAN runs the *same* stage-tag chain to
        the same join — the paper's CSPm Def 7 condition (workers of one
        stage share one ``f``), so whole chunks may route to any single
        branch without changing results."""
        sigs = {self._branch_signature(s) for s in self.net.successors(name)}
        return None not in sigs and len(sigs) == 1

    # -- one chunk through the DAG ------------------------------------------
    def _dispatch_chunk(self, ci: int, chunk, final: bool):
        """Push one microbatch through every stage (no waiting on the
        device).

        Returns (collect_streams, host_streams, lanes_used): the values bound
        for each Collect (pre-fold), the host-side collect streams, and the
        work-stealing lanes this chunk occupies.
        """
        net, cn = self.net, self.cn
        wires: dict[tuple[str, str], Any] = {}
        # over a mesh: the axis a wire's chunk is sharded over (absent: the
        # chunk is whole on every rank), as in the fused run
        sharded: dict[tuple[str, str], Any] = {}
        collect_streams: dict[str, Any] = {}
        host_streams: dict[str, Any] = {}
        lanes_used: list[int] = []

        def _pop_in(name: str, whole: bool = True) -> list:
            xs = []
            for q in net.predecessors(name):
                x, ax = wires.pop((q, name)), sharded.pop((q, name), None)
                xs.append(x if x is _SKIP or not whole
                          else cn._whole(x, ax))
            return xs

        def _scatter(name: str, s: str, x) -> None:
            if x is not _SKIP and p.distribution is Distribution.FAN:
                x, sharded[(name, s)] = cn._scatter(x, p.axis)
            wires[(name, s)] = x

        for name in self.order:
            p = net.procs[name]
            succs = net.successors(name)
            if p.kind is Kind.EMIT:
                out = chunk[name] if isinstance(chunk, EmitChunks) else chunk
                for s in succs:
                    wires[(name, s)] = out
            elif p.kind is Kind.SPREADER:
                (x,) = _pop_in(name)
                if x is _SKIP:
                    for s in succs:
                        wires[(name, s)] = _SKIP
                elif p.distribution is Distribution.FAN and len(succs) > 1:
                    if p.fan_any or self._homogeneous_fan(name):
                        # whole chunk to one branch: work-stealing lane for
                        # OneFanAny, round-robin for a homogeneous OneFanList
                        lane = (self._steal_lane(ci) if p.fan_any
                                else ci % len(succs))
                        if p.fan_any:
                            lanes_used.append(lane)
                        take = lane % len(succs)
                        for j, s in enumerate(succs):
                            _scatter(name, s, x if j == take else _SKIP)
                    else:  # heterogeneous branches: item-level round-robin —
                        # every chunk must split evenly or assignment drifts
                        # from the sequential oracle's
                        outs = _fan_split(x, len(succs))
                        for j, s in enumerate(succs):
                            _scatter(name, s, outs[j])
                else:  # one successor, or casts: every successor reads the
                    # same value (stages never write their inputs)
                    for s in succs:
                        _scatter(name, s, x)
            elif p.kind in (Kind.WORKER, Kind.ENGINE):
                if name in self._chain_members:
                    continue  # runs inside its chain head's fused stage
                chain = self._chain_of_head.get(name)
                label = self._stage_label(name)
                # a fused chain's output feeds the TAIL's successors
                out_of, succs = ((chain[-1], net.successors(chain[-1]))
                                 if chain else (name, succs))
                ax = sharded.get((net.predecessors(name)[0], name))
                if any(cn._engine_axis(net.procs[m])  # it shards each
                       for m in chain or (name,)):    # whole item itself
                    (x,), ax = _pop_in(name), None
                else:
                    (x,) = _pop_in(name, whole=False)
                if x is _SKIP:
                    out = _SKIP
                else:
                    out = self._stage_call(name)(x)
                    # conformance vocabulary: chunk ci traversed this stage
                    # (fused chains report "a+b" — every member applied)
                    self.rec.instant("stage", "csp", stage=label, ci=ci)
                    self.stats.donation.setdefault(label, [0, 0])
                for s in succs:
                    wires[(out_of, s)] = out
                    if ax is not None:
                        sharded[(out_of, s)] = ax
            elif p.kind is Kind.REDUCER:
                xs = [v for v in _pop_in(name) if v is not _SKIP]
                if p.distribution is Distribution.COMBINE:
                    # carry the fold across chunks (same float association as
                    # the fused whole-batch fold); downstream sees the final
                    # accumulator once, on the last chunk — exactly fused
                    carry = self._combine_carry.get(name)
                    if carry is None:
                        acc = self._stage_call(name)(*xs)
                    else:
                        acc = self._combine_carry_call(name)(carry, *xs)
                    if final:
                        self._combine_carry.pop(name, None)
                        out = acc
                    else:
                        self._combine_carry[name] = acc
                        out = _SKIP
                else:  # MERGE (all-skip when e.g. every lane sat out a chunk)
                    if not xs:
                        out = _SKIP
                    else:
                        out = xs[0] if len(xs) == 1 else _fan_merge(xs)
                for s in succs:
                    wires[(name, s)] = out
            elif p.kind is Kind.COLLECT:
                xs = [v for v in _pop_in(name) if v is not _SKIP]
                if not xs:  # upstream COMBINE still accumulating
                    continue
                x = xs[0] if len(xs) == 1 else _fan_merge(xs)
                if p.jit_combine:
                    collect_streams[name] = x
                else:
                    host_streams[name] = x
        return collect_streams, host_streams, lanes_used

    # -- retirement (the only synchronisation point) -------------------------
    def _retire(self, entry, host_accs) -> None:
        ci, chunk_items, lanes_used, host_streams, done = entry
        with self.rec.span("retire", "stream", ci=ci):
            # Collect is the CSP sink: wait for every kernel queued up to
            # this chunk's dispatch (later chunks keep running behind it)
            if done is not None:
                done.synchronize()
            for name, stream in host_streams.items():
                self.rec.instant("collect", "csp", collect=name, ci=ci)
                host_accs[name] = fold_host(self.net.procs[name],
                                            host_accs[name], stream)
        self.stats.chunks_done += 1
        self.stats.items_done += chunk_items
        for lane in lanes_used:
            self._outstanding[lane] -= 1

    def run(self, batch):
        """Stream ``batch`` through the network; returns the Collect dict."""
        leaves = [l for l in pytree.tree_leaves(batch)
                  if isinstance(l, torch.Tensor)]
        if not leaves:
            raise NetworkError("run: empty batch")
        return self._run_plan(microbatch_plan(leaves[0].shape[0], self.mb),
                              batch)

    # -- hooks the cluster PartitionExecutor overrides -----------------------
    def _chunk_inputs(self, ci: int, lo: int, hi: int, batch):
        """The value(s) the Emit(s) produce for chunk ``ci``."""
        return slice_microbatch(batch, lo, hi)

    def _forward_egress(self, ci: int, host_streams: dict) -> None:
        """Ship boundary-collect values (cluster cut channels); base: none."""

    def _local_collects(self) -> list:
        """The Collects whose folds this executor owns (cluster partitions
        exclude boundary shims)."""
        return list(self.net.collects())

    def _run_plan(self, plan, batch, *, start_ci: int = 0):
        """Fresh run over ``plan[start_ci:]`` (chunk numbering stays aligned
        with the full batch, so transported chunk ids match the peers')."""
        self._check_fan_divisibility(plan)
        self.replay_state = None
        self.stats = self._new_stats(plan[-1][1] if plan else 0, len(plan))
        self._outstanding = [0] * self.lanes
        self._combine_carry = {}
        jit_accs: dict[str, Any] = {}
        host_accs = {p.name: to_device(copy.deepcopy(p.init), self.cn.device)
                     for p in self._local_collects() if not p.jit_combine}
        return self._drive(plan, batch, start_ci, jit_accs, host_accs)

    def reset_run_state(self) -> None:
        """Forget any interrupted run (a controller is starting a fresh
        batch or a replay from scratch): resume state and COMBINE carries
        go.  Subclasses clear whatever per-run buffers they add."""
        self.replay_state = None
        self._combine_carry = {}

    def resume_plan(self, batch=None):
        """Resume the interrupted run captured in :attr:`replay_state`:
        chunks already folded stay folded, only the lost tail streams."""
        st = self.replay_state
        if st is None:
            raise NetworkError("resume_plan: no interrupted run to resume")
        self.replay_state = None
        self._combine_carry = st.combine_carry
        self.stats = st.stats
        self.stats.replays += 1
        if self.stats.resumed_at is None:
            self.stats.resumed_at = st.next_ci
        self._outstanding = [0] * self.lanes
        return self._drive(st.plan, batch, st.next_ci, st.jit_accs,
                           st.host_accs)

    # -- durability: fold-state snapshot / restore ---------------------------
    def snapshot_state(self, plan, next_ci: int, jit_accs: dict,
                       host_accs: dict) -> dict:
        """A device-free, picklable image of the fold state covering
        chunks ``[0, next_ci)`` — the on-disk twin of :class:`_ReplayState`.
        Valid only at a retire-consistent boundary (no chunk in flight);
        every tensor is copied to the CPU here, before any writer thread
        sees the tree."""
        from ..cluster.durable import to_host
        batch_id, epoch = self.snapshot_tag
        return {"batch_id": batch_id, "epoch": epoch,
                "next_ci": next_ci, "bounds": list(plan),
                "jit_accs": to_host(jit_accs),
                "host_accs": to_host(host_accs),
                "combine_carry": to_host(self._combine_carry),
                "stats": copy.deepcopy(self.stats)}

    def _save_snapshot(self, plan, next_ci, jit_accs, host_accs) -> None:
        from ..cluster.durable import _to_blob
        with self.rec.span("snapshot", "durable", ci=next_ci,
                           seq=self._snap_seq + 1) as sp:
            state = self.snapshot_state(plan, next_ci, jit_accs, host_accs)
            if self.on_snapshot is not None:
                self.on_snapshot(next_ci)  # fault-injection point: die here
            self._snap_seq += 1
            blob = _to_blob(state)
            sp.set(nbytes=blob["blob"].nbytes)
            self.snapshotter.save(self._snap_seq, blob)

    def resume_from_state(self, state: dict, batch=None):
        """Stream the tail of an interrupted run from an on-disk snapshot:
        fold accumulators restored as of ``state["next_ci"]`` onto this
        executor's device, remaining chunks re-driven with full-batch chunk
        numbering intact."""
        dev = self.cn.device
        with self.rec.span("snapshot_restore", "durable",
                           ci=state["next_ci"]):
            self.replay_state = None
            self._combine_carry = to_device(dict(state["combine_carry"]),
                                            dev)
            self.stats = state["stats"]
            self.stats.replays += 1
            if self.stats.resumed_at is None:
                self.stats.resumed_at = state["next_ci"]
            self._outstanding = [0] * self.lanes
            jit_accs = to_device(dict(state["jit_accs"]), dev)
            host_accs = to_device(dict(state["host_accs"]), dev)
        return self._drive(state["bounds"], batch, state["next_ci"],
                           jit_accs, host_accs)

    def _drive(self, plan, batch, start_ci, jit_accs, host_accs):
        rec = self.rec
        cuda = self.cn.device.type == "cuda"
        in_flight: deque = deque()
        for ci in range(start_ci, len(plan)):
            lo, hi = plan[ci]
            if (self.snapshot_every and self.snapshotter is not None
                    and ci > start_ci and ci % self.snapshot_every == 0):
                # drain in-flight first so the accumulators cover chunks
                # < ci — the consistency point _ReplayState capture uses
                while in_flight:
                    self._retire(in_flight.popleft(), host_accs)
                self._save_snapshot(plan, ci, jit_accs, host_accs)
            if len(in_flight) >= self.depth:  # backpressure BEFORE dispatch:
                self.stats.stalls += 1       # ≤ `depth` chunks unretired
                with rec.span("stall", "stream", ci=ci):
                    self._retire(in_flight.popleft(), host_accs)
            try:
                chunk = self._chunk_inputs(ci, lo, hi, batch)
            except Exception as e:
                # the chunk never entered the DAG; whatever is in flight is
                # complete — retire it so the accumulators are consistent,
                # and for a resumable failure (a peer died mid-stream) keep
                # the fold state
                while in_flight:
                    self._retire(in_flight.popleft(), host_accs)
                if isinstance(e, self._resumable_errors):
                    self.replay_state = _ReplayState(
                        ci, list(plan), jit_accs, host_accs,
                        dict(self._combine_carry), self.stats)
                raise
            with rec.span("dispatch", "stream", ci=ci):
                streams, host_streams, lanes_used = self._dispatch_chunk(
                    ci, chunk, final=ci == len(plan) - 1)
                self._forward_egress(ci, host_streams)
                for name, x in streams.items():
                    rec.instant("collect", "csp", collect=name, ci=ci)
                    if name not in jit_accs:  # first chunk: fold with init
                        jit_accs[name] = self._stage_call(name)(x)
                    else:  # later chunks: carry fold — linear item order
                        jit_accs[name] = self._carry_call(name)(
                            jit_accs[name], x)
            # the chunk is done when the stream reaches this event
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            in_flight.append((ci, hi - lo, lanes_used, host_streams, done))
            rec.counter("in_flight", len(in_flight), "stream")
        while in_flight:
            self._retire(in_flight.popleft(), host_accs)

        out: dict[str, Any] = {}
        for p in self._local_collects():
            val = jit_accs[p.name] if p.jit_combine else host_accs[p.name]
            out[p.name] = p.finalise(val) if p.finalise else val
        return out


# ==========================================================================
# CSP abstract models of the two schedules (paper §6.1.1 turned on ourselves)
# ==========================================================================

def _functional_tags(net: Network, fused: bool = False) -> list:
    """The symbolic stage chain every item traverses, in topological order.

    With ``fused=True`` consecutive stages that the executor fuses
    (:func:`fused_chains`) collapse into one *tuple* tag — the CSP worker
    applies each component in order (:mod:`.csp` nests tuple tags), so a
    fused stage is, observably, exactly the composition of its members.
    """
    def _tag(n):
        return net.procs[n].tag or n

    if not fused:
        return [_tag(n) for n in net.toposort()
                if net.procs[n].kind in (Kind.WORKER, Kind.ENGINE)]
    head_of = {c[0]: c for c in fused_chains(net)}
    members = {n for c in head_of.values() for n in c[1:]}
    tags: list = []
    for n in net.toposort():
        if net.procs[n].kind not in (Kind.WORKER, Kind.ENGINE) or n in members:
            continue
        chain = head_of.get(n)
        tags.append(tuple(_tag(m) for m in chain) if chain else _tag(n))
    return tags


def synchronous_abstract_model(net: Network, name: str = "sync") -> Network:
    """CSP model of the fused / sequential schedule: one chain of stages —
    every chunk passes stage k before any chunk enters stage k+1 needn't
    hold, but there is a single lane, so chunks stay strictly ordered."""
    tags = _functional_tags(net)
    m = Network(f"{net.name}/{name}")
    m.add(Emit(lambda i: i, name="emit"))
    for k, tag in enumerate(tags):
        m.add(Worker(lambda x: x, name=f"s{k}", tag=tag))
    m.add(Collect(lambda a, x: a, name="collect"))
    return m


def streaming_abstract_model(net: Network, lanes: int = 2,
                             name: str = "stream",
                             fused: bool = False) -> Network:
    """CSP model of the streaming schedule: chunks are items, OneFanAny
    assigns each to any free lane (work stealing), each lane is the full
    stage chain, AnyFanOne merges lanes into the Collect.

    ``trace_equivalent(streaming_abstract_model(net), \
synchronous_abstract_model(net))`` is the refinement obligation the executor
    must meet: same guaranteed termination, same collected outcome on every
    interleaving.

    ``fused=True`` models the executor's chain-fused schedule: each fused
    run becomes ONE lane worker carrying the tuple of its members' tags, and
    the CSP worker applies the tags in order — so the fused schedule's
    outcomes are the same nested compositions as the synchronous model's,
    and ``trace_equivalent`` still holds (the fusion is observationally
    invisible, which is exactly the license to perform it)."""
    tags = _functional_tags(net, fused=fused)
    m = Network(f"{net.name}/{name}[{lanes}]{'/fused' if fused else ''}")
    m.add(Emit(lambda i: i, name="emit"),
          OneFanAny(destinations=lanes, name="ofa"))
    m.procs["afo"] = AnyFanOne(sources=lanes, name="afo")
    for lane in range(lanes):
        prev = "ofa"
        for k, tag in enumerate(tags):
            wn = f"l{lane}s{k}"
            m.procs[wn] = Worker(lambda x: x, name=wn, tag=tag)
            m.connect(prev, wn)
            prev = wn
        m.connect(prev, "afo")
    m._tail = "afo"
    m.add(Collect(lambda a, x: a, name="collect"))
    return m
