"""Cluster runtime: one streaming executor per host partition.

Every host runs the streaming microbatch executor over its own subnetwork
(:class:`PartitionExecutor` — a :class:`..core.stream.StreamExecutor` whose
boundary Emit shims pull chunks from a
:class:`~.transport.ChannelTransport` and whose boundary Collect shims push
chunks into it).  Backpressure composes: inside a host the executor bounds
in-flight chunks by channel capacity; across hosts the transport's bounded
FIFO blocks the producer — the tightest channel anywhere throttles the
whole cluster, exactly as in a buffered CSP chain.

Hosts are threads (``inprocess``/``device`` transports) or real spawned OS
processes (``pipe``/``shm``); the latter need a picklable ``factory`` so
each fresh interpreter can rebuild the network (closures do not pickle).
Each host runs on one device: thread hosts on the deployment's (``device``
spreads them over the cards), process hosts on the one their own
interpreter resolves — the card unless the deployment asks for the CPU.

Deployment lifetime lives in :mod:`.deploy`: a
:class:`~.deploy.ClusterDeployment` partitions, builds and spawns ONCE and
then streams many batches through the warm hosts; :func:`run_cluster` here
is the one-shot convenience (deploy, run one batch, tear down).  This module
keeps the pieces both paths share: the executor, per-host emit batching,
cut-capacity derivation and failure signalling.

Failures are captured, never lost: a host that throws reports a full
traceback in its :class:`HostReport`, pushes EOS down its cut channels so
consumer hosts fail fast instead of hanging, and the controller raises
:class:`ClusterError` whose message is the §8-style cluster report
(:func:`..core.netlog.cluster_report`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.utils._pytree as pytree

from ..core import trace as _trace
from ..core.builder import build, make_emit_batch
from ..core.dataflow import Network, NetworkError
from ..core.stream import (EmitChunks, StreamExecutor, _SKIP,
                           coalesced_capacity, plan_depth_lanes,
                           slice_microbatch)
from .partition import PartitionPlan, egress_shim, ingress_shim, is_shim
from .transport import (DEFAULT_CAPACITY, EOS, SKIP, ChannelTransport,
                        TransportError)

__all__ = [
    "ExecConfig",
    "HostReport",
    "ClusterError",
    "ClusterResult",
    "PartitionExecutor",
    "derive_cut_capacities",
    "make_host_executor",
    "run_cluster",
]

@dataclasses.dataclass
class ExecConfig:
    """Per-host streaming-executor knobs (picklable: crosses into spawned
    host processes)."""

    microbatch_size: int = 8
    max_in_flight: Optional[int] = None
    lanes: Optional[int] = None
    fuse: bool = True  # intra-partition chain fusion (core/stream.py)
    # observability: give each host its own TraceRecorder (core/trace.py) —
    # spans/instants ship back with every batch result and merge on the
    # controller; False = recorders stay disabled (near-zero cost)
    trace: bool = False
    # durability (cluster/durable.py): when snapshot_dir is set, each host
    # persists its fold accumulators every snapshot_every chunks through a
    # crash-atomic Checkpointer under <snapshot_dir>/host_<h>, and the
    # controller writes its meta (plan, epoch, ledger) under /meta — so
    # recover() replays from the last snapshot and a fresh controller can
    # adopt() the deployment.  0 / None = durability off.
    snapshot_every: int = 0
    snapshot_dir: Optional[str] = None
    # transport fast path: coalesce records up to this many bytes into one
    # queue put per cut channel (0 = one record per put); copied onto every
    # host endpoint by make_host_executor
    coalesce_bytes: int = 0
    # a measured profile (``out_bytes_of(name)``) lets derive_cut_capacities
    # size coalesced channels by record bytes; only the controller reads it
    profile: Optional[object] = None
    # where the hosts run: None = the card, or e.g. "cpu".  Process hosts
    # resolve it in their own interpreter.
    device: Optional[str] = None


@dataclasses.dataclass
class HostReport:
    """What one host did (or failed to do) during a cluster run."""

    host: int
    procs: list
    ok: bool = False
    stats_summary: str = ""
    donation_summary: str = ""
    error: Optional[str] = None  # full traceback when not ok
    # chosen cut-channel FIFO depths touching this host ("src->dst" -> cap):
    # explicit ChannelDef.capacity, or the derived default (the consumer
    # executor's depth/lane appetite)
    capacities: dict = dataclasses.field(default_factory=dict)
    # stage callables built during THIS batch: 0 means genuinely warm
    jit_builds: int = 0
    # a stalled host is a SURVIVOR of a peer failure: it kept its fold
    # state at `resume_ci` (contrast `error`, a failure of this host)
    stalled: bool = False
    resume_ci: Optional[int] = None
    epoch: int = 1  # plan epoch this report was produced under
    # telemetry sample for MetricsSnapshot (core/trace.py): items/s,
    # stalls/chunk, per-cut-channel sent/recv byte counters, wall seconds
    metrics: dict = dataclasses.field(default_factory=dict)


class ClusterResult(dict):
    """Collect results plus per-host telemetry (``.reports``) and the plan
    epoch that produced them (``.epoch``)."""

    reports: list
    epoch: int


class ClusterError(NetworkError):
    """A host partition failed; ``reports`` holds every host's outcome."""

    def __init__(self, message: str, reports: list):
        super().__init__(message)
        self.reports = reports


class PartitionExecutor(StreamExecutor):
    """StreamExecutor over one host's subnetwork: ingress Emit shims recv
    from the transport, egress Collect shims send into it.

    A peer dying mid-stream surfaces here as a :class:`TransportError` from
    an ingress recv — *before* the chunk being assembled had any effect — so
    the base executor keeps the fold state (the host reports itself stalled,
    not failed); ingress values already received for that chunk are kept in
    ``_ingress_buf``."""

    _resumable_errors = (TransportError,)

    def __init__(self, compiled, *, plan: PartitionPlan, host: int,
                 endpoint: ChannelTransport, microbatch_size: int,
                 max_in_flight: Optional[int] = None,
                 lanes: Optional[int] = None, fuse: bool = True,
                 recorder=None):
        super().__init__(compiled, microbatch_size=microbatch_size,
                         max_in_flight=max_in_flight, lanes=lanes, fuse=fuse,
                         recorder=recorder)
        self.host = host
        self.ep = endpoint
        self._ingress_buf: dict = {}  # ci -> {shim: received value}
        # always-on per-cut-channel byte counters ("src->dst" -> bytes this
        # batch): the bytes/s feed of MetricsSnapshot / cluster_report
        self.sent_bytes: dict = {}
        self.recv_bytes: dict = {}
        # the endpoint's ring-path counts as of this batch's start
        self._ring_base: dict = {}
        # StreamStats progress counters as of this serve call's start:
        # metrics_sample reports the DELTA
        self._sample_base = (0, 0, 0)  # (chunks_done, items_done, stalls)
        self.ingress = [(ingress_shim(c.src, c.dst), (c.src, c.dst))
                        for c in plan.ingress_of(host)]
        self.egress = [(egress_shim(c.src, c.dst), (c.src, c.dst))
                       for c in plan.egress_of(host)]

    # -- hook overrides ------------------------------------------------------
    def _chunk_inputs(self, ci: int, lo: int, hi: int, batch):
        chunk = EmitChunks()
        for e in self.net.emits():
            if not is_shim(e.name):
                chunk[e.name] = slice_microbatch(batch, lo, hi)
        buf = self._ingress_buf.get(ci, {})
        for shim, chan in self.ingress:
            if shim in buf:  # received before a mid-chunk interruption
                chunk[shim] = buf[shim]
                continue
            key = f"{chan[0]}->{chan[1]}"
            with self.rec.span("recv", "transport", chan=key, ci=ci) as sp:
                v = self.ep.recv(chan, ci)
                nbytes = _payload_bytes(v)
                sp.set(nbytes=nbytes)
            self.recv_bytes[key] = self.recv_bytes.get(key, 0) + nbytes
            if self.rec.enabled:
                self.rec.counter(f"recv_bytes:{key}",
                                 self.recv_bytes[key], "transport")
            if isinstance(v, str):
                if v == SKIP:
                    v = _SKIP
                elif v == EOS:
                    raise TransportError(
                        f"channel {chan}: producer host terminated before "
                        f"chunk {ci}")
            # buffer as we go: if a LATER ingress recv of this chunk fails,
            # this channel must not be read again for it (the producer
            # will not resend what the FIFO already delivered)
            self._ingress_buf.setdefault(ci, {})[shim] = v
            chunk[shim] = v
        self._ingress_buf.pop(ci, None)  # chunk fully assembled
        return chunk

    def _forward_egress(self, ci: int, host_streams: dict) -> None:
        for shim, chan in self.egress:
            v = host_streams.pop(shim, _SKIP)
            payload = SKIP if v is _SKIP else v
            key = f"{chan[0]}->{chan[1]}"
            nbytes = _payload_bytes(payload)
            with self.rec.span("send", "transport", chan=key, ci=ci,
                               nbytes=nbytes):
                self.ep.send(chan, ci, payload)
            self.sent_bytes[key] = self.sent_bytes.get(key, 0) + nbytes
            if self.rec.enabled:
                self.rec.counter(f"sent_bytes:{key}",
                                 self.sent_bytes[key], "transport")

    def _local_collects(self) -> list:
        return [p for p in self.net.collects() if not is_shim(p.name)]

    def reset_run_state(self) -> None:
        """Base reset (resume state, COMBINE carries) plus the partition's
        buffered partial ingress."""
        super().reset_run_state()
        self._ingress_buf = {}

    def run_partition(self, bounds: list, batch=None, *,
                      start_ci: int = 0) -> dict:
        """Stream chunks ``bounds[start_ci:]`` through this partition
        (``start_ci`` > 0: a replay of only the lost tail of a batch)."""
        # fresh batch: byte counters, ring-path counts and the sample
        # baseline restart (a resume keeps accumulating — the replayed tail
        # belongs to the same batch)
        self.sent_bytes = {}
        self.recv_bytes = {}
        self._ring_base = self.ep.ring_counts()
        self._sample_base = (0, 0, 0)
        # a fresh batch (or a replay from a chunk, which only reaches hosts
        # whose run state was reset) must not inherit another stream's
        # read-ahead; a stall-RESUME goes through resume_partition and keeps
        # it — the buffer holds exactly the records off the FIFO but unfolded
        self.ep.clear_read_buffers()
        return self._run_plan(list(bounds), batch, start_ci=start_ci)

    def resume_from_state(self, state: dict, batch=None):
        """Durable-snapshot resume (see the base class) on a host whose run
        state was reset: byte counters, ring-path counts and read-ahead
        start afresh as for a replay from a chunk, and the sample baseline
        is the snapshot's progress, so the serve call that replays the tail
        does not bill the pre-snapshot chunks again."""
        self.sent_bytes = {}
        self.recv_bytes = {}
        self._ring_base = self.ep.ring_counts()
        self.ep.clear_read_buffers()
        st = state["stats"]
        self._sample_base = (st.chunks_done, st.items_done, st.stalls)
        return super().resume_from_state(state, batch)

    def resume_partition(self, batch=None) -> dict:
        """Resume an interrupted batch from the saved replay state."""
        # resume keeps the interrupted run's StreamStats: rebase the sample
        # so this serve call reports only the tail it actually streams
        if self.replay_state is not None:
            st = self.replay_state.stats
            self._sample_base = (st.chunks_done, st.items_done, st.stalls)
        return self.resume_plan(batch)

    def _drive(self, plan, batch, start_ci, jit_accs, host_accs):
        """Bracket the base drive loop with coalesce flushes: on success the
        egress buffers must be empty before the host reports done (the
        consumer cannot fold what still sits in a producer-local buffer); on
        failure they must reach the FIFO before the failure is reported.  A
        flush that cannot complete turns a stall into a failure of this
        host."""
        if self.ep.coalesce_bytes <= 0:
            return super()._drive(plan, batch, start_ci, jit_accs, host_accs)
        try:
            out = super()._drive(plan, batch, start_ci, jit_accs, host_accs)
        except BaseException:
            try:
                self.ep.flush_sends()
            except BaseException:
                self.replay_state = None  # stalled -> err
                raise
            raise
        self.ep.flush_sends()
        return out

    def metrics_sample(self, wall_s: float) -> dict:
        """The per-batch telemetry sample shipped in
        :attr:`HostReport.metrics` — one host's row of the controller's
        :class:`..core.trace.MetricsSnapshot`.  Rates come from the RETIRED
        progress since this serve call began, never from the plan totals
        (a stalled host must not report throughput for work it never
        finished)."""
        st = self.stats
        b_chunks, b_items, b_stalls = self._sample_base
        n_chunks = st.chunks_done - b_chunks
        n_items = st.items_done - b_items
        stalls = st.stalls - b_stalls
        wall = max(wall_s, 1e-9)
        sample = {
            "wall_s": wall_s,
            "items_per_s": n_items / wall,
            "stalls_per_chunk": stalls / n_chunks if n_chunks else 0.0,
            "sent_bytes": dict(self.sent_bytes),
            "recv_bytes": dict(self.recv_bytes),
        }
        # the shared-memory ring: this batch's chunks by path, per channel
        ring = {}
        for chan, (slots, inline) in self.ep.ring_counts().items():
            b_slots, b_inline = self._ring_base.get(chan, (0, 0))
            ring[f"{chan[0]}->{chan[1]}"] = (slots - b_slots,
                                             inline - b_inline)
        if ring:
            sample["ring"] = ring
        return sample


# ==========================================================================
# Per-host execution (shared by thread and process hosts)
# ==========================================================================

def _payload_bytes(value) -> int:
    """Transport payload size: tensor and array leaves' bytes summed
    (markers count 0)."""
    if isinstance(value, str):
        return 0
    return sum(int(getattr(leaf, "nbytes", 0))
               for leaf in pytree.tree_leaves(value))


def _emit_batch(net: Network, instances: int, device):
    """Batch the host's *real* Emit (ignores boundary shims) on ``device``
    — the builder's batching, so cluster item order matches the fused
    path."""
    emits = [e for e in net.emits() if not is_shim(e.name)]
    if not emits:
        return None
    if len(emits) != 1:
        raise NetworkError(f"{net.name}: expected one real Emit, "
                           f"got {[e.name for e in emits]}")
    return make_emit_batch(net, instances, device=device, emit=emits[0])


def make_host_executor(plan: PartitionPlan, host: int,
                       endpoint: ChannelTransport, cfg: ExecConfig,
                       device=None) -> PartitionExecutor:
    """Build one host's partition executor on ``device`` (``None``:
    ``cfg.device``).  A :class:`~.deploy.ClusterDeployment` keeps the
    returned executor alive across batches, so its stage callables are
    built exactly once."""
    sub = plan.subnetwork(host)
    cn = build(sub, device=cfg.device if device is None else device)
    if cfg.coalesce_bytes:
        endpoint.coalesce_bytes = cfg.coalesce_bytes
    # cfg.trace: each host OWNS a recorder (correct attribution even when
    # hosts are threads sharing this process); spans ship back per batch
    rec = _trace.new_recorder(host=host) if cfg.trace else None
    ex = PartitionExecutor(cn, plan=plan, host=host, endpoint=endpoint,
                           microbatch_size=cfg.microbatch_size,
                           max_in_flight=cfg.max_in_flight,
                           lanes=cfg.lanes, fuse=cfg.fuse, recorder=rec)
    if cfg.snapshot_every and cfg.snapshot_dir:
        from .durable import DeploymentStore
        store = DeploymentStore(cfg.snapshot_dir)
        ex.snapshotter = store.host_checkpointer(host)
        ex.snapshot_every = cfg.snapshot_every
        # a fault injector can kill mid-snapshot-write through the endpoint
        hook = getattr(endpoint, "snapshot_step", None)
        if hook is not None:
            ex.on_snapshot = hook
    return ex


def derive_cut_capacities(plan: PartitionPlan, cfg: ExecConfig,
                          profile=None) -> dict:
    """FIFO depth of each cut channel: explicit ``ChannelDef.capacity``, or a
    default derived from the consumer executor's actual appetite,
    ``max(DEFAULT_CAPACITY, depth, lanes)``, so the cut channel is never the
    accidental bottleneck while staying a bounded CSP buffer.  The chosen
    values are recorded per host in :attr:`HostReport.capacities`.

    With coalescing on AND a measured ``profile`` (how many bytes one record
    of this channel carries — ``profile.out_bytes_of`` of the cut source),
    each queue slot holds a whole batch of records, so the same in-flight
    appetite needs proportionally fewer slots
    (:func:`..core.stream.coalesced_capacity`).
    """
    profile = profile if profile is not None else cfg.profile
    coalesce = cfg.coalesce_bytes
    sizing: dict = {}
    caps: dict = {}
    for c in plan.cut:
        chan = (c.src, c.dst)
        if c.capacity > 0:
            caps[chan] = c.capacity
            continue
        h = plan.assignment[c.dst]
        if h not in sizing:
            sizing[h] = plan_depth_lanes(plan.subnetwork(h),
                                         cfg.max_in_flight, cfg.lanes)
        depth, lanes = sizing[h]
        if coalesce > 0 and profile is not None:
            caps[chan] = coalesced_capacity(
                depth, lanes, profile.out_bytes_of(c.src), coalesce,
                floor=DEFAULT_CAPACITY)
        else:
            caps[chan] = max(DEFAULT_CAPACITY, depth, lanes)
    return caps


def _signal_failure(plan: PartitionPlan, host: int,
                    endpoint: ChannelTransport) -> None:
    """Fail fast cluster-wide: EOS to consumers, drain producers."""
    for c in plan.egress_of(host):
        try:
            endpoint.send((c.src, c.dst), -1, EOS)
        except Exception:
            pass
    for c in plan.ingress_of(host):  # unblock upstream senders
        for _ in range(64):
            try:
                got = endpoint.recv((c.src, c.dst), -1)
            except Exception:
                break
            if isinstance(got, str) and got == EOS:
                break


# ==========================================================================
# The one-shot run (a deployment used exactly once)
# ==========================================================================

def run_cluster(net: Optional[Network] = None, *, instances: int,
                hosts: Optional[int] = None,
                plan: Optional[PartitionPlan] = None,
                transport="inprocess",
                microbatch_size: int = 8,
                max_in_flight: Optional[int] = None,
                lanes: Optional[int] = None,
                factory: Optional[tuple] = None,
                timeout_s: float = 300.0,
                device=None) -> ClusterResult:
    """Partition ``net`` over hosts and stream ``instances`` items through.

    ``transport`` is a name (``"inprocess"`` / ``"pipe"`` / ``"device"``)
    or a ready :class:`ChannelTransport`.  The process transport (``pipe``)
    spawns one OS process per host and therefore needs ``factory=(callable,
    args)`` — a picklable recipe each child uses to rebuild the network.
    ``device`` is where the hosts run (``None``: the card).

    This is the cold path: it stands up a fresh
    :class:`~.deploy.ClusterDeployment`, runs ONE batch, and tears it all
    down.  Amortise the set-up over many batches by holding the deployment
    open yourself::

        with ClusterDeployment(net, hosts=2) as dep:
            for batch in batches:
                out = dep.run(instances=n)

    Returns a :class:`ClusterResult`: the merged Collect dict (identical to
    ``run_sequential``), with per-host :class:`HostReport` telemetry in
    ``.reports``.  Raises :class:`ClusterError` (message = the cross-host
    netlog report) when any host fails.
    """
    from .deploy import ClusterDeployment
    with ClusterDeployment(net, hosts=hosts, plan=plan, transport=transport,
                           microbatch_size=microbatch_size,
                           max_in_flight=max_in_flight, lanes=lanes,
                           factory=factory, timeout_s=timeout_s,
                           device=device) as dep:
        return dep.run(instances=instances)
