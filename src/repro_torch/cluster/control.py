"""The cluster control plane: one parked worker per host, batches in turn.

A :class:`ClusterController` owns a deployment's live state — the
epoch-stamped plan, the transport, and one parked worker per host (a
daemon thread holding a warm executor, or a spawned OS process that builds
its own) — and streams batches through it:

* every transported record carries the plan epoch (:mod:`.transport`);
* a host whose *peer* fails stalls instead of failing: the streaming
  executor keeps its fold state, and the host reports itself stalled;
* a host whose *own* code throws reports the full traceback (the paper's
  §8 error capture), resets its run state, and parks again — warm;
* a host process that dies without reporting is found by polling, and the
  controller speaks for the corpse (EOS down its egress, its ingress
  drained) so the survivors quiesce instead of hanging.

A batch that fails raises :class:`~.runtime.ClusterError` carrying the
cluster report, and the controller remembers what :meth:`recover` needs:
who died, who erred, who stalled at which chunk, and the batch.
:meth:`ClusterController.recover` drains the surviving channels
(requeueing undelivered chunks under the new epoch), restarts the dead
hosts' workers — or, with ``mode="rebalance"``, reuses the planner to move
the failed hosts' processes onto survivors — re-proves the refinement of
the new epoch's plan (:func:`.partition.check_redeployment`), and replays
only the lost chunks of the failed batch.  :meth:`reconfigure` refits the
same network to another host count between batches, the same way.  Every
recovery is a :class:`RecoveryEvent`, rendered by
:func:`..core.netlog.cluster_report`.

With a :class:`~.durable.DeploymentStore` the deployment is durable: the
controller writes its meta (plan, epoch, ledger, the pending batch) at
batch boundaries and around every recovery — and a write-ahead record of
each batch before it is dispatched — while each host snapshots its fold
state every ``snapshot_every`` chunks.  A stateful partition then replays
from its last snapshot instead of chunk 0, and a brand-new controller can
take the deployment over (:meth:`ClusterController.adopt_state`) after the
old one died, mid-batch included.  Every durable action is a
:class:`~.durable.DurabilityEvent`.
"""

from __future__ import annotations

import dataclasses
import os
import queue as _queue
import threading
import time
import traceback
from multiprocessing.connection import wait as _mp_wait
from typing import Any, Optional

import torch
import torch.utils._pytree as pytree

from ..core import trace as _trace
from ..core.dataflow import Distribution, Kind, Network, NetworkError
from ..core.stream import microbatch_plan
from ..device import resolve_device, to_device
from .partition import (PartitionPlan, check_redeployment, is_shim,
                        partition, repartition_without)
from .durable import DeploymentStore, DurabilityEvent, reclaim, to_host
from .runtime import (ClusterError, ClusterResult, ExecConfig, HostReport,
                      _emit_batch, _signal_failure, derive_cut_capacities,
                      make_host_executor)
from .transport import (ChannelTransport, DeviceTransport, pack_raw,
                        queue_semaphores, unpack_raw)

__all__ = ["ClusterController", "RecoveryEvent"]

_SHUTDOWN = "__gpp_shutdown__"


@dataclasses.dataclass
class RecoveryEvent:
    """One recovery of a live deployment (epoch N -> N+1), for the report."""

    epoch_from: int
    epoch_to: int
    mode: str                 # "restart" | "rebalance"
    dead: list                # hosts whose worker process died
    erred: list               # hosts whose own code threw (host alive)
    stalled: dict             # surviving host -> first chunk it still needs
    restarted: list           # hosts whose worker was respawned
    moved: dict               # process -> (old host, new host), rebalance
    requeued: dict            # "src->dst" -> undelivered chunks requeued
    discarded: int            # drained records thrown away
    replay_from: dict         # host -> first chunk replayed
    refined: Optional[bool] = None  # new epoch's plan [T=] original network
    wall_s: float = 0.0
    # dead-reader FIFOs found on the dead hosts' ingress (a host killed
    # mid-recv bricks the queue): rebuilt in place, or routed around by the
    # auto-fallback to mode="rebalance" (auto_mode records which, and why)
    bricked: list = dataclasses.field(default_factory=list)
    auto_mode: Optional[str] = None

    def describe(self) -> str:
        """One deterministic line (hosts, channels and dicts sorted)."""
        bits = [f"epoch {self.epoch_from} -> {self.epoch_to} "
                f"({self.mode})"]
        if self.dead:
            bits.append(f"dead hosts {sorted(self.dead)}")
        if self.erred:
            bits.append(f"erred hosts {sorted(self.erred)}")
        if self.stalled:
            bits.append("stalled " + ", ".join(
                f"host {h} at chunk {ci}"
                for h, ci in sorted(self.stalled.items())))
        if self.bricked:
            bits.append("bricked ingress FIFO "
                        + ", ".join(sorted(self.bricked)))
        if self.auto_mode:
            bits.append(self.auto_mode)
        if self.restarted:
            bits.append(f"restarted {sorted(self.restarted)}")
        if self.moved:
            bits.append("moved " + ", ".join(
                f"{p}:{a}->{b}" for p, (a, b) in sorted(self.moved.items())))
        req = sum(len(v) for v in self.requeued.values())
        detail = ", ".join(f"{chan}:{cis}"
                           for chan, cis in sorted(self.requeued.items()))
        bits.append(f"requeued {req}{f' [{detail}]' if detail else ''}"
                    f" / discarded {self.discarded} in-flight chunks")
        if self.replay_from:
            bits.append("replayed " + ", ".join(
                f"host {h} from chunk {ci}"
                for h, ci in sorted(self.replay_from.items())))
        if self.refined is not None:
            bits.append(f"refinement(epoch {self.epoch_to})="
                        f"{self.refined}")
        bits.append(f"wall {self.wall_s:.2f}s")
        return "; ".join(bits)


def _batch_items(batch) -> int:
    leaves = [l for l in pytree.tree_leaves(batch)
              if isinstance(l, torch.Tensor)]
    if not leaves:
        raise NetworkError("run: empty batch")
    return leaves[0].shape[0]


def _has_real_emit(sub: Network) -> bool:
    return any(not is_shim(e.name) for e in sub.emits())


def _host_shape(plan, h) -> tuple:
    """What a host's worker is wired to: its processes and cut channels.
    A replan only restarts hosts whose shape changed."""
    return (tuple(plan.procs_of(h)),
            tuple((c.src, c.dst) for c in plan.ingress_of(h)),
            tuple((c.src, c.dst) for c in plan.egress_of(h)))


def _host_stats(ex, before: int, t0: float) -> tuple:
    """The per-batch telemetry tuple shipped with every host result:
    summaries, new stage builds, the :class:`MetricsSnapshot` sample, and
    the drained trace ring (raw event tuples — picklable across process
    transports; ``None`` when the host's recorder is disabled)."""
    payload = ex.rec.drain() if ex.rec.enabled else None
    return (ex.stats.summary(), ex.stats.donation_summary(),
            ex.jit_builds - before,
            ex.metrics_sample(time.monotonic() - t0), payload)


def _serve_host(sub, ex, plan, host, endpoint, work_q, result_q,
                encode=False) -> None:
    """The warm-host loop: park on the work queue, stream each batch through
    the ONE persistent executor, report per batch.  Shared verbatim by
    thread hosts and spawned process hosts.

    A host never retires itself: a peer failure leaves it *stalled* (fold
    state intact, batch resumable), its own failure is reported with a full
    traceback and its run state reset — either way it parks again, warm,
    and the controller decides what happens next.  A ``"replay"`` message
    resumes a stalled fold at its first lost chunk, or re-streams the batch
    from ``start_ci``; a ``"replay_snap"`` message restores the on-disk fold
    snapshot it carries and streams only the chunks after it.
    """
    while True:
        msg = work_q.get()
        if isinstance(msg, str) and msg == _SHUTDOWN:
            break
        # "replay_snap" messages append the fold snapshot to resume from;
        # every other kind is the bare 7-tuple
        kind, batch_id, epoch, bounds, instances, batch, start_ci, *extra = msg
        endpoint.epoch = epoch
        ex.snapshot_tag = (batch_id, epoch)  # stamps fold snapshots
        before = ex.jit_builds
        t0 = time.monotonic()
        try:
            if batch is None or not _has_real_emit(sub):
                batch = _emit_batch(sub, instances, ex.cn.device)
            elif encode:  # crossed the work queue as raw bytes
                batch = unpack_raw(batch, ex.cn.device)
            else:
                batch = to_device(batch, ex.cn.device)
            if kind == "replay" and ex.replay_state is not None:
                out = ex.resume_partition(batch)  # only the lost chunks
            elif kind == "replay_snap":
                # accumulators restored as of start_ci onto this host's
                # device; only the tail re-streams
                ex.reset_run_state()
                snap = unpack_raw(extra[0]) if encode else extra[0]
                out = ex.resume_from_state(snap, batch)
            else:
                ex.reset_run_state()
                out = ex.run_partition(list(bounds), batch,
                                       start_ci=start_ci)
            # a process host's results cross as bytes, tensors copied to
            # the CPU with their dtype; the controller rebuilds CPU tensors
            result_q.put(("ok", host, batch_id, epoch,
                          pack_raw(out) if encode else out,
                          _host_stats(ex, before, t0)))
        except Exception:
            stats = _host_stats(ex, before, t0)
            if ex.replay_state is not None:
                # a PEER failed mid-stream: this host is a healthy survivor
                # holding its fold state — report where it stopped
                result_q.put(("stalled", host, batch_id, epoch,
                              (ex.replay_state.next_ci,
                               traceback.format_exc()), stats))
            else:
                # this host's own failure: capture it, reset, stay warm
                ex.reset_run_state()
                _signal_failure(plan, host, endpoint)
                result_q.put(("err", host, batch_id, epoch,
                              traceback.format_exc(), stats))


def _process_host_entry(factory, fargs, assignment: dict, host: int,
                        endpoint, work_q, result_q, cfg: ExecConfig) -> None:
    """Spawned-process host main: rebuild the network from the picklable
    factory, build the executor ONCE on this interpreter's device (the card
    unless ``cfg.device`` says otherwise), then serve batches until
    shutdown."""
    try:
        net = factory(*fargs)
        plan = partition(net, assignment=assignment)
        ex = make_host_executor(plan, host, endpoint, cfg)
        if ex.cn.device.type == "cuda":
            torch.cuda.set_device(ex.cn.device)
        endpoint.device = ex.cn.device  # received tensors land here
        sub = ex.net
    except Exception:
        result_q.put(("err", host, None, -1, traceback.format_exc(), None))
        return
    _serve_host(sub, ex, plan, host, endpoint, work_q, result_q,
                encode=True)


class ClusterController:
    """Owns a deployment's live state: the epoch-stamped plan, the
    transport, and one parked worker per host — with the lifecycle verbs
    (:meth:`spawn_host`, :meth:`stop_host`, :meth:`restart_host`,
    :meth:`kill_host`), :meth:`run_batch` and the recovery path
    (:meth:`recover`, :meth:`reconfigure`).
    :class:`~.deploy.ClusterDeployment` is the user-facing facade over this
    class."""

    def __init__(self, net: Network, plan: PartitionPlan, cfg: ExecConfig,
                 transport: ChannelTransport, factory: Optional[tuple],
                 timeout_s: float,
                 store: Optional[DeploymentStore] = None):
        self.net = net
        self.plan = plan
        self.cfg = cfg
        self.transport = transport
        self.factory = factory
        self.timeout_s = timeout_s
        # durability (cluster/durable.py): controller meta persists through
        # the store at batch boundaries and around every recovery, so a
        # fresh controller can adopt_state() this deployment after a crash
        self.store = store
        self._meta_seq = 0
        self.durable_events: list[DurabilityEvent] = []
        self.poll_s = 1.0  # result-queue poll (dead-host detection cadence)
        self.epoch = 1
        self.events: list[RecoveryEvent] = []
        self.capacities = derive_cut_capacities(plan, cfg)
        self._live = plan.hosts()
        self._started = False
        self._transport_up = False
        self._closed = False
        self._batch_seq = 0
        self._threads: dict = {}
        self._procs: dict = {}
        self._work_qs: dict = {}
        # thread hosts share one result queue; process hosts get one EACH —
        # a host killed mid-report dies holding its queue's writer lock,
        # and a shared queue would wedge every survivor's delivery
        self._result_q: Any = None    # thread hosts only
        self._result_qs: dict = {}    # process hosts: host -> own queue
        self._devices: dict = {}      # thread hosts: host -> device
        self.executors: dict = {}     # thread hosts only: live executors
        # failure state of the last batch (drives recovery)
        self._needs_recovery = False
        self._dead: set = set()
        self._erred: set = set()
        self._stalled: dict = {}      # host -> resume chunk
        self._last_batch: Optional[tuple] = None   # descriptor, for replay
        self._ok_cache: dict = {}     # completed hosts' results, failed batch
        self._kept: dict = {}         # chan -> drained records to requeue
        # observability (core/trace.py): the controller's own recorder spans
        # the control verbs; worker rings arrive with each result and merge
        # by per-host clock offset (fixed at FIRST receipt; 0 for thread
        # hosts, which share this process's clock)
        self.recorder = _trace.new_recorder(host="ctrl", enabled=cfg.trace)
        self._trace_events: dict = {}   # host -> accumulated raw events
        self._trace_offsets: dict = {}  # host -> clock offset onto ours
        self._last_reports: dict = {}   # host -> HostReport of last batch
        # cumulative per-channel transfer totals: chan_key -> [bytes, wall_s]
        self._cum_chan: dict = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Stand the deployment up (idempotent): transport FIFOs and one
        parked worker per host."""
        if self._started:
            return
        if self._closed:
            raise NetworkError("ClusterController: already closed")
        t = self.transport
        if t.process_hosts and self.factory is None:
            # validate BEFORE the transport allocates anything (queue
            # feeder threads) — a refused start must leak nothing
            raise NetworkError(
                f"ClusterDeployment: the {t.name!r} transport spawns "
                "fresh interpreters and needs factory="
                "(picklable_callable, args) to rebuild the network in "
                "each host process")
        if t.process_hosts:
            self._build_kernels()
        t.set_epoch(self.epoch)
        cut_chans = [(c.src, c.dst) for c in self.plan.cut]
        t.setup(cut_chans, self.capacities)
        self._transport_up = True
        try:
            self._bind_devices()
            if not t.process_hosts:
                self._result_q = _queue.Queue()
            for h in self._live:
                self.spawn_host(h)
        except Exception:
            self.close()
            raise
        self._started = True
        self._persist_meta("started")

    def _build_kernels(self) -> None:
        """Before spawning hosts that will run on the card: build every
        kernel library here, once, so no host process runs its own
        ``nvcc``."""
        if self.cfg.device is not None and \
                torch.device(self.cfg.device).type != "cuda":
            return
        if not torch.cuda.is_available():
            return  # each host's own device check raises, with its reason
        from ..kernels import _build, launch_counts
        _build.build_all(sorted(launch_counts()))

    def _bind_devices(self) -> None:
        """Each thread host's device: the deployment's, or for the
        ``device`` transport host *h* on ``cuda:(h % device_count)`` (every
        host on one card shares it; with virtual devices, on virtual device
        ``h % N``), with each cut channel bound to its
        consumer's device.  The device follows the host's id, so a replan
        never moves a surviving host's warm executor to another card.
        Process hosts resolve their own."""
        t = self.transport
        if t.process_hosts:
            return
        base = resolve_device(self.cfg.device)
        if isinstance(t, DeviceTransport):
            split = t.device_split(max(self._live) + 1, base,
                                   t.virtual_devices)
            self._devices = {h: split[h] for h in self._live}
            t.bind({(c.src, c.dst): self._devices[self.plan.assignment[c.dst]]
                    for c in self.plan.cut})
        else:
            self._devices = {h: base for h in self._live}

    def spawn_host(self, h: int) -> None:
        """Park one warm worker for host ``h``: a daemon thread holding a
        live executor, or a spawned OS process that builds its own."""
        if h not in self._work_qs:
            self._work_qs[h] = (self.transport.ctx.Queue()
                                if self.transport.process_hosts
                                else _queue.Queue())
        if self.transport.process_hosts:
            if h not in self._result_qs:
                self._result_qs[h] = self.transport.ctx.Queue()
            p = self.transport.ctx.Process(
                target=_process_host_entry,
                args=(self.factory[0], tuple(self.factory[1]),
                      self.plan.assignment, h, self.transport.endpoint(h),
                      self._work_qs[h], self._result_qs[h], self.cfg),
                name=f"gpp-host-{h}", daemon=True)
            p.start()
            self._procs[h] = p
            return

        def _one():
            endpoint = self.transport.endpoint(h)
            dev = self._devices[h]
            try:
                if dev.type == "cuda":
                    # the kernels launch on the current device's stream
                    torch.cuda.set_device(dev)
                ex = make_host_executor(self.plan, h, endpoint, self.cfg,
                                        device=dev)
                self.executors[h] = ex
            except Exception:
                self._result_q.put(("err", h, None, -1,
                                    traceback.format_exc(), None))
                return
            _serve_host(ex.net, ex, self.plan, h, endpoint,
                        self._work_qs[h], self._result_q)

        th = threading.Thread(target=_one, daemon=True,
                              name=f"gpp-host-{h}")
        self._threads[h] = th
        th.start()

    def stop_host(self, h: int) -> None:
        """Retire host ``h``'s worker: graceful shutdown (drain the park
        queue, ask it to stop, join; a process that does not stop is
        terminated).  Fault injection is :meth:`kill_host`."""
        p = self._procs.pop(h, None)
        if p is not None:
            self._drain_work_q(h)
            try:
                self._work_qs[h].put(_SHUTDOWN, timeout=1.0)
            except Exception:
                pass
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            return
        th = self._threads.pop(h, None)
        if th is not None:
            self._drain_work_q(h)
            try:
                self._work_qs[h].put(_SHUTDOWN, timeout=1.0)
            except Exception:
                pass
            th.join(timeout=5.0)
            self.executors.pop(h, None)

    def restart_host(self, h: int) -> None:
        """Respawn host ``h``'s worker against the (possibly still warm)
        transport: the plan is unchanged, only the worker is fresh."""
        p = self._procs.pop(h, None)
        if p is not None:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10.0)
        th = self._threads.pop(h, None)
        if th is not None and th.is_alive():
            try:
                self._work_qs[h].put(_SHUTDOWN, timeout=1.0)
            except Exception:
                pass
            th.join(timeout=5.0)
        self.executors.pop(h, None)
        if self.transport.process_hosts:
            # a killed worker parked on its queue died HOLDING the queue's
            # reader lock — that queue is unreadable forever, so the
            # respawned worker gets a fresh one (only the controller writes
            # it; pending messages were stale anyway).  Same for its result
            # queue: a worker killed mid-report dies holding the writer
            # lock.
            self._work_qs.pop(h, None)
            self._result_qs.pop(h, None)
        else:
            self._drain_work_q(h)
        self.spawn_host(h)

    def kill_host(self, h: int) -> None:
        """Fault injection: SIGKILL host ``h``'s worker process mid-flight
        (no cleanup, no goodbye — the honest failure mode)."""
        p = self._procs.get(h)
        if p is None:
            raise NetworkError(
                "kill_host: only process transports (pipe/shm) have a "
                "worker process to kill; thread hosts share this "
                "interpreter")
        p.kill()

    def _drain_work_q(self, h: int) -> None:
        q = self._work_qs.get(h)
        while q is not None:
            try:
                q.get_nowait()
            except Exception:
                break

    def close(self) -> None:
        """Shut the workers down and release the transport (idempotent;
        safe to call after a failed start — whatever came up goes down)."""
        if self._closed:
            return
        self._closed = True
        for q in self._work_qs.values():
            try:
                q.put(_SHUTDOWN, timeout=1.0)
            except Exception:
                pass
        for th in self._threads.values():
            th.join(timeout=5.0)
        for p in self._procs.values():
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        if self._transport_up:
            self.transport.close()

    # -- batch execution ---------------------------------------------------
    def run_batch(self, instances: Optional[int] = None, *,
                  batch=None) -> ClusterResult:
        """Stream one batch through the warm deployment; on a host failure
        raise :class:`ClusterError` carrying the cluster report, and
        remember everything :meth:`recover` needs (who died, who stalled
        where, the batch descriptor).  After a failure the next batch first
        recovers the deployment without replaying the failed one."""
        if self._closed:
            raise NetworkError("ClusterDeployment: already closed")
        self.start()
        if self._needs_recovery:
            self.recover(replay=False)
        if batch is not None:
            instances = _batch_items(batch)
        if instances is None:
            raise NetworkError("run: need instances= or batch=")
        bounds = microbatch_plan(instances, self.cfg.microbatch_size)
        batch_id = self._batch_seq
        self._batch_seq += 1
        # durable write-ahead: record the batch BEFORE dispatch, so a
        # controller killed mid-batch leaves a replayable descriptor — the
        # adopter sees needs_recovery and resumes from the host snapshots;
        # _finish_batch overwrites this with the real outcome
        self._persist_meta(f"batch {batch_id} dispatched",
                           pending=(batch_id, bounds, instances, batch))
        # an explicit batch feeds the real Emit only — don't send it
        # through every host's work queue when one host owns the Emit
        emit_hosts = {self.plan.assignment[e.name]
                      for e in self.net.emits()}
        sent = self._wire_batch(batch)
        for h in self._live:
            self._work_qs[h].put(
                ("batch", batch_id, self.epoch, bounds, instances,
                 sent if h in emit_hosts else None, 0))
        with self.recorder.span("batch", "control", batch_id=batch_id,
                                epoch=self.epoch):
            reports = self._fresh_reports()
            results = self._await_results(batch_id, reports,
                                          set(self._live))
        return self._finish_batch(batch_id, bounds, instances, batch,
                                  reports, results)

    def _wire_batch(self, batch):
        """An explicit batch as it crosses a host's work queue: raw bytes
        to a process host (never a pickled tensor), as it is to a thread
        host.  The controller keeps the batch itself for a replay."""
        if batch is not None and self.transport.process_hosts:
            return pack_raw(batch)
        return batch

    def _fresh_reports(self) -> dict:
        plan = self.plan
        return {h: HostReport(
            host=h, procs=plan.procs_of(h), epoch=self.epoch,
            capacities={f"{c.src}->{c.dst}":
                        self.capacities[(c.src, c.dst)]
                        for c in plan.ingress_of(h) + plan.egress_of(h)})
            for h in self._live}

    def _finish_batch(self, batch_id, bounds, instances, batch,
                      reports: dict, results: dict) -> ClusterResult:
        self._last_reports = dict(reports)  # metrics() reads the last batch
        report_list = [reports[h] for h in self._live]
        if not all(r.ok for r in report_list):
            self._needs_recovery = True
            self._last_batch = (batch_id, bounds, instances, batch)
            self._ok_cache = results
            self._persist_meta(f"batch {batch_id} failed")
            from ..core import netlog
            try:
                depths = {f"{s}->{d}": n for (s, d), n
                          in self.transport.channel_depths().items()}
            except Exception:
                depths = None
            raise ClusterError(
                netlog.cluster_report(self.plan, report_list,
                                      events=self.events, depths=depths),
                report_list)
        merged = ClusterResult()
        for h in self._live:
            merged.update(results[h])
        merged.reports = report_list
        merged.epoch = self.epoch
        self._persist_meta(f"batch {batch_id} ok")
        return merged

    # -- controller-crash recovery: adopt a deployment's on-disk state ------
    def adopt_state(self, meta: dict,
                    salvage: Optional[dict] = None) -> RecoveryEvent:
        """Take ownership of a previous deployment's durable state: restore
        the ledger and pending-batch descriptor, bump the epoch so anything
        the dead controller left in flight is invisible, and re-prove the
        refinement across the restart (:func:`check_redeployment`).

        Without ``salvage`` every host worker spawns fresh (a full-cluster
        loss: fold state comes back from the on-disk snapshots at the next
        ``recover()``).  With ``salvage`` — the previous controller's live
        wiring (``transport``/``work_qs``/``threads``/``executors``/...) —
        surviving workers are re-parked under the new controller with their
        warm executors intact: 0 new stage builds on survivors.  Restored
        tensors go back onto the device of the thread host they belong
        to."""
        if self._started:
            raise NetworkError("adopt_state: controller already started")
        t0 = time.monotonic()
        old_epoch = meta["epoch"]
        old_plan = partition(self.net, assignment=meta["assignment"])
        self._batch_seq = meta["batch_seq"]
        if self.store is not None:
            self._meta_seq = self.store.meta_step() or 0
        self.recorder.instant("adopt", "control", epoch=old_epoch)
        ev = RecoveryEvent(
            epoch_from=old_epoch, epoch_to=old_epoch + 1, mode="adopt",
            dead=[], erred=[], stalled={}, restarted=[], moved={},
            requeued={}, discarded=0, replay_from={})
        if salvage is not None:
            self.transport = salvage["transport"]
            self._procs = salvage.get("procs", {})
            self._threads = salvage.get("threads", {})
            self._work_qs = salvage["work_qs"]
            self._result_q = salvage.get("result_q")
            self._result_qs = salvage.get("result_qs", {})
            self.executors = salvage.get("executors", {})
            self._devices = salvage.get("devices", {})
            self._started = True
            self._transport_up = True

            def _alive(h):
                th = self._threads.get(h)
                p = self._procs.get(h)
                return ((th is not None and th.is_alive())
                        or (p is not None and p.is_alive()))

            # survivors keep warm executors + any in-memory stalled fold;
            # hosts that died with the controller are marked dead so the
            # pending recover() restarts them (fold from disk snapshots)
            self._dead = {h for h in self._live if not _alive(h)}
            self._dead |= set(meta["dead"]) & set(self._live)
            self._stalled = {h: ci for h, ci in meta["stalled"].items()
                             if h in self._live and h not in self._dead}
            self._erred = set(meta["erred"]) & set(self._live) - self._dead
        # the pending batch and ledger come back BEFORE a fresh start(),
        # whose own meta record must not forget them
        self._needs_recovery = bool(meta["needs_recovery"])
        self._last_batch = meta["last_batch"]
        self._kept = {tuple(chan): list(records)
                      for chan, records in meta["kept"].items()}
        reclaimed = (0, 0)
        if salvage is None:
            # full-cluster loss: every worker spawns fresh, so nobody holds
            # in-memory fold state — the previous dead/stalled/erred sets
            # are moot (replay restores stateful folds from the snapshots).
            # What the dead deployment's processes could not unlink goes
            # first.
            reclaimed = reclaim(meta.get("named") or {})
            self.start()
        # completed hosts' cached results are plain data — epoch-independent,
        # so hosts the replay doesn't touch can still sit out and reuse them
        # (on their own device: a thread host's result lives there)
        self._ok_cache = {h: (to_device(r, self._devices[h])
                              if h in self._devices else r)
                          for h, r in meta["ok_cache"].items()}
        self.epoch = old_epoch + 1
        self.transport.set_epoch(self.epoch)
        self.recorder.instant("epoch_bump", "control", epoch=self.epoch)
        ev.dead = sorted(self._dead)
        ev.erred = sorted(self._erred)
        ev.stalled = dict(self._stalled)
        with self.recorder.span("reproof", "control", epoch=self.epoch):
            try:
                ev.refined = check_redeployment(self.net, old_plan,
                                                self.plan)
            except Exception:
                ev.refined = False
        ev.wall_s = time.monotonic() - t0
        self.events.append(ev)
        self.durable_events.append(DurabilityEvent(
            kind="adopt", epoch=self.epoch,
            step=(self.store.meta_step() or 0) if self.store else 0,
            note=f"batch_seq={self._batch_seq}"
                 + (f"; reclaimed {reclaimed[0]} semaphores, {reclaimed[1]} "
                    "/dev/shm segments" if any(reclaimed) else "")))
        self._persist_meta("adopted")
        return ev

    # -- durability (cluster/durable.py) -----------------------------------
    def _persist_meta(self, note: str = "",
                      pending: Optional[tuple] = None) -> None:
        """Write the controller's durable state through the store: the
        epoch-stamped plan assignment, the undelivered-chunk ledger, the
        pending-batch descriptor and cached per-host results, every tensor
        on the CPU (:func:`~.durable.to_host`).  Everything a fresh
        controller needs to adopt this deployment.

        ``pending`` is the write-ahead form: the durable record carries the
        just-dispatched batch with ``needs_recovery`` set (so an adopter of
        a controller that died mid-batch replays it) WITHOUT flipping the
        live controller's own flags — the batch is still running here."""
        if self.store is None:
            return
        last = pending if pending is not None else self._last_batch
        with self.recorder.span("persist", "durable", epoch=self.epoch,
                                seq=self._meta_seq + 1) as sp:
            state = {
                "epoch": self.epoch,
                "assignment": dict(self.plan.assignment),
                "cfg": {k: v for k, v in dataclasses.asdict(self.cfg).items()
                        if k != "profile"},  # measured, not durable state
                "batch_seq": self._batch_seq,
                "needs_recovery": (True if pending is not None
                                   else self._needs_recovery),
                "stalled": dict(self._stalled),
                "dead": sorted(self._dead),
                "erred": sorted(self._erred),
                "last_batch": None if last is None else to_host(last),
                "ok_cache": to_host(self._ok_cache),
                "kept": {chan: to_host(records)
                         for chan, records in self._kept.items()},
                "named": self._named_resources(),
            }
            self._meta_seq += 1
            sp.set(nbytes=self.store.save_meta(self._meta_seq, state))
            if pending is None:
                # batch outcomes / recovery / adoption must be on disk
                # before anyone (a new controller, a test) reads the store;
                # the write-ahead record alone may ride the async queue
                self.store.flush()
        self.durable_events.append(DurabilityEvent(
            kind="snapshot", epoch=self.epoch, step=self._meta_seq,
            note=note))

    def _named_resources(self) -> dict:
        """The machine-wide named objects (semaphores, ``/dev/shm``
        segments) of this deployment's process transport and host queues,
        with this controller's pid: what an adopter reclaims if this
        process dies without closing."""
        if not self.transport.process_hosts:
            return {}
        sems, shms = self.transport.named_resources()
        sems += queue_semaphores([*self._work_qs.values(),
                                  *self._result_qs.values()])
        return {"controller_pid": os.getpid(), "sem": sems, "shm": shms}

    def _snapshot_ci(self, h: int, batch_id: int,
                     bounds: list) -> tuple[int, Optional[dict]]:
        """The chunk index host ``h``'s latest on-disk fold snapshot covers
        for this batch (0 / None when there is none or it doesn't match)."""
        if self.store is None:
            return 0, None
        snap = self.store.load_host_snapshot(h)
        if (snap is None or snap.get("batch_id") != batch_id
                or list(snap.get("bounds", [])) != [tuple(b) for b in bounds]
                or not 0 < snap.get("next_ci", 0) <= len(bounds)):
            return 0, None
        return snap["next_ci"], snap

    # -- observability (core/trace.py) -------------------------------------
    def _absorb_trace(self, host, payload) -> None:
        """Bank one host's drained ring.  The clock offset aligning that
        host onto the controller clock is computed ONCE (first payload) and
        reused, so the host's own monotonic event order is stable."""
        if payload is None:
            return
        raw, host_now, virtual = payload
        if host not in self._trace_offsets:
            if virtual or not self.transport.process_hosts:
                offset = 0.0  # shared (or virtual) clock: already aligned
            else:
                offset = time.perf_counter() - host_now
            self._trace_offsets[host] = offset
        if raw:
            self._trace_events.setdefault(host, []).extend(raw)

    def merged_trace(self) -> list:
        """Every host's events (plus the controller's own), offset-aligned
        onto one timeline — :class:`..core.trace.TraceEvent` rows."""
        groups = []
        if len(self.recorder):
            groups.append(("ctrl", 0.0, list(self.recorder._buf)))
        for h in sorted(self._trace_events, key=str):
            groups.append((h, self._trace_offsets.get(h, 0.0),
                           self._trace_events[h]))
        return _trace.merge_events(groups)

    def export_trace(self, path: Optional[str] = None) -> str:
        """Chrome trace-event / Perfetto JSON of the merged timeline."""
        return _trace.export_chrome(self.merged_trace(), path)

    def clear_trace(self) -> None:
        """Drop banked events (keep clock offsets)."""
        self._trace_events = {}
        self.recorder.clear()

    def metrics(self) -> "_trace.MetricsSnapshot":
        """A point-in-time :class:`..core.trace.MetricsSnapshot`: live
        cut-channel queue depths/occupancy from the transport, plus each
        host's last-batch throughput / stall-rate / bytes-per-second
        sample."""
        snap = _trace.MetricsSnapshot(epoch=self.epoch)
        caps = self.transport.channel_capacities()
        for chan, depth in self.transport.channel_depths().items():
            key = f"{chan[0]}->{chan[1]}"
            snap.queue_depths[key] = depth
            cap = caps.get(chan, 0)
            if depth >= 0:
                snap.occupancy[key] = (min(depth / cap, 1.0) if cap
                                       else None)
        for h, rep in self._last_reports.items():
            m = rep.metrics
            if not m:
                continue
            snap.throughput[h] = m.get("items_per_s", 0.0)
            snap.stall_rate[h] = m.get("stalls_per_chunk", 0.0)
            snap.batch_wall_s[h] = m.get("wall_s", 0.0)
        for chan_key, (nbytes, wall) in self._cum_chan.items():
            if wall > 0:
                snap.bytes_per_s[chan_key] = nbytes / wall
        return snap

    def _prune_metrics(self, new_plan: PartitionPlan) -> None:
        """Drop telemetry rows a replan made meaningless, at the epoch
        bump: ``_last_reports`` entries for hosts the new plan dropped or
        renamed (a policy polling :meth:`metrics` must never see ghost
        hosts), and ``_cum_chan`` ledger keys whose endpoint processes the
        replanned net no longer has (dangling string keys would otherwise
        leak into ``bytes_per_s`` forever).  A channel a replan merely
        stopped cutting keeps its lifetime history: a later replan can
        cut it again, and its rate must resume, not reset."""
        live = set(new_plan.hosts())
        self._last_reports = {h: r for h, r in self._last_reports.items()
                              if h in live}
        procs = set(new_plan.net.procs)
        self._cum_chan = {
            k: v for k, v in self._cum_chan.items()
            if k.partition("->")[0] in procs
            and k.partition("->")[2] in procs}

    def _absorb_chan_totals(self, m: dict) -> None:
        """Fold one host's per-batch metrics into the cumulative per-channel
        ledger (``sent_bytes`` over that batch's ``wall_s``)."""
        if not m:
            return
        wall = m.get("wall_s", 0.0)
        if wall <= 0:
            return
        for chan_key, nbytes in m.get("sent_bytes", {}).items():
            tot = self._cum_chan.setdefault(chan_key, [0.0, 0.0])
            tot[0] += nbytes
            tot[1] += wall

    def _poll_results(self, pending: set, timeout: float) -> list:
        """Whatever results the pending hosts have delivered, waiting up to
        ``timeout`` for the first.  Thread hosts share one queue; process
        hosts are polled via ``connection.wait`` on their own queues, so a
        host that dies mid-report can never wedge a survivor's delivery."""
        if not self.transport.process_hosts:
            try:
                return [self._result_q.get(timeout=timeout)]
            except _queue.Empty:
                return []
        qs = [self._result_qs[h] for h in sorted(pending)
              if h in self._result_qs]
        if not qs:
            time.sleep(timeout)
            return []
        if all(hasattr(q, "_reader") for q in qs):
            ready = set(_mp_wait([q._reader for q in qs], timeout))
            out = []
            for q in qs:
                if q._reader in ready:
                    try:
                        out.append(q.get_nowait())
                    except _queue.Empty:
                        pass
            return out
        # the fault-injection simulator's thread-backed process hosts hand
        # out plain queue.Queue stand-ins with no waitable pipe: sweep them
        deadline = time.monotonic() + timeout
        while True:
            out = []
            for q in qs:
                try:
                    out.append(q.get_nowait())
                except _queue.Empty:
                    pass
            if out or time.monotonic() >= deadline:
                return out
            time.sleep(0.005)

    def _await_results(self, batch_id: int, reports: dict,
                       pending: set) -> dict:
        """One result per pending host, within one shared wall clock.

        A host process that dies without reporting (kill, segfault, OOM) is
        detected after two empty polls of grace; the controller then speaks
        for the corpse — EOS down its egress channels so blocked consumers
        stall instead of hanging, its ingress drained so blocked producers
        finish."""
        results: dict = {}
        deadline = time.monotonic() + self.timeout_s
        dead_strikes: dict = {}
        failed_hosts: set = set()
        backlog: list = []
        while pending and time.monotonic() < deadline:
            if not backlog:
                backlog = self._poll_results(pending, self.poll_s)
            if not backlog:
                for h in sorted(pending):
                    p = self._procs.get(h)
                    if p is not None and not p.is_alive():
                        dead_strikes[h] = dead_strikes.get(h, 0) + 1
                        if dead_strikes[h] >= 2:
                            reports[h].error = (
                                f"host process died (exitcode {p.exitcode})"
                                " without reporting")
                            self._dead.add(h)
                            failed_hosts.add(h)
                            pending.discard(h)
                self._quiesce(failed_hosts)
                continue
            status, h, bid, ep, payload, stats = backlog.pop(0)
            if h not in pending:
                continue
            if ep != -1 and ep != self.epoch:
                # stale report from an abandoned epoch: a host that stalled
                # past timeout_s finishes the OLD attempt and reports under
                # the old epoch (same batch id as the replay); it still owes
                # a current-epoch report for the queued message
                continue
            batch_metrics = None
            if stats is not None:
                (reports[h].stats_summary, reports[h].donation_summary,
                 reports[h].jit_builds) = stats[:3]
                batch_metrics = reports[h].metrics = stats[3] or {}
                self._absorb_trace(h, stats[4])
            if status == "ok":
                if bid != batch_id:
                    continue  # stale success from an abandoned batch
                if batch_metrics:
                    self._absorb_chan_totals(batch_metrics)
                results[h] = (unpack_raw(payload)
                              if self.transport.process_hosts else payload)
                reports[h].ok = True
            elif status == "stalled":
                resume_ci, tb = payload
                reports[h].stalled = True
                reports[h].resume_ci = resume_ci
                reports[h].error = tb
                if bid == batch_id:
                    self._stalled[h] = resume_ci
                failed_hosts.add(h)
                self._quiesce(failed_hosts)
            else:  # errors count whatever batch they were raised on
                reports[h].error = payload
                self._erred.add(h)
                failed_hosts.add(h)
                self._quiesce(failed_hosts)
            pending.discard(h)
        for h in pending:
            reports[h].error = f"no result within {self.timeout_s}s"
            self._erred.add(h)
        return results

    def _quiesce(self, failed_hosts: set) -> None:
        """Stop the failure from hanging its neighbours: EOS down each
        failed host's egress (consumers stall resumably), and drain each
        failed host's ingress (producers unblock and finish) — keeping
        records bound for *stalled* survivors for post-recovery requeue."""
        if not failed_hosts:
            return
        plan, t = self.plan, self.transport
        for h in failed_hosts:
            for c in plan.egress_of(h):
                t.inject_eos((c.src, c.dst))
        drain_chans = [(c.src, c.dst) for h in failed_hosts
                       for c in plan.ingress_of(h)]
        keep = {(c.src, c.dst) for c in plan.cut
                if plan.assignment[c.dst] in self._stalled}
        if drain_chans:
            for chan, (kept, _) in t.drain(drain_chans,
                                           keep=keep).items():
                if kept:
                    self._kept.setdefault(chan, []).extend(kept)

    # -- recovery ----------------------------------------------------------
    def recover(self, mode: str = "restart",
                replay: bool = True) -> Optional[ClusterResult]:
        """Bring a failed deployment back without a fresh ``start()``.

        ``mode="restart"`` respawns each dead host's worker against the
        warm transport (the plan is unchanged); ``mode="rebalance"`` reuses
        the planner to move the failed hosts' processes onto survivors (a
        new plan, re-proved against the original network).  Either way the
        surviving channels are drained — undelivered chunks bound for
        stalled survivors are requeued under the bumped epoch — and, with
        ``replay=True``, the failed batch is replayed: stalled hosts resume
        at their first lost chunk, everyone else re-streams only what the
        survivors still need.  Returns the replayed batch's result (None
        when ``replay=False`` or no batch was pending)."""
        if mode not in ("restart", "rebalance"):
            raise NetworkError(f"recover: unknown mode {mode!r}")
        if not self._needs_recovery:
            raise NetworkError("recover: nothing to recover — the last "
                               "batch completed")
        t0 = time.monotonic()
        old_plan = self.plan
        self.recorder.instant("recover", "control", mode=mode,
                              dead=sorted(self._dead),
                              erred=sorted(self._erred))
        ev = RecoveryEvent(
            epoch_from=self.epoch, epoch_to=self.epoch + 1, mode=mode,
            dead=sorted(self._dead), erred=sorted(self._erred),
            stalled=dict(self._stalled), restarted=[], moved={},
            requeued={}, discarded=0, replay_from={})
        # 1. drain what the failed stream left in the channels (quiesce
        #    kept partial passes; this is the full sweep)
        keep = {(c.src, c.dst) for c in self.plan.cut
                if self.plan.assignment[c.dst] in self._stalled}
        with self.recorder.span("drain", "control", epoch=self.epoch):
            for chan, (kept, dropped) in self.transport.drain(
                    keep=keep).items():
                if kept:
                    self._kept.setdefault(chan, []).extend(kept)
                ev.discarded += dropped
        # 1b. a host killed while blocked in recv died HOLDING its ingress
        #     FIFO's reader lock — the restarted worker (and every later
        #     drain) would block on the bricked queue forever.  Probe the
        #     dead hosts' ingress channels; rebuild what the transport can
        #     (respawning any live host that still holds an endpoint onto
        #     the abandoned FIFO — spawned processes snapshot the queue
        #     map), otherwise route around it via mode="rebalance".
        force_restart: set = set()
        if self._dead:
            ingress = [(c.src, c.dst) for h in sorted(self._dead)
                       for c in self.plan.ingress_of(h)]
            with self.recorder.span("brick_probe", "control"):
                bricked = (self.transport.bricked_channels(ingress)
                           if ingress else set())
            ev.bricked = sorted(f"{a}->{b}" for a, b in bricked)
            if bricked:
                if all(self.transport.rebuild_channel(chan)
                       for chan in sorted(bricked)):
                    if self.transport.process_hosts:
                        # whatever the bricked FIFO still held is
                        # unreachable; the replay re-streams it, so the
                        # rebuilt channel's live endpoints must restart
                        for chan in bricked:
                            for p_name in chan:
                                h = self.plan.assignment[p_name]
                                if h not in self._dead:
                                    force_restart.add(h)
                else:
                    # erred hosts count: their worker is parked warm and
                    # can absorb the dead hosts' processes — only a host
                    # whose WORKER died is not a rebalance target
                    survivors = sorted(set(self._live) - self._dead)
                    if not survivors:
                        raise NetworkError(
                            f"recover: bricked ingress FIFO(s) "
                            f"{ev.bricked} cannot be rebuilt by the "
                            f"{self.transport.name!r} transport and no "
                            "surviving host is left to rebalance around "
                            "them — the deployment cannot be recovered "
                            "(fresh start() required)")
                    # route around instead: FORGET the bricked FIFOs so the
                    # rebalance's reconfigure recreates any that stay in
                    # the new cut, and restart live hosts whose endpoints
                    # snapshot the abandoned queue
                    for chan in sorted(bricked):
                        self.transport.forget_channel(chan)
                        if self.transport.process_hosts:
                            for p_name in chan:
                                h = self.plan.assignment[p_name]
                                if h not in self._dead:
                                    force_restart.add(h)
                    if mode != "rebalance":
                        ev.auto_mode = ("auto-fallback restart->rebalance: "
                                        "bricked FIFO not rebuildable")
                        mode = ev.mode = "rebalance"
        # 2. restart or rebalance the failed hosts
        with self.recorder.span(f"recover_{mode}", "control"):
            if mode == "rebalance" and (self._dead or self._erred):
                self._rebalance(ev)
                for h in sorted(force_restart):  # stale endpoints onto a
                    # rebuilt FIFO still in the new cut: respawn those too
                    if h in self._live and h not in ev.restarted:
                        self._stalled.pop(h, None)
                        self.restart_host(h)
                        ev.restarted.append(h)
            else:
                for h in sorted(set(self._dead) | force_restart):
                    if h not in self._dead:
                        # a force-restarted survivor loses any stalled fold
                        # state with its worker — it replays from scratch
                        self._stalled.pop(h, None)
                    self.restart_host(h)
                    ev.restarted.append(h)
        # 3. new epoch: stale records become invisible
        self.epoch += 1
        self.transport.set_epoch(self.epoch)
        self.recorder.instant("epoch_bump", "control", epoch=self.epoch)
        # 4. requeue undelivered chunks for the stalled survivors (at most
        #    one FIFO's worth — the replay covers the rest).  They belong to
        #    the FAILED batch, so they only go back when that batch is about
        #    to be replayed; a recover(replay=False) that moves on to fresh
        #    batches discards them (a fresh consumer expects chunk 0)
        requeued_map: dict = {}
        cut = {(c.src, c.dst) for c in self.plan.cut}
        with self.recorder.span("requeue", "control", epoch=self.epoch):
            for chan, records in sorted(self._kept.items()):
                if (replay and self._last_batch is not None
                        and chan in cut
                        and self.plan.assignment[chan[1]] in self._stalled):
                    n = self.transport.requeue(chan, records)
                    requeued_map[chan] = [ci for ci, _ in records[:n]]
                    ev.requeued[f"{chan[0]}->{chan[1]}"] = requeued_map[chan]
                    ev.discarded += len(records) - n
                else:
                    ev.discarded += len(records)
        self._kept = {}
        # 5. re-prove the refinement (paper §6.1.1) for the new epoch's plan
        with self.recorder.span("reproof", "control", epoch=self.epoch):
            try:
                ev.refined = check_redeployment(self.net, old_plan,
                                                self.plan)
            except Exception:
                ev.refined = False
        # 6. replay only the lost chunks of the failed batch.  Snapshot and
        #    clear the failure state first: if the replay fails TOO, the
        #    await loop repopulates it fresh for the next recover()
        result = None
        pending_batch, ok_cache = self._last_batch, self._ok_cache
        stalled = dict(self._stalled)
        self._dead.clear()
        self._erred.clear()
        self._stalled = {}
        self._last_batch = None
        self._ok_cache = {}
        self._needs_recovery = False
        try:
            if replay and pending_batch is not None:
                with self.recorder.span("replay", "control",
                                        epoch=self.epoch):
                    result = self._replay(pending_batch, stalled, ok_cache,
                                          requeued_map, ev)
                # a resumed consumer consumes fewer records than the
                # replaying producer re-sends: what it had folded before
                # the failure arrives again and lingers after its stream
                # ends, stamped with the CURRENT epoch, so the next batch
                # would misread it as its own chunks.  Every host is idle
                # once the replay's results are in: sweep the cut clean.
                for chan, (kept, dropped) in self.transport.drain().items():
                    ev.discarded += dropped + len(kept)
        finally:
            ev.wall_s = time.monotonic() - t0
            self.events.append(ev)
            self._persist_meta(f"recovered to epoch {self.epoch}")
        return result

    def _replan(self, new_plan: PartitionPlan) -> tuple[list, list]:
        """Swap in ``new_plan``: capacities, live hosts, the transport's
        cut channels and the thread hosts' devices, with telemetry rows the
        new plan made meaningless pruned.  Returns the surviving hosts
        whose wiring changed and the hosts the plan dropped (the caller
        restarts and stops them)."""
        old_plan = self.plan
        new_caps = derive_cut_capacities(new_plan, self.cfg)
        changed = [h for h in new_plan.hosts()
                   if h in old_plan.hosts()
                   and _host_shape(old_plan, h) != _host_shape(new_plan, h)]
        dropped = [h for h in old_plan.hosts()
                   if h not in new_plan.hosts()]
        self.plan = new_plan
        self.capacities = new_caps
        self._live = new_plan.hosts()
        self.transport.reconfigure(
            [(c.src, c.dst) for c in new_plan.cut], new_caps)
        self._bind_devices()
        self._prune_metrics(new_plan)
        return changed, dropped

    def _rebalance(self, ev: RecoveryEvent) -> None:
        """Reuse the planner: move the failed hosts' processes onto
        survivors, rebuild only the workers whose partition changed."""
        evacuate = sorted(self._dead or self._erred)
        old_plan = self.plan
        new_assign = repartition_without(old_plan, evacuate)
        new_plan = partition(self.net, assignment=new_assign)
        ev.moved = {p: (old_plan.assignment[p], new_assign[p])
                    for p in new_assign
                    if old_plan.assignment[p] != new_assign[p]}
        changed, dropped = self._replan(new_plan)
        for h in dropped:
            self.stop_host(h)
            self._work_qs.pop(h, None)
        for h in changed:
            # a rebuilt worker loses any stalled fold state with its old
            # subnetwork — it replays from scratch, survivors don't
            self._stalled.pop(h, None)
            self.restart_host(h)
            ev.restarted.append(h)
        for h in sorted(set(self._dead) & set(self._live)):
            if h not in changed:
                self.restart_host(h)
                ev.restarted.append(h)

    # -- elasticity for capacity (not failure) ------------------------------
    def reconfigure(self, *, hosts: Optional[int] = None,
                    plan: Optional[PartitionPlan] = None) -> RecoveryEvent:
        """Re-fit the SAME network to a different host count — scale-out or
        scale-in of a live deployment, between batches, as an epoch bump
        rather than a restart: drain the channels (leftovers of the old
        epoch are discarded), swap in the new plan, reconfigure the cut
        channels, stop hosts the plan dropped, restart hosts whose wiring
        changed, spawn hosts it added, bump the epoch and re-prove the
        refinement (:func:`check_redeployment`).  Hosts whose shape is
        unchanged keep their warm executors.

        Returns the :class:`RecoveryEvent` (``mode="reconfigure"``).  Call
        between batches; a pending failure is recovered (without replay)
        first, as :meth:`run_batch` would."""
        if self._closed:
            raise NetworkError("ClusterDeployment: already closed")
        if (hosts is None) == (plan is None):
            raise NetworkError(
                "reconfigure: need exactly one of hosts= or plan=")
        self.start()
        if self._needs_recovery:
            self.recover(replay=False)
        t0 = time.monotonic()
        self.recorder.instant("reconfigure", "control",
                              hosts=hosts, epoch=self.epoch)
        old_plan = self.plan
        new_plan = (plan if plan is not None
                    else partition(self.net, hosts=hosts))
        added = [h for h in new_plan.hosts() if h not in old_plan.hosts()]
        ev = RecoveryEvent(
            epoch_from=self.epoch, epoch_to=self.epoch + 1,
            mode="reconfigure", dead=[], erred=[], stalled={},
            restarted=[], moved={}, requeued={}, discarded=0,
            replay_from={})
        # nothing is in flight between batches, but a failed earlier batch
        # may have left records behind: sweep them under the old epoch
        for chan, (kept, dropped) in self.transport.drain().items():
            ev.discarded += dropped + len(kept)
        self._kept = {}
        ev.moved = {p: (old_plan.assignment[p], new_plan.assignment[p])
                    for p in new_plan.assignment
                    if old_plan.assignment.get(p) != new_plan.assignment[p]}
        changed, dropped_hosts = self._replan(new_plan)
        for h in dropped_hosts:
            self.stop_host(h)
            self._work_qs.pop(h, None)
        for h in changed:
            self.restart_host(h)
            ev.restarted.append(h)
        for h in added:
            self.spawn_host(h)
            ev.restarted.append(h)
        self.epoch += 1
        self.transport.set_epoch(self.epoch)
        self.recorder.instant("epoch_bump", "control", epoch=self.epoch)
        try:
            ev.refined = check_redeployment(self.net, old_plan, self.plan)
        except Exception:
            ev.refined = False
        ev.wall_s = time.monotonic() - t0
        self.events.append(ev)
        self._persist_meta(f"reconfigured to epoch {self.epoch}")
        return ev

    def _host_stateful(self, h: int) -> bool:
        """A host whose partition folds state across chunks (a real Collect
        or a COMBINE reducer) cannot replay a stream tail — it must re-run
        from chunk 0 unless it kept resumable state."""
        for name in self.plan.procs_of(h):
            p = self.plan.net.procs[name]
            if p.kind is Kind.COLLECT:
                return True
            if (p.kind is Kind.REDUCER
                    and p.distribution is Distribution.COMBINE):
                return True
        return False

    def _host_order(self) -> list:
        """Hosts in dataflow order (the host graph is acyclic by plan
        construction)."""
        plan = self.plan
        hosts = plan.hosts()
        succ = {h: set() for h in hosts}
        indeg = {h: 0 for h in hosts}
        for c in plan.cut:
            a, b = plan.assignment[c.src], plan.assignment[c.dst]
            if b not in succ[a]:
                succ[a].add(b)
                indeg[b] += 1
        order, ready = [], sorted(h for h in hosts if indeg[h] == 0)
        while ready:
            h = ready.pop(0)
            order.append(h)
            for m in sorted(succ[h]):
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        return order

    def _replay(self, pending_batch, stalled: dict, ok_cache: dict,
                requeued_map: dict, ev: RecoveryEvent) -> ClusterResult:
        """Replay the failed batch: stalled hosts resume their saved fold,
        everyone else streams from the first chunk some consumer still
        needs (0 for stateful partitions), hosts nobody needs sit out."""
        batch_id, bounds, instances, batch = pending_batch
        n = len(bounds)
        plan = self.plan
        # chan -> first ci NOT covered by the requeued undelivered chunks
        requeued_next = {chan: max(cis) + 1
                         for chan, cis in requeued_map.items() if cis}
        from_ci: dict = {}
        snap_state: dict = {}  # host -> on-disk fold snapshot to resume from
        for h in reversed(self._host_order()):
            if h in stalled:
                from_ci[h] = stalled[h]
                continue
            needs = []
            for c in plan.egress_of(h):
                dst_h = plan.assignment[c.dst]
                need = from_ci.get(dst_h, 0)
                if dst_h in stalled:
                    need = max(need, requeued_next.get((c.src, c.dst), 0))
                needs.append(need)
            limit = min(needs) if needs else n
            if self._host_stateful(h):
                # a stateful partition that lost its in-memory fold re-runs
                # from chunk 0 — unless a durable snapshot covers a prefix
                # AND no downstream consumer needs chunks before it (the
                # snapshot holds fold state only at its own boundary)
                ci, snap = self._snapshot_ci(h, batch_id, bounds)
                if snap is not None and ci <= limit:
                    from_ci[h] = ci
                    snap_state[h] = snap
                else:
                    from_ci[h] = 0
                continue
            from_ci[h] = limit
        participants = [
            h for h in self._live
            if h in stalled or from_ci[h] < n
            or h not in ok_cache]  # hosts with no usable result rerun
        emit_hosts = {plan.assignment[e.name] for e in self.net.emits()}
        sent = self._wire_batch(batch)
        for h in participants:
            start = from_ci[h] if h not in stalled else 0
            ev.replay_from[h] = stalled[h] if h in stalled else from_ci[h]
            if h in snap_state and from_ci[h] > 0:
                snap = snap_state[h]
                if self.transport.process_hosts:
                    snap = pack_raw(snap)  # bytes, not pickled tensors
                self._work_qs[h].put(
                    ("replay_snap", batch_id, self.epoch, bounds, instances,
                     sent if h in emit_hosts else None, from_ci[h], snap))
            else:
                self._work_qs[h].put(
                    ("replay", batch_id, self.epoch, bounds, instances,
                     sent if h in emit_hosts else None, start))
        restored = {h: from_ci[h] for h in snap_state if from_ci[h] > 0}
        if restored:
            self.durable_events.append(DurabilityEvent(
                kind="restore", epoch=self.epoch,
                step=self.store.meta_step() or 0, hosts=restored))
        reports = self._fresh_reports()
        results = self._await_results(batch_id, reports, set(participants))
        for h in self._live:  # hosts that sat the replay out reuse their
            # completed result verbatim — ONLY those: a participant that
            # produced nothing (killed again mid-replay) must stay not-ok
            if h not in participants and h not in results and h in ok_cache:
                results[h] = ok_cache[h]
                reports[h].ok = True
                reports[h].stats_summary = ("(reused: completed before "
                                            "the failure)")
        return self._finish_batch(batch_id, bounds, instances, batch,
                                  reports, results)
