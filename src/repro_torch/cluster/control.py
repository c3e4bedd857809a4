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

Repairing a failed deployment — :meth:`ClusterController.recover`, the
rebalance and reconfigure replans, adoption of a durable deployment, and
the host lifecycle verbs that only recovery needs — is the elastic
cluster slice of the port; each of those raises ``NotImplementedError``
naming it.  A batch that fails raises :class:`~.runtime.ClusterError`
carrying the cluster report, and the deployment then refuses further
batches rather than limp on.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
import traceback
from multiprocessing.connection import wait as _mp_wait
from typing import Any, Optional

import torch
import torch.utils._pytree as pytree

from ..core import trace as _trace
from ..core.dataflow import Network, NetworkError
from ..core.stream import microbatch_plan
from ..device import resolve_device, to_device
from .partition import PartitionPlan, is_shim, partition
from .runtime import (ClusterError, ClusterResult, ExecConfig, HostReport,
                      _emit_batch, _signal_failure, derive_cut_capacities,
                      make_host_executor)
from .transport import (ChannelTransport, DeviceTransport, pack_raw,
                        unpack_raw)

__all__ = ["ClusterController", "RecoveryEvent"]

_SHUTDOWN = "__gpp_shutdown__"

ELASTIC_SLICE = (
    "comes with the elastic cluster slice of the port (recovery, "
    "rebalance and reconfiguration: the JAX package's "
    "cluster/control.py:798-1388 with the stream replay pieces)")


@dataclasses.dataclass
class RecoveryEvent:
    """One recovery of a live deployment (epoch N -> N+1), for the report.
    The type only: recoveries themselves come with the elastic slice."""

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
    state intact), its own failure is reported with a full traceback and
    its run state reset — either way it parks again, warm, and the
    controller decides what happens next.
    """
    while True:
        msg = work_q.get()
        if isinstance(msg, str) and msg == _SHUTDOWN:
            break
        _, batch_id, epoch, bounds, instances, batch, start_ci = msg
        endpoint.epoch = epoch
        before = ex.jit_builds
        t0 = time.monotonic()
        try:
            if batch is None or not _has_real_emit(sub):
                batch = _emit_batch(sub, instances, ex.cn.device)
            elif encode:  # crossed the work queue as raw bytes
                batch = unpack_raw(batch, ex.cn.device)
            else:
                batch = to_device(batch, ex.cn.device)
            ex.reset_run_state()
            out = ex.run_partition(list(bounds), batch, start_ci=start_ci)
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
    transport, and one parked worker per host, with :meth:`spawn_host`,
    :meth:`stop_host`, :meth:`close` and :meth:`run_batch`.
    :class:`~.deploy.ClusterDeployment` is the user-facing facade over this
    class."""

    def __init__(self, net: Network, plan: PartitionPlan, cfg: ExecConfig,
                 transport: ChannelTransport, factory: Optional[tuple],
                 timeout_s: float):
        self.net = net
        self.plan = plan
        self.cfg = cfg
        self.transport = transport
        self.factory = factory
        self.timeout_s = timeout_s
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
        self._needs_recovery = False  # the last batch failed
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
        host on one card shares it), with each cut channel bound to its
        consumer's device.  Process hosts resolve their own."""
        t = self.transport
        if t.process_hosts:
            return
        base = resolve_device(self.cfg.device)
        if isinstance(t, DeviceTransport):
            split = t.device_split(len(self._live), base)
            self._devices = {h: split[i] for i, h in enumerate(self._live)}
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
        """Retire host ``h``'s worker: drain its park queue, ask it to shut
        down, and join it (a process that does not stop is terminated)."""
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
        raise NotImplementedError(f"restart_host {ELASTIC_SLICE}")

    def kill_host(self, h: int) -> None:
        raise NotImplementedError(f"kill_host {ELASTIC_SLICE}")

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
        raise :class:`ClusterError` carrying the cluster report."""
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
        # an explicit batch feeds the real Emit only — don't send it
        # through every host's work queue when one host owns the Emit
        emit_hosts = {self.plan.assignment[e.name]
                      for e in self.net.emits()}
        if batch is not None and self.transport.process_hosts:
            batch = pack_raw(batch)  # bytes, not a pickled tensor
        for h in self._live:
            self._work_qs[h].put(
                ("batch", batch_id, self.epoch, bounds, instances,
                 batch if h in emit_hosts else None, 0))
        with self.recorder.span("batch", "control", batch_id=batch_id,
                                epoch=self.epoch):
            reports = self._fresh_reports()
            results = self._await_results(batch_id, reports,
                                          set(self._live))
        return self._finish_batch(reports, results)

    def _fresh_reports(self) -> dict:
        plan = self.plan
        return {h: HostReport(
            host=h, procs=plan.procs_of(h), epoch=self.epoch,
            capacities={f"{c.src}->{c.dst}":
                        self.capacities[(c.src, c.dst)]
                        for c in plan.ingress_of(h) + plan.egress_of(h)})
            for h in self._live}

    def _finish_batch(self, reports: dict, results: dict) -> ClusterResult:
        self._last_reports = dict(reports)  # metrics() reads the last batch
        report_list = [reports[h] for h in self._live]
        if not all(r.ok for r in report_list):
            self._needs_recovery = True
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
        return merged

    # -- the elastic slice's verbs ------------------------------------------
    def recover(self, mode: str = "restart",
                replay: bool = True) -> Optional[ClusterResult]:
        """Repair a failed deployment: the elastic slice's work."""
        raise NotImplementedError(
            f"recovering a failed deployment {ELASTIC_SLICE}; this "
            "deployment had a failed batch — close it and start a new one")

    def reconfigure(self, *, hosts: Optional[int] = None, plan=None):
        raise NotImplementedError(f"reconfigure {ELASTIC_SLICE}")

    def adopt_state(self, meta: dict, salvage: Optional[dict] = None):
        raise NotImplementedError(
            "adopting a durable deployment comes with the durable cluster "
            "slice of the port (cluster/durable.py with train/checkpoint.py)")

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
        ready = set(_mp_wait([q._reader for q in qs], timeout))
        out = []
        for q in qs:
            if q._reader in ready:
                try:
                    out.append(q.get_nowait())
                except _queue.Empty:
                    pass
        return out

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
                            failed_hosts.add(h)
                            pending.discard(h)
                self._quiesce(failed_hosts)
                continue
            status, h, bid, ep, payload, stats = backlog.pop(0)
            if h not in pending:
                continue
            if ep != -1 and ep != self.epoch:
                continue  # stale report from an abandoned epoch
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
                failed_hosts.add(h)
                self._quiesce(failed_hosts)
            else:  # errors count whatever batch they were raised on
                reports[h].error = payload
                failed_hosts.add(h)
                self._quiesce(failed_hosts)
            pending.discard(h)
        for h in pending:
            reports[h].error = f"no result within {self.timeout_s}s"
        return results

    def _quiesce(self, failed_hosts: set) -> None:
        """Stop the failure from hanging its neighbours: EOS down each
        failed host's egress (consumers stall), and drain each failed host's
        ingress (producers unblock and finish).  What is drained is
        discarded: requeueing it for a resumed batch is recovery's work."""
        if not failed_hosts:
            return
        plan, t = self.plan, self.transport
        for h in failed_hosts:
            for c in plan.egress_of(h):
                t.inject_eos((c.src, c.dst))
        drain_chans = [(c.src, c.dst) for h in failed_hosts
                       for c in plan.ingress_of(h)]
        if drain_chans:
            t.drain(drain_chans)
