"""Deterministic fault-injection simulator for the cluster control plane.

The paper's headline guarantee — networks are deadlock- and livelock-free
and terminate correctly, proved by formal methods (§6) — covers the *static*
CSP models; the control plane (:mod:`.control`) adds a dynamic protocol
(epoch-stamped records, drain/requeue, restart/rebalance, chunk replay,
adoption by a new controller) whose correctness depends on *interleavings*
no hand-written kill test enumerates.  This module drives the real
implementation through seeded failure schedules:

* :class:`SimTransport` implements the full
  :class:`~.transport.ChannelTransport` interface (epoch protocol, drain,
  requeue, inject_eos, brick probe and rebuild) in-process; every protocol
  operation ticks a shared :class:`SimClock` (bounded virtual time = the
  livelock check) and consults a seeded :class:`FaultSchedule`;
* hosts are :class:`FakeProcess` threads behind the *real* spawned-process
  code path: ``SimTransport.process_hosts`` is True and its ``ctx`` hands
  the unmodified :class:`~.control.ClusterController` a thread-backed
  ``Process``/``Queue`` API — so spawn, dead-host detection (``is_alive``
  strikes), quiesce, drain, the brick probe, rebuild, force-restart, chunk
  replay, and the batches and results crossing as raw bytes all execute
  the production code, not a model of it.  The hosts run on the card
  unless the scenario is given ``device="cpu"``; on the card they share
  this process's CUDA context;
* a fault ``kill``\\ s a host at an exact protocol step — its *n*-th
  ``recv`` or ``send``, while picking a batch up off the work queue
  (``park``), while writing a fold snapshot (``snap``), or asynchronously
  while the controller runs ``drain``, sits between drain and ``requeue``,
  or bumps the epoch — or ``stall``\\ s it there.  A host killed while
  blocked reading a FIFO *bricks* that channel, exactly like a real SIGKILL
  leaves a corpse holding the mp queue's reader lock; endpoints snapshot
  the queue map the way spawned processes do, so a rebuilt FIFO is
  invisible to stale endpoints until the controller force-restarts them;
* after every scenario the §6.1.1 invariants are asserted: results
  bit-identical to ``run_sequential``, ``check_redeployment`` holding for
  every epoch swap plus :func:`..core.csp.trace_chain_refines` over the
  whole epoch chain, no ``(chan, epoch, ci)`` record delivered twice, no
  new stage builds on hosts no recovery touched, merged-trace CSP
  conformance, and termination within the virtual-clock budget.

Faults are one half of the dynamic protocol; *load* is the other.
``--workload N`` drives seeded :class:`WorkloadSchedule`\\ s — traffic
spikes, stragglers (a host whose virtual step cost is inflated mid-run),
slow-start hosts — through a deployment scaling itself via
:mod:`.autoscale`, asserting the same §6.1.1 invariants plus convergence:
a bounded number of scaling actions per schedule.

``python -m repro_torch.cluster.sim --seeds 50`` sweeps 50 seeded schedules
(``--device cpu`` off the card); ``--pipe-brick`` runs the mid-``recv``
SIGKILL on the real ``pipe`` transport; ``--kill-controller N``,
``--stall-race N``, ``--coalesce-kill N`` and ``--workload N`` run the
controller-crash, the stall-past-timeout, the kill-during-coalesced-send
and the workload families; ``--serve-kill N`` runs N seeded host kills and
stalls under a live serving engine over the clustered decode farm.
"""

from __future__ import annotations

import argparse
import dataclasses
import queue
import random
import threading
import time
from typing import Optional

import torch

from ..core import csp
from ..core import trace as _trace
from ..core.dataflow import Network, NetworkError
from ..device import resolve_device
from .control import ClusterController
from .partition import abstract_partitioned_model, partition
from .runtime import ClusterError, ExecConfig
from .transport import DEFAULT_CAPACITY, EOS, _QueueTransport

__all__ = [
    "SimClock",
    "SimLivelock",
    "FakeProcess",
    "SimContext",
    "FaultEvent",
    "FaultSchedule",
    "SimTransport",
    "WorkloadPhase",
    "WorkloadSchedule",
    "ScenarioResult",
    "ScenarioRun",
    "drive_scenario",
    "run_scenario",
    "run_workload_scenario",
    "run_pipe_brick_scenario",
    "run_kill_controller_scenario",
    "run_stall_race_scenario",
    "run_coalesce_kill_scenario",
    "run_serve_kill_scenario",
    "main",
]


class SimLivelock(RuntimeError):
    """The virtual clock ran out: some interleaving failed to terminate."""


class SimClock:
    """Virtual time = protocol operations (every transport step, and every
    poll a blocked step spends waiting, ticks once).  A scenario that
    exceeds the budget is livelocked by definition — the bounded-virtual-
    time check, independent of wall-clock speed.  Thread-safe: host threads
    and the controller share one clock."""

    def __init__(self, budget: int = 500_000):
        self.budget = budget
        self.ticks = 0
        self._lock = threading.Lock()

    def tick(self, n: int = 1) -> int:
        with self._lock:
            self.ticks += n
            if self.ticks > self.budget:
                raise SimLivelock(
                    f"virtual clock exceeded {self.budget} ticks — "
                    "the scenario does not terminate")
            return self.ticks


class _SimKilled(BaseException):
    """Raised inside a host thread to simulate SIGKILL: derives from
    BaseException so ``_serve_host``'s ``except Exception`` failure capture
    cannot catch it — a SIGKILLed host reports nothing, ever."""


# thread ident -> FakeProcess, so protocol steps know which host runs them
_thread_host: dict = {}


def _current_fake() -> Optional["FakeProcess"]:
    return _thread_host.get(threading.get_ident())


def _check_killed() -> None:
    p = _current_fake()
    if p is not None and p._kill_flag.is_set():
        raise _SimKilled()


class FakeProcess:
    """Thread-backed stand-in for ``multiprocessing.Process`` with the exact
    API surface the controller touches (start/kill/terminate/join/is_alive/
    exitcode/name/daemon).  ``kill()`` sets a flag the sim queues poll at
    every protocol step: the thread unwinds via :class:`_SimKilled` at its
    next step — "SIGKILL at any protocol step", which is exactly the
    granularity the fault schedule injects at.  Kernels the thread left in
    flight on the card are abandoned, never waited on."""

    def __init__(self, target=None, args=(), name=None, daemon=True):
        self._target = target
        self._args = args
        self.name = name or "sim-host"
        self.daemon = daemon
        self.exitcode: Optional[int] = None
        self._kill_flag = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        def _run():
            _thread_host[threading.get_ident()] = self
            try:
                self._target(*self._args)
                if self.exitcode is None:
                    self.exitcode = 0
            except _SimKilled:
                self.exitcode = -9
            except BaseException:
                self.exitcode = 1
            finally:
                _thread_host.pop(threading.get_ident(), None)

        self._thread = threading.Thread(target=_run, name=self.name,
                                        daemon=self.daemon)
        self._thread.start()

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def kill(self) -> None:
        self._kill_flag.set()

    def terminate(self) -> None:  # SIGTERM ≈ SIGKILL for a fake process
        self._kill_flag.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)


class _KillableQueue(queue.Queue):
    """``queue.Queue`` whose blocking ``get`` polls the calling host's kill
    flag — a killed host parked on its work queue must die there, exactly
    like a SIGKILL lands on a process blocked in ``Queue.get``.  Used for
    the controller's work and result queues (no channel semantics)."""

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            return super().get(False)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            _check_killed()
            try:
                return super().get(True, 0.01)
            except queue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    raise


class SimContext:
    """The ``multiprocessing``-context shim the controller's process-host
    code path runs against: ``Queue`` and ``Process`` only.  Its queues
    are plain objects with no named semaphore, so a durable deployment
    records nothing for an adopter to reclaim."""

    @staticmethod
    def Queue(maxsize: int = 0) -> _KillableQueue:
        return _KillableQueue(maxsize=maxsize)

    @staticmethod
    def Process(target=None, args=(), name=None, daemon=True) -> FakeProcess:
        return FakeProcess(target=target, args=args, name=name, daemon=daemon)


class _SimState:
    """Shared between the parent :class:`SimTransport` and every host
    endpoint: the clock, the schedule, the brick set, and the protocol
    monitor (deliveries + violations)."""

    def __init__(self, schedule: "FaultSchedule", clock: SimClock,
                 rebuildable: bool = True):
        self.schedule = schedule
        self.clock = clock
        self.rebuildable = rebuildable
        self.bricked: set = set()
        self.lock = threading.Lock()
        self.delivered: dict = {}   # chan -> set of (epoch, ci) handed out
        self.violations: list = []  # protocol-invariant breaches, verbatim
        # workload injection (run_workload_scenario): host -> extra virtual
        # ticks per protocol op.  Each extra tick also costs cost_sleep_s
        # of real time, so the wall-clock telemetry the autoscaler polls
        # (items/s, batch wall) sees the inflation too — a straggler is
        # slow on BOTH clocks
        self.host_cost: dict = {}
        self.cost_sleep_s = 0.002

    def record_delivery(self, chan, epoch: int, ci: int) -> None:
        with self.lock:
            seen = self.delivered.setdefault(chan, set())
            if (epoch, ci) in seen:
                self.violations.append(
                    f"duplicate record (epoch={epoch}, ci={ci}) "
                    f"delivered on {chan}")
            seen.add((epoch, ci))


class _SimChannelQueue(queue.Queue):
    """One cut channel's FIFO, with honest SIGKILL semantics: a host whose
    kill flag rises while it is blocked in ``get`` dies *holding the reader
    lock* — the channel bricks, and every later ``get`` (a restarted
    worker, the controller's drain) times out empty, exactly like the real
    mp-queue corpse.  The production protocol code in ``_QueueTransport``
    (epoch drop, duplicate drop, order check, drain, requeue) runs over
    this unmodified."""

    def __init__(self, maxsize: int, chan, sim: _SimState):
        super().__init__(maxsize=maxsize)
        self._chan = chan
        self._sim = sim

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            return super().get(False)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._sim.clock.tick()
            p = _current_fake()
            if p is not None and p._kill_flag.is_set():
                # killed while blocked reading: the corpse keeps the
                # reader lock — the FIFO bricks
                with self._sim.lock:
                    self._sim.bricked.add(self._chan)
                raise _SimKilled()
            if self._chan in self._sim.bricked:
                raise queue.Empty  # dead reader lock: reads time out empty
            try:
                return super().get(True, 0.005)
            except queue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    raise

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None):
        if not block:
            return super().put(item, False)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._sim.clock.tick()
            _check_killed()
            try:
                return super().put(item, True, 0.005)
            except queue.Full:
                if deadline is not None and time.monotonic() >= deadline:
                    raise


@dataclasses.dataclass
class FaultEvent:
    """One injected fault: fire ``action`` when ``host`` performs its
    ``at``-th operation of kind ``op`` (counted after arming), at or above
    plan epoch ``min_epoch`` (>= 2 models a kill *during recovery*).  Host
    ops (``recv``/``send``/``park``/``snap``) fire in the host's own
    thread; controller ops (``drain``/``requeue``/``epoch``) fire while the
    controller runs that recovery step, setting the victim's kill flag
    asynchronously — a host dying between ``drain()`` and ``requeue()`` or
    during the epoch bump."""

    host: int
    op: str          # "recv" | "send" | "park" | "snap" | "drain" | ...
    at: int          # fire on the at-th matching op (0-based, post-arming)
    action: str      # "kill" | "stall"
    min_epoch: int = 1
    brick: bool = True   # a kill mid-recv bricks the channel's FIFO
    stall_s: float = 0.0  # stall duration; > timeout_s pins controller races
    fired: bool = dataclasses.field(default=False, compare=False)
    # time.monotonic() when it fired: the start of a kill -> recovered wall
    fired_at: Optional[float] = dataclasses.field(default=None,
                                                  compare=False)


_HOST_OPS = ("recv", "send")
_CTRL_OPS = ("drain", "requeue", "epoch")


class FaultSchedule:
    """A seeded, deterministic set of :class:`FaultEvent`\\ s plus the
    per-``(host, op)`` counters that decide when each fires.  Disarmed
    until :meth:`arm` so a scenario's cold batch establishes the warm
    baseline first; counters reset at arming, making ``at`` deterministic
    regardless of how many protocol steps the cold batch took."""

    kind = "fixed"

    def __init__(self, events: list):
        self.events = list(events)
        self.armed = False
        self._counts: dict = {}
        self._lock = threading.Lock()

    def arm(self) -> None:
        self._counts = {}
        self.armed = True

    def fire(self, host: int, op: str, epoch: int) -> Optional[FaultEvent]:
        """The action (if any) scheduled for ``host``'s next ``op``."""
        if not self.armed:
            return None
        with self._lock:
            k = (host, op)
            n = self._counts.get(k, 0)
            self._counts[k] = n + 1
            for ev in self.events:
                if (not ev.fired and ev.host == host and ev.op == op
                        and ev.at == n and epoch >= ev.min_epoch):
                    ev.fired, ev.fired_at = True, time.monotonic()
                    return ev
        return None

    def fire_ctrl(self, op: str, epoch: int) -> list:
        """Events triggered by the controller's ``op``-th recovery step;
        returns the victims' host ids (their kill flags rise while the
        controller is mid-``drain``/``requeue``/epoch-bump)."""
        if not self.armed:
            return []
        victims = []
        with self._lock:
            n = self._counts.get(("ctrl", op), 0)
            self._counts[("ctrl", op)] = n + 1
            for ev in self.events:
                if (not ev.fired and ev.op == op and ev.action == "kill"
                        and ev.at == n and epoch >= ev.min_epoch):
                    ev.fired, ev.fired_at = True, time.monotonic()
                    victims.append(ev.host)
        return victims

    def describe(self) -> str:
        return ", ".join(
            f"{ev.action} host {ev.host} at {ev.op}#{ev.at}"
            + (f" epoch>={ev.min_epoch}" if ev.min_epoch > 1 else "")
            + ("" if ev.brick or ev.op != "recv" or ev.action != "kill"
               else " [no-brick]")
            for ev in self.events) or "(no faults)"

    @staticmethod
    def random(rng: random.Random, plan) -> "FaultSchedule":
        """One of five scenario kinds — kill, stall, double-kill,
        kill-during-recovery, controller-step kill — at a random protocol
        step of a random host.  Topology-aware: a ``recv`` fault targets a
        host that actually has ingress, a ``send`` fault one with egress,
        so schedules overwhelmingly *fire* instead of naming steps the
        victim never takes.  The draws are the JAX package's, in its order:
        the same ``random.Random`` state and plan give the same schedule."""
        hosts = plan.hosts()
        can = {"park": set(hosts),
               "recv": {plan.assignment[c.dst] for c in plan.cut},
               "send": {plan.assignment[c.src] for c in plan.cut}}

        def host_kill(min_epoch=1, exclude=None) -> FaultEvent:
            op = rng.choice(("recv", "recv", "send", "park"))
            cands = sorted(can[op] - {exclude}) or sorted(
                can["park"] - {exclude}) or list(hosts)
            if not can[op] & set(cands):
                op = "park"
            return FaultEvent(
                host=rng.choice(cands), op=op, action="kill",
                at=rng.randrange(4) if op in _HOST_OPS else rng.randrange(2),
                min_epoch=min_epoch, brick=rng.random() < 0.7)

        kind = rng.choice(("kill", "stall", "double-kill",
                           "kill-during-recovery", "ctrl-step-kill"))
        if kind == "stall":
            ev = host_kill()
            ev.action = "stall"  # same targeted step, benign action
            events = [ev]
        elif kind == "double-kill":
            first = host_kill()
            events = [first, host_kill(exclude=first.host)]
        elif kind == "kill-during-recovery":
            events = [host_kill(), host_kill(min_epoch=2)]
        elif kind == "ctrl-step-kill":
            # the first kill provokes the recovery whose drain/requeue/epoch
            # step then kills a second host mid-recovery
            first = host_kill()
            events = [first, FaultEvent(
                host=rng.choice([h for h in hosts if h != first.host]
                                or list(hosts)),
                op=rng.choice(_CTRL_OPS), at=rng.randrange(2),
                action="kill")]
        else:
            events = [host_kill()]
        sched = FaultSchedule(events)
        sched.kind = kind
        return sched


@dataclasses.dataclass
class WorkloadPhase:
    """One traffic regime: from batch ``batch`` (0-based, inclusive)
    onward, batches carry ``instances`` items and each host in
    ``host_cost`` pays that many extra virtual ticks (plus proportional
    real time) per protocol op."""

    batch: int
    instances: int
    host_cost: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class WorkloadSchedule:
    """A seeded, deterministic *load* schedule — the workload counterpart
    of :class:`FaultSchedule`.  Three kinds:

    * ``spike`` — traffic jumps mid-run while every host pays a constant
      per-op service cost, so batch wall crosses the policy's latency
      target and the deployment must scale OUT;
    * ``straggler`` — one host's virtual step cost is inflated mid-run;
      its items/s collapses relative to its peers and the policy must
      evacuate it (a migration replan, not a new host);
    * ``slow-start`` — a host is slow only for its first batches, then
      warms up; sustained-signal hysteresis must reject the transient
      (the no-flapping obligation: zero scaling actions)."""

    kind: str            # "spike" | "straggler" | "slow-start"
    phases: list         # WorkloadPhase, ascending by batch
    victim: Optional[int] = None   # the inflated host (straggler kinds)

    def phase_for(self, batch: int) -> WorkloadPhase:
        cur = self.phases[0]
        for ph in self.phases:
            if ph.batch <= batch:
                cur = ph
        return cur

    def describe(self) -> str:
        bits = []
        for ph in self.phases:
            cost = ", ".join(f"host {h}+{c}"
                             for h, c in sorted(ph.host_cost.items()))
            bits.append(f"batch>={ph.batch}: {ph.instances} items"
                        + (f" [{cost}]" if cost else ""))
        return f"{self.kind}: " + "; ".join(bits)

    @staticmethod
    def random(rng: random.Random, plan,
               kind: Optional[str] = None) -> "WorkloadSchedule":
        """Seeded schedule over ``plan``'s hosts, drawn in the JAX
        package's order (the same seed and plan give the same schedule).
        The straggler victim is always a host holding plain workers
        (ingress AND egress, neither the Emit's nor the Collect's host):
        inflating a pure middle host makes its items/s the unambiguous
        minimum, so the policy's slowest-host pick is deterministic."""
        hosts = plan.hosts()
        kind = kind or rng.choice(("spike", "straggler", "slow-start"))
        if kind == "spike":
            base, mult = rng.choice((4, 6)), 4
            at = rng.choice((2, 3))
            cost = {h: 2 for h in hosts}
            return WorkloadSchedule(kind, [
                WorkloadPhase(0, base, dict(cost)),
                WorkloadPhase(at, base * mult, dict(cost))])
        ingress = {plan.assignment[c.dst] for c in plan.cut}
        egress = {plan.assignment[c.src] for c in plan.cut}
        ends = {plan.assignment[e.name] for e in plan.net.emits()}
        ends |= {h for h in hosts
                 if any(p.startswith("collect")
                        for p in plan.procs_of(h))}
        middles = sorted((ingress & egress) - ends) or sorted(
            ingress - ends) or sorted(ingress)
        victim = rng.choice(middles)
        n = 8
        inflate = {victim: rng.choice((8, 10))}
        if kind == "straggler":
            at = rng.choice((1, 2))
            phases = [WorkloadPhase(0, n), WorkloadPhase(at, n, inflate)]
        else:  # slow-start: slow out of the gate, warm by batch 2
            phases = [WorkloadPhase(0, n, inflate), WorkloadPhase(2, n)]
        return WorkloadSchedule(kind, phases, victim=victim)


class _SimOps:
    """Fault hooks layered over the plain queue transport, shared by the
    parent transport and the per-host endpoints."""

    _sim: _SimState
    _host: Optional[int] = None  # None: the controller's own handle
    recv_timeout_s = 8.0  # virtualised: no need to burn the real 120 s

    def _step(self, op: str) -> None:
        """One protocol step: tick virtual time, die if killed, then fire
        whatever fault the schedule booked for this exact step."""
        self._sim.clock.tick()
        _check_killed()
        if self._host is None:
            return
        extra = self._sim.host_cost.get(self._host, 0)
        if extra:
            # inflated virtual step cost (straggler / slow-start / global
            # service cost): pay it in virtual ticks AND in real time
            self._sim.clock.tick(extra)
            time.sleep(extra * self._sim.cost_sleep_s)
        ev = self._sim.schedule.fire(self._host, op, self.epoch)
        if ev is None:
            return
        if ev.action == "stall":
            self._sim.clock.tick(5)
            time.sleep(ev.stall_s or 0.05)
            return
        p = _current_fake()  # kill: this host dies HERE
        if p is not None:
            p.kill()
        if op == "recv" and ev.brick:
            # don't raise yet: fall through into the FIFO ``get`` so the
            # host dies INSIDE it, holding the reader lock — the channel
            # bricks (``_SimChannelQueue.get`` notices the flag and marks
            # it), exactly like a SIGKILL landing mid-``recv``
            return
        raise _SimKilled()

    def snapshot_step(self, ci: int) -> None:
        """Fault hook the executor calls INSIDE ``_save_snapshot`` — after
        capturing the fold state, before the durable write.  A ``snap``
        kill here is death mid-snapshot-write: the latest on-disk snapshot
        stays the previous complete one, which recovery must fall back
        to."""
        self._step("snap")

    def send(self, chan, ci: int, value) -> None:
        self._step("send")
        super().send(chan, ci, value)

    def recv(self, chan, ci: int):
        self._step("recv")
        got = super().recv(chan, ci)
        if ci >= 0 and not (isinstance(got, str) and got == EOS):
            self._sim.record_delivery(chan, self.epoch, ci)
        return got


class _SimEndpoint(_SimOps, _QueueTransport):
    """One host's handle.  Like a spawned process it SNAPSHOTS the queue
    map at spawn time, so a channel the controller rebuilds is invisible
    here — exercising the force-restart obligation for real.  Setting
    ``epoch`` (the host picking a batch descriptor up) is the ``park``
    injection point.  ``device`` is the host's own, set by the host entry
    once its executor is built; records cross unpacked (the hosts share
    this process), so tensors stay where their producer made them."""

    name = "sim"
    process_hosts = True
    _epoch = 1

    def __init__(self, host: int, queues: dict, sim: _SimState):
        super().__init__()
        self._queues = dict(queues)  # snapshot, like a pickled endpoint
        self._host = host
        self._sim = sim
        self.device = None

    @property
    def epoch(self) -> int:
        return self._epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        # same obligation as the production endpoints: records coalesced
        # under the OLD epoch must not be stamped with the new one — flush
        # (best-effort; the consumer may already be gone) before the bump
        if value != self._epoch and getattr(self, "_send_pending", None):
            self.flush_sends(best_effort=True)
        self._epoch = value
        self._step("park")


class SimTransport(_SimOps, _QueueTransport):
    """The full ChannelTransport interface, in-process and fault-injected.

    ``process_hosts`` is True and ``ctx`` is a :class:`SimContext`, so the
    controller drives its *spawned-process* code path — work/result queues
    from ``ctx.Queue()``, hosts from ``ctx.Process`` (thread-backed
    :class:`FakeProcess`), dead-host detection via ``is_alive`` strikes —
    against deterministic, virtually-clocked channels."""

    name = "sim"
    process_hosts = True

    def __init__(self, schedule: Optional[FaultSchedule] = None,
                 clock: Optional[SimClock] = None, rebuildable: bool = True):
        super().__init__()
        self.ctx = SimContext()
        self._sim = _SimState(schedule or FaultSchedule([]),
                              clock or SimClock(), rebuildable)
        self._victims: dict = {}

    def track_hosts(self, procs: dict) -> None:
        """Give controller-step faults a route to their victims: ``procs``
        is the controller's live ``{host: FakeProcess}`` map (shared)."""
        self._victims = procs

    def _ctrl_step(self, op: str) -> None:
        self._sim.clock.tick()
        for h in self._sim.schedule.fire_ctrl(op, self.epoch):
            victim = self._victims.get(h)
            if victim is not None:
                victim.kill()

    def _new_queue(self, chan, capacities):
        cap = capacities.get(chan, 0) or DEFAULT_CAPACITY
        return _SimChannelQueue(cap, chan, self._sim)

    def endpoint(self, host: int) -> _SimEndpoint:
        ep = _SimEndpoint(host, self._queues, self._sim)
        ep.recv_timeout_s = self.recv_timeout_s  # keep any override
        ep.coalesce_bytes = self.coalesce_bytes
        return ep

    def set_epoch(self, epoch: int) -> None:
        self._ctrl_step("epoch")
        super().set_epoch(epoch)

    def drain(self, channels=None, *, keep=frozenset()) -> dict:
        self._ctrl_step("drain")
        return super().drain(channels, keep=keep)

    def requeue(self, chan, records) -> int:
        self._ctrl_step("requeue")
        return super().requeue(chan, records)

    def bricked_channels(self, channels=None) -> set:
        probe = set(self._queues if channels is None else channels)
        return probe & self._sim.bricked

    def rebuild_channel(self, chan) -> bool:
        if chan not in self._queues or not self._sim.rebuildable:
            return False
        self._queues[chan] = self._new_queue(chan, self._caps)
        with self._sim.lock:
            self._sim.bricked.discard(chan)
        return True

    def forget_channel(self, chan) -> None:
        """A forgotten (then reconfigure-recreated) FIFO is a NEW queue:
        the corpse's reader lock dies with the old object, so the brick
        marker goes too — matching the real transports, where the brick is
        a property of the abandoned queue, not of the channel name."""
        self._queues.pop(chan, None)
        with self._sim.lock:
            self._sim.bricked.discard(chan)

    # -- monitor surface for scenario assertions ---------------------------
    def begin_stream(self) -> None:
        """Reset the duplicate-delivery monitor at a batch boundary: a NEW
        batch at an unchanged epoch legitimately reuses every ``(epoch,
        ci)``; within one batch (and all its recovery replays, each under a
        bumped epoch) they must be unique per channel."""
        with self._sim.lock:
            self._sim.delivered = {}

    @property
    def violations(self) -> list:
        return self._sim.violations

    @property
    def clock(self) -> SimClock:
        return self._sim.clock


# ==========================================================================
# Scenario networks (module-level: the controller requires a factory for
# process-host transports, and the real-pipe scenario pickles these into
# spawned interpreters).  Sums of integer-valued float32 scalars: exact in
# every mode and on every device.
# ==========================================================================

def sim_farm(n: int, workers: int) -> Network:
    from ..core import DataParallelCollect
    return DataParallelCollect(
        create=lambda i: torch.tensor(float(i)),
        function=lambda x: x * x + 1.0,
        collector=lambda a, x: a + x, init=torch.tensor(0.0),
        workers=workers, jit_combine=True)


def sim_pipeline(n: int) -> Network:
    from ..core import OnePipelineCollect
    return OnePipelineCollect(
        create=lambda i: torch.tensor(float(i)),
        stage_ops=[lambda x: x * x, lambda x: x + 1.0],
        collector=lambda a, x: a + x, init=torch.tensor(0.0),
        jit_combine=True)


def sim_workload_pipeline(n: int) -> Network:
    """Four-stage pipeline for the workload scenarios: six processes
    (emit, stage0..stage3, collect) that :func:`partition` spreads over
    2-4 hosts, so a traffic spike can genuinely scale OUT and a straggler
    holding a middle stage can be evacuated without touching the ends.
    (The farm is no use here: DataParallelCollect fuses its workers into
    one process, which pins the whole farm to two hosts.)"""
    from ..core import OnePipelineCollect
    return OnePipelineCollect(
        create=lambda i: torch.tensor(float(i)),
        stage_ops=[lambda x: x * x, lambda x: x + 1.0,
                   lambda x: x * 2.0, lambda x: x - 3.0],
        collector=lambda a, x: a + x, init=torch.tensor(0.0),
        jit_combine=True)


def slow_emit_farm(n: int, workers: int, emit_delay_s: float) -> Network:
    """Farm whose Emit ``create`` sleeps per item (host-side, per batch):
    holds the consumer host blocked mid-``recv`` long enough for a SIGKILL
    to land while it owns the FIFO's reader lock — the bricked-ingress
    reproduction, made deterministic."""
    from ..core import DataParallelCollect

    def create(i):
        time.sleep(emit_delay_s)
        return torch.tensor(float(i))

    return DataParallelCollect(
        create=create, function=lambda x: x * x,
        collector=lambda a, x: a + x, init=torch.tensor(0.0),
        workers=workers, jit_combine=True)


def _cfg_device(device) -> Optional[str]:
    """The hosts' device for :class:`ExecConfig`: resolved here first, so
    a scenario without a GPU raises before it builds anything."""
    resolve_device(device)
    return None if device is None else str(device)


# ==========================================================================
# Scenario runner
# ==========================================================================

@dataclasses.dataclass
class ScenarioResult:
    seed: int
    kind: str
    topology: str
    hosts: int
    schedule: str
    fired: int            # fault events that actually fired
    recoveries: int       # epoch bumps the scenario needed
    ticks: int            # virtual time consumed
    failures: list        # invariant breaches ([] = scenario green)

    @property
    def ok(self) -> bool:
        return not self.failures

    def describe(self) -> str:
        state = "ok" if self.ok else "FAIL"
        line = (f"seed {self.seed:>4} [{state}] {self.kind:<21} "
                f"{self.topology}/{self.hosts}h  fired={self.fired} "
                f"recoveries={self.recoveries} ticks={self.ticks}  "
                f"[{self.schedule}]")
        for f in self.failures:
            line += f"\n      ! {f}"
        return line


def _run_with_recovery(ctrl: ClusterController, instances: int,
                       mode: str, max_attempts: int = 6, plans=None):
    """One batch through the controller, recovering as many times as the
    schedule demands (a replay can itself be killed).  Returns the
    completed batch result.  ``plans`` (when given) collects ``ctrl.plan``
    once per recovery that bumped the epoch — INCLUDING failed replays, so
    the §6.1.1 chain check sees every intermediate epoch's plan, not N
    copies of the final one."""
    try:
        return ctrl.run_batch(instances)
    except ClusterError:
        pass
    for _ in range(max_attempts):
        try:
            out = ctrl.recover(mode=mode)
        except ClusterError:
            # the recover bumped the epoch and appended its event before
            # the replay failed: record that epoch's plan too
            if plans is not None:
                plans.append(ctrl.plan)
            continue
        except NetworkError as e:
            if ("every host failed" in str(e)
                    and "cannot be recovered" not in str(e)):
                mode = "restart"  # nobody left to rebalance onto: the
                continue          # operator's next move is a plain restart
            raise               # (no epoch bump, no event: no plan either)
        if plans is not None:
            plans.append(ctrl.plan)
        try:
            return out if out is not None else ctrl.run_batch(instances)
        except ClusterError:
            continue
    raise SimLivelock(
        f"scenario did not recover within {max_attempts} attempts")


def _topology_draw(rng: random.Random):
    """A scenario's network and plan, drawn in the JAX package's order:
    topology, farm width, host count."""
    topology = rng.choice(("farm", "pipeline"))
    instances = 8
    if topology == "farm":
        factory = (sim_farm, (instances, rng.choice((2, 3))))
    else:
        factory = (sim_pipeline, (instances,))
    net = factory[0](*factory[1])
    plan = partition(net, hosts=rng.choice((2, 3)))
    return topology, instances, factory, net, plan


def _draw(seed: int):
    """What a seed fixes for :func:`run_scenario`, drawn in the JAX
    package's order: topology, network factory, plan, fault schedule,
    recovery mode and brick rebuildability."""
    rng = random.Random(seed)
    topology, _, factory, net, plan = _topology_draw(rng)
    schedule = FaultSchedule.random(rng, plan)
    mode = rng.choice(("restart", "rebalance"))
    rebuildable = rng.random() < 0.7
    return topology, factory, net, plan, schedule, mode, rebuildable


@dataclasses.dataclass
class ScenarioRun:
    """What :func:`drive_scenario` leaves its caller: the invariant
    breaches, the completed batches with the monotonic time each began and
    returned, the controller's recovery events, whether recovery was
    honestly refused, and the virtual time consumed."""

    failures: list
    outs: list
    spans: list           # (start, end) monotonic seconds, per batch
    events: list          # RecoveryEvent per epoch bump
    refused: bool
    ticks: int


def drive_scenario(net: Network, factory: tuple, plan, schedule,
                   mode: str, *, instances: int, check,
                   rebuildable: bool = True, batches: int = 3,
                   microbatch_size: int = 2, timeout_s: float = 60.0,
                   clock_budget: int = 500_000,
                   device=None) -> ScenarioRun:
    """One fault schedule against ``net`` deployed on ``plan`` over
    simulated process hosts, asserting every §6.1.1 invariant: a cold
    batch, then the schedule armed, then ``batches - 1`` batches each
    recovered (``mode``) as often as the faults demand.  ``check(out)``
    describes how a completed batch differs from the sequential oracle
    (``None``: equal).  The run is traced under per-host counting clocks
    and the merged trace must lie in the unpartitioned model's trace set.
    The hosts run on ``device``
    (``None``: the card)."""
    cfg_dev = _cfg_device(device)
    clock = SimClock(clock_budget)
    transport = SimTransport(schedule, clock, rebuildable=rebuildable)
    # a traced scenario runs on per-host counting clocks: the merged trace
    # is deterministic, and the CSP conformance projection below checks
    # the OBSERVED run — faults, replays and all — against the model
    _trace.configure(clock="counting")
    ctrl = ClusterController(net, plan,
                             ExecConfig(microbatch_size=microbatch_size,
                                        trace=True, device=cfg_dev),
                             transport, factory, timeout_s)
    ctrl.poll_s = 0.05
    failures: list = []
    epoch_plans = [plan]
    outs: list = []
    spans: list = []
    refused = False

    def batch():
        t0 = time.monotonic()
        outs.append(_run_with_recovery(ctrl, instances, mode,
                                       plans=epoch_plans))
        spans.append((t0, time.monotonic()))

    try:
        ctrl.start()
        transport.track_hosts(ctrl._procs)
        batch()  # cold batch first (warm baseline), then arm the schedule
        schedule.arm()
        for _ in range(batches - 1):
            n_ev = len(ctrl.events)
            transport.begin_stream()
            batch()
            for ev in ctrl.events[n_ev:]:
                if ev.refined is not True:
                    failures.append(
                        f"epoch {ev.epoch_to}: check_redeployment failed")
    except NetworkError as e:
        if "cannot be recovered" in str(e):
            # an HONEST refusal terminates the scenario cleanly: the brick
            # was unrebuildable and every host died — recovery is
            # impossible by construction, and saying so (instead of
            # looping or hanging) is the required behaviour.  Completed
            # batches still face every invariant below.
            refused = True
        else:
            failures.append(f"{type(e).__name__}: {e}")
    except (SimLivelock, RuntimeError) as e:
        failures.append(f"{type(e).__name__}: {e}")
    finally:
        merged = ctrl.merged_trace()
        try:
            ctrl.close()
        except Exception:
            pass
        _trace.configure(clock=None)

    for i, out in enumerate(outs):
        diff = check(out)
        if diff is not None:
            failures.append(f"batch {i}: {diff}")
    _protocol_invariants(net, merged, outs, transport, ctrl.events,
                         epoch_plans, failures, ("recovery", "recoveries"))
    return ScenarioRun(failures, outs, spans, list(ctrl.events), refused,
                       clock.ticks)


def _protocol_invariants(net, merged, outs, transport, events, epoch_plans,
                         failures, noun) -> None:
    """The §6.1.1 invariants of a finished scenario, appended to
    ``failures``: the merged trace conforms, no record was delivered twice,
    no host that no epoch bump touched built a stage after the first
    batch, and the chain of ``epoch_plans`` (one a bump) refines.  ``outs``
    are the completed batches' results; ``noun`` names an epoch bump
    (singular, plural) in the messages."""
    if outs:
        # trace conformance (§6.1.1, dynamically): the merged multi-host
        # trace — survivors' pre-stall events shipped with their error
        # payloads, replayed chunks re-recorded by restarted hosts —
        # projects onto the CSP event alphabet and must be a trace of the
        # unpartitioned model.  Only meaningful once a batch completed.
        try:
            conf = _trace.check_conformance(net, merged)
            if not conf.ok:
                failures.append(f"trace conformance: {conf.detail} "
                                f"(coverage {conf.coverage:.2f})")
        except NetworkError as e:
            failures.append(f"trace conformance: {e}")
    failures.extend(transport.violations)  # duplicate (epoch, ci) records
    touched = {h for ev in events
               for h in (*ev.restarted, *ev.dead, *ev.erred)}
    for out in outs[1:]:
        for r in out.reports:
            if r.host not in touched and r.ok and r.jit_builds:
                failures.append(
                    f"host {r.host} untouched by any {noun[0]} but built "
                    f"{r.jit_builds} new stages")
    if len(epoch_plans) != 1 + len(events) and not failures:
        failures.append(  # harness self-check: one plan per epoch bump
            f"epoch plan capture misaligned: {len(epoch_plans)} plans "
            f"for {len(events)} {noun[1]}")
    if len(epoch_plans) > 1:
        models = [abstract_partitioned_model(net, p, name=f"epoch{i + 1}")
                  for i, p in enumerate(epoch_plans)]
        if not csp.trace_chain_refines(net, models, instances=3):
            failures.append(
                "trace_chain_refines failed over the epoch chain")


def run_scenario(seed: int, *, batches: int = 3,
                 clock_budget: int = 500_000,
                 timeout_s: float = 60.0, device=None) -> ScenarioResult:
    """One seeded fault scenario end to end, asserting every §6.1.1
    invariant (:func:`drive_scenario`).  Deterministic in the schedule:
    the seed fixes the topology, host count, fault kind, injection points,
    recovery mode and brick rebuildability.  The hosts and the oracle run
    on ``device`` (``None``: the card)."""
    from ..core import run_sequential

    _cfg_device(device)
    topology, factory, net, plan, schedule, mode, rebuildable = _draw(seed)
    instances = 8
    oracle = float(run_sequential(net, instances, device=device)["collect"])

    def check(out):
        got = float(out["collect"])
        return (None if got == oracle
                else f"result {got} != sequential oracle {oracle}")

    run = drive_scenario(net, factory, plan, schedule, mode,
                         instances=instances, check=check,
                         rebuildable=rebuildable, batches=batches,
                         timeout_s=timeout_s, clock_budget=clock_budget,
                         device=device)
    return ScenarioResult(
        seed=seed, kind=schedule.kind + ("/refused" if run.refused else ""),
        topology=topology,
        hosts=len(plan.hosts()), schedule=schedule.describe(),
        fired=sum(ev.fired for ev in schedule.events),
        recoveries=len(run.events), ticks=run.ticks,
        failures=run.failures)


# ==========================================================================
# Workload scenarios: the autoscaler under seeded load schedules
# ==========================================================================

_WORKLOAD_KINDS = ("spike", "straggler", "slow-start")


def run_workload_scenario(seed: int, *, kind: Optional[str] = None,
                          batches: int = 6,
                          clock_budget: int = 800_000,
                          timeout_s: float = 60.0,
                          device=None) -> ScenarioResult:
    """One seeded *workload* schedule against an autoscaling deployment —
    the scaling counterpart of :func:`run_scenario`'s fault schedules.

    A :class:`WorkloadSchedule` (``seed % 3`` picks spike / straggler /
    slow-start unless ``kind`` pins it) drives per-batch traffic levels
    and per-host virtual step-cost inflation through a deployment built
    with ``autoscale=``; the policy polls between batches and resizes the
    plan through ``reconfigure`` — every action an epoch bump with the
    §6.1.1 re-proof, never a restart.  The hosts and the oracle run on
    ``device`` (``None``: the card).  Asserted invariants:

    * every batch bit-identical to the sequential oracle for its traffic
      level (across however many replans the policy executed);
    * no ``(chan, epoch, ci)`` record delivered twice within a batch;
    * merged-trace CSP conformance, and ``trace_chain_refines`` over the
      whole epoch chain of plans;
    * every reconfigure event ``refined is True``;
    * convergence / no flapping: executed actions bounded (≤ 2), total
      epoch bumps bounded (≤ 3), and kind-specific liveness — a spike
      must scale out, a straggler must be evacuated by a migration, a
      slow-start transient must cause NO action at all;
    * termination within the virtual-clock budget."""
    from ..core import run_sequential
    from .autoscale import AutoscalePolicy
    from .deploy import ClusterDeployment

    cfg_dev = _cfg_device(device)
    rng = random.Random(seed)
    kind = kind or _WORKLOAD_KINDS[seed % len(_WORKLOAD_KINDS)]
    hosts = 2 if kind == "spike" else 3
    factory = (sim_workload_pipeline, (8,))
    net = factory[0](*factory[1])
    plan = partition(net, hosts=hosts)
    schedule = WorkloadSchedule.random(rng, plan, kind)
    clock = SimClock(clock_budget)
    transport = SimTransport(FaultSchedule([]), clock, rebuildable=True)

    oracles: dict = {}

    def oracle(n: int) -> float:
        if n not in oracles:
            oracles[n] = float(
                run_sequential(net, n, device=device)["collect"])
        return oracles[n]

    if kind == "spike":
        # start with every pressure signal off; the latency target is
        # calibrated below from the measured warm baseline (an operator
        # would configure an SLO — the sim derives one)
        policy = AutoscalePolicy(
            high_occupancy=1.01, high_stall_rate=1e9,
            imbalance_ratio=1e9, sustain=1, cooldown=1,
            min_hosts=hosts, max_hosts=hosts + 1)
    else:
        # imbalance is the signal under test: ratio 1.7 because bounded
        # channels throttle the whole pipeline to the straggler's pace
        # (the fastest host is the one UPSTREAM of the straggler, ~2x),
        # and min_batch_wall_s gates out healthy sub-millisecond batches
        # whose per-host rates are pure noise
        policy = AutoscalePolicy(
            high_occupancy=1.01, high_stall_rate=1e9,
            imbalance_ratio=1.7, min_batch_wall_s=0.05,
            sustain=(4 if kind == "slow-start" else 2), cooldown=2,
            min_hosts=hosts - 1, max_hosts=hosts)

    _trace.configure(clock="counting")
    dep = ClusterDeployment(net, plan=plan, transport=transport,
                            microbatch_size=2, factory=factory,
                            timeout_s=timeout_s, trace=True,
                            autoscale=policy, device=cfg_dev)
    ctrl = dep.controller
    ctrl.poll_s = 0.05
    state = transport._sim
    failures: list = []
    epoch_plans = [plan]
    outs: list = []
    walls: list = []  # the slowest host's wall, batch by batch
    try:
        dep.start()
        transport.track_hosts(ctrl._procs)
        for b in range(batches):
            ph = schedule.phase_for(b)
            state.host_cost = dict(ph.host_cost)
            transport.begin_stream()
            out = dep.run(instances=ph.instances)
            outs.append((b, ph.instances, out))
            walls.append(max(dep.metrics().batch_wall_s.values(),
                             default=0.0))
            while len(epoch_plans) < 1 + len(ctrl.events):
                epoch_plans.append(ctrl.plan)
            if kind == "spike" and b == 1:
                # baseline measured: target = 2.5x the slowest host's
                # batch wall at the base traffic, the lesser of batches 0
                # and 1 (one batch's wall alone can carry a neighbour's
                # burst on a shared host and lift the target past the
                # spike).  The 4x traffic spike crosses it; the
                # post-scale-out wall must not re-cross from BELOW
                # (hysteresis), bounding the action count
                policy.high_batch_wall_s = 2.5 * min(walls)
    except (ClusterError, NetworkError, SimLivelock, RuntimeError) as e:
        failures.append(f"{type(e).__name__}: {e}")
    finally:
        merged = ctrl.merged_trace()
        try:
            dep.close()
        except Exception:
            pass
        _trace.configure(clock=None)

    # -- §6.1.1 invariants -------------------------------------------------
    for b, n, out in outs:
        got = float(out["collect"])
        if got != oracle(n):
            failures.append(
                f"batch {b} ({n} items): result {got} != sequential "
                f"oracle {oracle(n)}")
    for ev in ctrl.events:
        if ev.refined is not True:
            failures.append(
                f"epoch {ev.epoch_to}: check_redeployment failed")
    _protocol_invariants(net, merged, [out for _, _, out in outs],
                         transport, ctrl.events, epoch_plans, failures,
                         ("replan", "replans"))

    # -- convergence: bounded actions + kind-specific liveness -------------
    scaler = dep.autoscaler
    executed = scaler.actions
    if len(executed) > 2:
        failures.append(
            f"flapping: {len(executed)} executed scaling actions "
            "(want <= 2): "
            + "; ".join(e.describe() for e in executed))
    if len(ctrl.events) > 3:
        failures.append(
            f"flapping: {len(ctrl.events)} epoch bumps (want <= 3)")
    if kind == "spike":
        if not any(e.action == "add_host" for e in executed):
            failures.append(
                f"spike never scaled out (slowest host's batch walls "
                f"{[round(w, 4) for w in walls]} s, target "
                f"{policy.high_batch_wall_s} s)")
        elif len(ctrl.plan.hosts()) <= hosts:
            failures.append(
                f"spike scaled out but the final plan still has "
                f"{len(ctrl.plan.hosts())} hosts")
    elif kind == "straggler":
        if not any(e.action == "migrate" for e in executed):
            failures.append("straggler never evacuated")
        elif schedule.victim in ctrl.plan.hosts():
            failures.append(
                f"straggler host {schedule.victim} still owns processes "
                f"after the migration")
    else:  # slow-start
        if executed:
            failures.append(
                "slow-start transient caused scaling actions (hysteresis "
                "must reject it): "
                + "; ".join(e.describe() for e in executed))
    return ScenarioResult(
        seed=seed, kind=f"workload/{kind}", topology="pipeline",
        hosts=hosts,
        schedule=schedule.describe(),
        fired=len(scaler.events),
        recoveries=len(ctrl.events), ticks=clock.ticks, failures=failures)


# ==========================================================================
# The real-pipe bricked-ingress reproduction
# ==========================================================================

def run_pipe_brick_scenario(timeout_s: float = 30.0, verbose: bool = False,
                            device=None) -> ScenarioResult:
    """SIGKILL a real ``pipe`` host while it is blocked mid-``recv`` on a
    cut channel — the corpse dies holding the mp queue's reader lock, so
    the restarted worker and every later drain would read empty forever.
    ``recover()`` must detect the dead-reader lock
    (:meth:`ChannelTransport.bricked_channels`), rebuild the FIFO,
    force-restart the live producer still holding an endpoint onto the
    abandoned queue, and replay bit-identically.  The spawned hosts run on
    ``device`` (``None``: the card, each with its own CUDA context)."""
    from ..core import run_sequential
    from .deploy import ClusterDeployment

    _cfg_device(device)
    instances, workers, delay = 8, 2, 0.12
    factory = (slow_emit_farm, (instances, workers, delay))
    net = factory[0](*factory[1])
    oracle = float(run_sequential(net, instances, device=device)["collect"])
    plan = partition(net, hosts=2)
    victim = plan.assignment["collect"]       # the consumer host
    producer = next(h for h in plan.hosts() if h != victim)
    failures: list = []
    events: list = []
    dep = ClusterDeployment(net, plan=plan, transport="pipe",
                            microbatch_size=2, factory=factory,
                            timeout_s=timeout_s, device=device)
    dep.controller.poll_s = 0.2
    dep.transport.recv_timeout_s = timeout_s  # don't out-wait the clock:
    # set BEFORE start() so the spawned endpoints inherit the override
    with dep:
        cold = dep.run(instances=instances)
        if float(cold["collect"]) != oracle:
            failures.append("cold batch diverged from the oracle")
        # warm batch: the slow Emit holds the consumer in recv for
        # ~instances*delay seconds; kill it in that window so the corpse
        # dies holding the ingress FIFO's reader lock
        killer = threading.Timer(0.35, dep.kill_host, args=(victim,))
        killer.start()
        try:
            dep.run(instances=instances)
            failures.append("killed batch unexpectedly succeeded")
        except ClusterError:
            pass
        finally:
            killer.join()
        rec = dep.recover()
        events = list(dep.events)
        got = float(rec["collect"])
        if got != oracle:
            failures.append(f"recovered result {got} != oracle {oracle}")
        (ev,) = events
        if victim not in ev.dead:
            failures.append(f"victim {victim} not detected dead: {ev.dead}")
        if not ev.bricked:
            failures.append("no bricked ingress FIFO detected — the kill "
                            "missed the recv window")
        if producer not in ev.restarted:
            failures.append(
                f"producer {producer} (live endpoint onto the rebuilt "
                f"FIFO) was not force-restarted: {ev.restarted}")
        if ev.refined is not True:
            failures.append("epoch-2 plan refinement not re-proved")
        # and the deployment keeps serving, warm
        after = dep.run(instances=instances)
        if float(after["collect"]) != oracle:
            failures.append("post-recovery batch diverged from the oracle")
    if verbose:
        for ev in events:
            print("  " + ev.describe())
    return ScenarioResult(
        seed=-1, kind="pipe-brick", topology="farm", hosts=2,
        schedule=f"SIGKILL host {victim} mid-recv on the real pipe "
                 "transport", fired=1, recoveries=len(events),
        ticks=0, failures=failures)


# ==========================================================================
# Controller-crash durability scenarios (checkpointed streams + adopt)
# ==========================================================================

_KILL_CTRL_VARIANTS = ("idle-salvage", "idle-fresh", "midbatch",
                       "kill-all-hosts", "snap-kill")


def run_kill_controller_scenario(seed: int, *, variant: Optional[str] = None,
                                 clock_budget: int = 2_000_000,
                                 timeout_s: float = 60.0,
                                 device=None) -> ScenarioResult:
    """Kill the *controller* (and optionally every host) at a seeded step
    and prove the durability layer brings the deployment back.

    A fresh :class:`~.control.ClusterController` ``adopt``\\ s the dead
    one's on-disk state (epoch-stamped plan, undelivered-chunk ledger,
    pending-batch descriptor, per-host fold snapshots) and the full §6.1.1
    invariant set must hold ACROSS the restart: results bit-identical to
    the sequential oracle, ``check_redeployment`` re-proved over the
    adopt's epoch bump, no ``(chan, epoch, ci)`` record delivered twice,
    replay length bounded by chunks-since-last-snapshot, and no new stage
    builds on warm salvaged survivors.  Variants (``seed`` picks one unless
    pinned): ``idle-salvage`` / ``idle-fresh`` crash the controller between
    batches (hosts outliving it / dying with it), ``midbatch`` crashes it
    with a failed batch pending, ``kill-all-hosts`` loses controller *and*
    every host, ``snap-kill`` kills a host mid-snapshot-write so recovery
    must fall back to the previous complete snapshot.  Hosts of the dead
    controller that the adopter did not take over are killed at the end,
    so no host thread outlives the scenario."""
    import shutil
    import tempfile

    from ..core import run_sequential
    from .deploy import ClusterDeployment
    from .durable import DeploymentStore

    _cfg_device(device)
    rng = random.Random(seed)
    if variant is None:
        variant = _KILL_CTRL_VARIANTS[seed % len(_KILL_CTRL_VARIANTS)]
    instances = 12
    factory = (sim_farm, (instances, rng.choice((2, 3))))
    net = factory[0](*factory[1])
    plan = partition(net, hosts=2)
    victim = plan.assignment["collect"]  # the stateful (fold-carrying) host
    oracle = float(run_sequential(net, instances, device=device)["collect"])

    # mb=2 -> 6 chunks; snapshot_every=2 -> fold snapshots at ci=2, ci=4
    if variant in ("midbatch", "kill-all-hosts"):
        events = [FaultEvent(host=victim, op="recv", at=3 + (seed % 2),
                             action="kill", brick=False)]
    elif variant == "snap-kill":
        # second armed snapshot (ci=4) dies mid-write: the ci=2 snapshot
        # stays the latest COMPLETE one on disk
        events = [FaultEvent(host=victim, op="snap", at=1, action="kill")]
    else:
        events = []
    schedule = FaultSchedule(events)
    schedule.kind = f"ctrl-crash/{variant}"
    clock = SimClock(clock_budget)
    transport = SimTransport(schedule, clock, rebuildable=True)

    failures: list = []
    sdir = tempfile.mkdtemp(prefix="sim_durable_")
    dep = ClusterDeployment(net, plan=plan, transport=transport,
                            microbatch_size=2, factory=factory,
                            timeout_s=timeout_s, snapshot_every=2,
                            snapshot_dir=sdir, device=device)
    dep.controller.poll_s = 0.05
    dep2 = None
    recoveries = 0
    try:
        dep.start()
        transport.track_hosts(dep.controller._procs)
        cold = dep.run(instances=instances)
        if float(cold["collect"]) != oracle:
            failures.append("cold batch diverged from the oracle")
        schedule.arm()
        transport.begin_stream()

        if variant in ("midbatch", "kill-all-hosts", "snap-kill"):
            try:
                dep.run(instances=instances)
                failures.append("fault did not fire: killed batch succeeded")
            except ClusterError:
                pass
        if variant in ("idle-fresh", "kill-all-hosts"):
            # the hosts die WITH the controller (full-cluster loss)
            for p in dep.controller._procs.values():
                p.kill()
            for p in dep.controller._procs.values():
                p.join(3.0)

        # what the replay is ALLOWED to skip: everything the last complete
        # on-disk snapshot covers (None -> replays from chunk 0)
        snap = DeploymentStore(sdir).load_host_snapshot(victim)
        expect_from = snap["next_ci"] if snap is not None else 0
        if variant == "snap-kill" and expect_from != 2:
            failures.append(
                f"mid-write kill: expected the ci=2 snapshot to be the "
                f"latest complete one, found next_ci={expect_from}")

        # the controller is gone (never closed — a crash reports nothing);
        # a brand-new one adopts the on-disk state
        salvage = (dep.salvageable()
                   if variant in ("idle-salvage", "midbatch") else None)
        dep2 = ClusterDeployment.adopt(sdir, factory=factory,
                                       transport=transport,
                                       timeout_s=timeout_s, salvage=salvage)
        dep2.controller.poll_s = 0.05
        transport.track_hosts(dep2.controller._procs)
        adopt_ev = dep2.events[-1]
        if adopt_ev.mode != "adopt" or adopt_ev.refined is not True:
            failures.append("check_redeployment not re-proved across adopt")
        if dep2.epoch != dep.epoch + 1:
            failures.append(
                f"adopt must bump the epoch: {dep.epoch} -> {dep2.epoch}")

        if variant in ("midbatch", "kill-all-hosts", "snap-kill"):
            rec = dep2.recover()
            recoveries += 1
            if float(rec["collect"]) != oracle:
                failures.append(
                    f"replayed batch {float(rec['collect'])} "
                    f"!= oracle {oracle}")
            ev = dep2.events[-1]
            if ev.refined is not True:
                failures.append("post-adopt recovery refinement failed")
            got_from = ev.replay_from.get(victim)
            if got_from != expect_from:
                failures.append(
                    f"stateful host replayed from {got_from}, want the "
                    f"snapshot chunk {expect_from} (replay bounded by "
                    f"chunks-since-last-snapshot)")
            if expect_from and not any(
                    d.kind == "restore"
                    for d in dep2.controller.durable_events):
                failures.append("no restore DurabilityEvent recorded")
            if variant == "midbatch":
                # warm salvaged survivors must not rebuild stages
                for r in rec.reports:
                    if (r.host != victim and r.ok and r.jit_builds
                            and r.host not in ev.restarted):
                        failures.append(
                            f"salvaged survivor {r.host} built "
                            f"{r.jit_builds} new stages")
        # the adopted deployment serves fresh batches, bit-identical
        transport.begin_stream()
        out = dep2.run(instances=instances)
        if float(out["collect"]) != oracle:
            failures.append("post-adopt batch diverged from the oracle")
        if variant == "idle-salvage":
            if sum(r.jit_builds for r in out.reports):
                failures.append(
                    "warm survivors rebuilt stages across the adopt")
        recoveries += len(dep2.events)
    except (NetworkError, SimLivelock, RuntimeError) as e:
        failures.append(f"{type(e).__name__}: {e}")
    finally:
        try:
            if dep2 is not None:
                dep2.close()
            else:
                dep.close()
        except Exception:
            pass
        # the dead controller's orphaned hosts (those the adopter did not
        # salvage) are parked on queues nobody writes any more: end them
        kept = set(map(id, dep2.controller._procs.values())) if dep2 else ()
        for p in list(dep.controller._procs.values()):
            if id(p) not in kept and p.is_alive():
                p.kill()
                p.join(5.0)
        shutil.rmtree(sdir, ignore_errors=True)
    failures.extend(transport.violations)  # duplicate (epoch, ci) records
    return ScenarioResult(
        seed=seed, kind=schedule.kind, topology="farm", hosts=2,
        schedule=schedule.describe() or variant,
        fired=sum(ev.fired for ev in schedule.events),
        recoveries=recoveries, ticks=clock.ticks, failures=failures)


def _run_single_fault(transport, schedule, ctrl, instances, mode, batches,
                      ) -> tuple[list, list]:
    """Cold batch, arm, then ``batches - 1`` batches each through
    :func:`_run_with_recovery` (8 attempts); every epoch bump must refine.
    Returns the completed batches and the failures seen."""
    failures: list = []
    outs: list = []
    try:
        ctrl.start()
        transport.track_hosts(ctrl._procs)
        outs.append(_run_with_recovery(ctrl, instances, mode,
                                       max_attempts=8))
        schedule.arm()
        for _ in range(batches - 1):
            transport.begin_stream()
            outs.append(_run_with_recovery(ctrl, instances, mode,
                                           max_attempts=8))
        for rev in ctrl.events:
            if rev.refined is not True:
                failures.append(
                    f"epoch {rev.epoch_to}: check_redeployment failed")
    except (NetworkError, SimLivelock, RuntimeError) as e:
        failures.append(f"{type(e).__name__}: {e}")
    finally:
        try:
            ctrl.close()
        except Exception:
            pass
    return outs, failures


def run_stall_race_scenario(seed: int, *, clock_budget: int = 2_000_000,
                            timeout_s: float = 1.5,
                            stall_s: float = 2.5,
                            device=None) -> ScenarioResult:
    """A host stalls just PAST the controller's ``timeout_s`` — the
    controller gives up on it, recovers, and then the zombie wakes up and
    finishes the abandoned attempt, reporting under the old epoch while the
    replay is in flight.  The epoch guard in ``_await_results`` must drop
    that stale report; the scenario asserts the batch still completes
    bit-identically with no duplicate deliveries, however many recovery
    rounds the zombie's wake-up forces.  The cold batch, which pays every
    build, runs before the schedule is armed."""
    from ..core import run_sequential

    cfg_dev = _cfg_device(device)
    rng = random.Random(seed)
    topology, instances, factory, net, plan = _topology_draw(rng)
    # stall a host that actually has ingress (recv) or egress (send)
    op = rng.choice(("recv", "send"))
    cands = sorted({plan.assignment[c.dst if op == "recv" else c.src]
                    for c in plan.cut})
    ev = FaultEvent(host=rng.choice(cands), op=op,
                    at=rng.randrange(4), action="stall", stall_s=stall_s)
    schedule = FaultSchedule([ev])
    schedule.kind = "stall-past-timeout"
    clock = SimClock(clock_budget)
    transport = SimTransport(schedule, clock, rebuildable=True)
    transport.recv_timeout_s = 2.0  # the zombie's doomed recv must not
    # out-wait the whole scenario

    oracle = float(run_sequential(net, instances, device=device)["collect"])
    ctrl = ClusterController(net, plan, ExecConfig(microbatch_size=2,
                                                   device=cfg_dev),
                             transport, factory, timeout_s)
    ctrl.poll_s = 0.05
    outs, failures = _run_single_fault(transport, schedule, ctrl, instances,
                                       "restart", 2)
    for i, out in enumerate(outs):
        got = float(out["collect"])
        if got != oracle:
            failures.append(
                f"batch {i}: result {got} != sequential oracle {oracle}")
    failures.extend(transport.violations)
    return ScenarioResult(
        seed=seed, kind=schedule.kind, topology=topology,
        hosts=len(plan.hosts()), schedule=schedule.describe(),
        fired=sum(e.fired for e in schedule.events),
        recoveries=len(ctrl.events), ticks=clock.ticks, failures=failures)


def run_coalesce_kill_scenario(seed: int, *, batches: int = 3,
                               clock_budget: int = 500_000,
                               timeout_s: float = 60.0,
                               coalesce_bytes: int = 1 << 14,
                               device=None) -> ScenarioResult:
    """Kill a producer host mid-stream while the transport COALESCES small
    records — the batching fast path's failure window.  A partially-filled
    coalesce buffer at the moment of death holds records the consumer never
    saw; records flushed just before the kill may arrive twice via the
    recovery replay.  The invariants are exactly the per-record protocol's:
    no ``(chan, epoch, ci)`` delivered twice (the consumer's duplicate
    filter sees sub-records, not batches), results bit-identical to the
    sequential oracle, and every epoch bump re-proving §6.1.1."""
    from ..core import run_sequential

    cfg_dev = _cfg_device(device)
    rng = random.Random(seed)
    topology, instances, factory, net, plan = _topology_draw(rng)
    # the victim is always a SENDER on a cut channel: its death strands
    # whatever its coalesce buffer held — the window this scenario exists
    # to cover (run_scenario's random schedules rarely land there)
    senders = sorted({plan.assignment[c.src] for c in plan.cut})
    ev = FaultEvent(host=rng.choice(senders), op="send",
                    at=rng.randrange(4), action="kill", brick=False)
    schedule = FaultSchedule([ev])
    schedule.kind = "coalesce-kill"
    mode = rng.choice(("restart", "rebalance"))
    clock = SimClock(clock_budget)
    transport = SimTransport(schedule, clock, rebuildable=True)
    transport.coalesce_bytes = coalesce_bytes

    oracle = float(run_sequential(net, instances, device=device)["collect"])
    ctrl = ClusterController(net, plan, ExecConfig(
        microbatch_size=2, coalesce_bytes=coalesce_bytes, device=cfg_dev),
        transport, factory, timeout_s)
    ctrl.poll_s = 0.05
    outs, failures = _run_single_fault(transport, schedule, ctrl, instances,
                                       mode, batches)
    for i, out in enumerate(outs):
        got = float(out["collect"])
        if got != oracle:
            failures.append(
                f"batch {i}: result {got} != sequential oracle {oracle}")
    failures.extend(transport.violations)  # duplicate (epoch, ci) records
    return ScenarioResult(
        seed=seed, kind=schedule.kind, topology=topology,
        hosts=len(plan.hosts()), schedule=schedule.describe(),
        fired=sum(e.fired for e in schedule.events),
        recoveries=len(ctrl.events), ticks=clock.ticks, failures=failures)


# ==========================================================================
# Kill-during-serving: faults under a live ServeEngine
# ==========================================================================

def run_serve_kill_scenario(seed: int, *, clock_budget: int = 2_000_000,
                            timeout_s: float = 60.0,
                            device=None) -> ScenarioResult:
    """One seeded fault schedule against a live :class:`~..serve
    .ServeEngine` over the clustered decode farm.

    The engine streams a seeded request trace (arrival pattern, prompt
    lengths, token budgets all fixed by the seed) through a
    :class:`~..serve.ClusterDecodeBackend` whose deployment rides this
    module's :class:`SimTransport`; the schedule kills or stalls hosts at
    exact protocol steps *between decode chunks* — mid-prefill, mid-decode,
    while parked, or during the recovery the first kill provoked.  The
    serving guarantee under fire: every accepted request is answered
    **exactly once**, each token stream identical to the sequential
    per-request oracle, no ``(epoch, ci)`` record delivered twice within
    any farm step (recovery replays included), and every epoch bump
    re-proves the refinement.  The hosts and the oracle run on ``device``
    (``None``: the card)."""
    from ..serve import (ClusterDecodeBackend, LocalDecodeBackend, Request,
                         ServeEngine)
    from ..serve.engine import build_decode_model, make_decode_farm

    cfg_dev = _cfg_device(device)
    rng = random.Random(seed)
    spec = ("toy", 32, 8)
    n_slots, shards, max_len, pchunk = 4, 2, 32, 4
    hosts = rng.choice((2, 3))
    reqs = [Request(rid=i,
                    prompt=tuple(rng.randrange(1, 32)
                                 for _ in range(rng.randrange(1, 7))),
                    max_new=rng.randrange(1, 7))
            for i in range(rng.randrange(5, 9))]

    # sequential oracle: each request alone through a single-slot engine
    model, params = build_decode_model(spec, device=cfg_dev)
    expect = {}
    for r in reqs:
        oeng = ServeEngine(LocalDecodeBackend(
            model, params, n_slots=1, max_len=max_len,
            prefill_chunk=pchunk))
        oeng.submit(r)
        oeng.run_until_drained()
        expect[r.rid] = oeng.poll(r.rid).tokens

    net = make_decode_farm(spec, n_slots, shards, max_len, pchunk, cfg_dev)
    plan = partition(net, hosts=hosts)
    schedule = FaultSchedule.random(rng, plan)
    clock = SimClock(clock_budget)
    transport = SimTransport(schedule, clock, rebuildable=True)

    failures: list = []
    be = None
    events: list = []
    eng = None
    try:
        be = ClusterDecodeBackend(
            spec, n_slots=n_slots, shards=shards, hosts=hosts,
            transport=transport, max_len=max_len, prefill_chunk=pchunk,
            timeout_s=timeout_s, max_recover_attempts=8, device=cfg_dev)
        ctrl = be.dep.controller
        ctrl.poll_s = 0.05
        transport.track_hosts(ctrl._procs)

        # every farm step opens a fresh duplicate-monitor window: within
        # one step (and all its recovery replays, each at a bumped epoch)
        # (epoch, ci) must be unique per channel; across steps the same
        # epoch legitimately reuses them
        inner = be._run

        def run_stream(batch):
            transport.begin_stream()
            return inner(batch)

        be._run = run_stream
        eng = ServeEngine(be)
        # cold step first (spawn + stage builds = the warm baseline), then
        # arm the schedule so `at` counts protocol steps deterministically
        eng.submit(reqs[0])
        eng.step()
        schedule.arm()
        i = 1
        while i < len(reqs) or eng.pending or eng._live:
            # seeded arrival trickle; always admit when the farm is idle
            while i < len(reqs) and (rng.random() < 0.5
                                     or not (eng.pending or eng._live)):
                eng.submit(reqs[i])
                i += 1
            eng.step()
        events = list(ctrl.events)
    except (NetworkError, SimLivelock, RuntimeError) as e:
        failures.append(f"{type(e).__name__}: {e}")
        if be is not None:
            events = list(be.dep.controller.events)
    finally:
        if be is not None:
            try:
                be.close()
            except Exception:
                pass

    # -- the serving invariants --------------------------------------------
    if eng is not None:
        answered = [resp.rid for resp in eng.completed]
        for r in reqs:
            n = answered.count(r.rid)
            if n != 1:
                failures.append(
                    f"request {r.rid} answered {n} times (want exactly 1)")
                continue
            got = eng.poll(r.rid).tokens
            if got != expect[r.rid]:
                failures.append(
                    f"request {r.rid}: tokens {got} != sequential oracle "
                    f"{expect[r.rid]}")
    failures.extend(transport.violations)  # duplicate (epoch, ci) records
    for ev in events:
        if ev.refined is not True:
            failures.append(
                f"epoch {ev.epoch_to}: check_redeployment failed")
    return ScenarioResult(
        seed=seed, kind=f"serve/{schedule.kind}", topology="decode-farm",
        hosts=hosts, schedule=schedule.describe(),
        fired=sum(ev.fired for ev in schedule.events),
        recoveries=len(events), ticks=clock.ticks, failures=failures)


# ==========================================================================
# CLI: python -m repro_torch.cluster.sim --seeds 50
# ==========================================================================

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Deterministic fault-injection sweep over the cluster "
                    "control plane (sim transport), plus the real-pipe "
                    "bricked-ingress reproduction")
    ap.add_argument("--seeds", type=int, default=20,
                    help="number of seeded random fault schedules to run")
    ap.add_argument("--seed-start", type=int, default=0)
    ap.add_argument("--pipe-brick", action="store_true",
                    help="run ONLY the mid-recv SIGKILL scenario on the "
                         "real pipe transport")
    ap.add_argument("--serve-kill", type=int, default=0, metavar="N",
                    help="run ONLY N seeded kill-during-serving scenarios "
                         "(live ServeEngine over the clustered decode farm)")
    ap.add_argument("--kill-controller", type=int, default=0, metavar="N",
                    help="run ONLY N seeded controller-crash durability "
                         "scenarios (snapshots + adopt; N >= 5 covers "
                         "every variant)")
    ap.add_argument("--stall-race", type=int, default=0, metavar="N",
                    help="run ONLY N seeded stall-past-timeout scenarios "
                         "(controller-timeout races; slow — real stalls)")
    ap.add_argument("--coalesce-kill", type=int, default=0, metavar="N",
                    help="run ONLY N seeded kill-during-coalesced-send "
                         "scenarios (transport batching fast path under "
                         "fire: stranded/replayed coalesce buffers)")
    ap.add_argument("--workload", type=int, default=0, metavar="N",
                    help="run ONLY N seeded workload schedules (traffic "
                         "spike / straggler / slow-start, seed%%3 picks) "
                         "against the autoscaler, gating bit-identity, "
                         "refinement and bounded scaling actions")
    ap.add_argument("--device", default=None,
                    help="where the hosts and the oracle run (default: the "
                         "card; 'cpu' off it)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no GPU and no --device cpu: raise first

    dev = args.device
    t0 = time.perf_counter()
    if args.pipe_brick:
        runs = [lambda: run_pipe_brick_scenario(verbose=args.verbose,
                                                device=dev)]
    else:
        if args.serve_kill:
            fn, n = run_serve_kill_scenario, args.serve_kill
        elif args.kill_controller:
            fn, n = run_kill_controller_scenario, args.kill_controller
        elif args.stall_race:
            fn, n = run_stall_race_scenario, args.stall_race
        elif args.coalesce_kill:
            fn, n = run_coalesce_kill_scenario, args.coalesce_kill
        elif args.workload:
            fn, n = run_workload_scenario, args.workload
        else:
            fn, n = run_scenario, args.seeds
        runs = [lambda s=s: fn(s, device=dev)
                for s in range(args.seed_start, args.seed_start + n)]
    results = []
    for run in runs:
        results.append(run())
        print(results[-1].describe(), flush=True)
    bad = [r for r in results if not r.ok]
    fired = sum(r.fired for r in results)
    recov = sum(r.recoveries for r in results)
    print(f"== sim: {len(results)} scenario(s), {fired} fault(s) fired, "
          f"{recov} recover(ies), {len(bad)} failed, "
          f"{time.perf_counter() - t0:.1f}s ==")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
