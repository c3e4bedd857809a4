"""Warm cluster deployments: partition, build and spawn ONCE, run many.

``run_cluster`` pays the whole deployment bill — partition build, host
spawn (a fresh interpreter, CUDA context and set of kernel libraries per
host for the process transport), per-host stage building — on *every*
call.  The paper's §7 capstone (and Kerridge's Cluster Builder DSL) deploys
a network once and then feeds it work; :class:`ClusterDeployment` is that
steady-state path:

* :meth:`start` partitions the network, derives cut-channel capacities from
  each consumer executor's depth/lane appetite
  (:func:`.runtime.derive_cut_capacities`), stands the transport up once,
  and parks one worker per host — a daemon thread (``inprocess`` /
  ``device``) or a long-running spawned OS process (``pipe`` / ``shm``) —
  each
  holding a warm :class:`~.runtime.PartitionExecutor` whose stage callables
  are built once and persist across batches;
* :meth:`run` posts one batch descriptor per host (chunk bounds + instance
  count — not respawning anything) and merges the per-host results, bit-
  identical to ``run_sequential`` every time;
* :meth:`close` (or the context manager exit) shuts the workers down and
  releases the transport.

This class is the user-facing facade over
:class:`.control.ClusterController`.  A host failure mid-batch raises
:class:`~.runtime.ClusterError` carrying the §8-style cluster report;
:meth:`recover` then repairs the deployment and replays the failed batch's
lost chunks, :meth:`kill_host` injects the honest failure (process hosts),
and :meth:`reconfigure` refits the network to another host count between
batches (by itself, under load, with ``autoscale=``).  Deployed with
``snapshot_every=`` and ``snapshot_dir=`` it is durable (:mod:`.durable`):
a failed stateful host replays from its last fold snapshot instead of
chunk 0, and after the controller itself is gone :meth:`adopt` stands a
new one up over the on-disk state.
"""

from __future__ import annotations

from typing import Optional

from ..core.dataflow import Network, NetworkError
from .control import ClusterController
from .durable import DeploymentStore
from .partition import PartitionPlan, partition
from .runtime import ClusterResult, ExecConfig
from .transport import ChannelTransport, make_transport

__all__ = ["ClusterDeployment"]


class ClusterDeployment:
    """A process network deployed across hosts, kept warm across batches.

    ::

        with ClusterDeployment(net, hosts=2, transport="pipe",
                               factory=(make_net, args)) as dep:
            cold = dep.run(instances=n)    # pays spawn + build once
            warm = dep.run(instances=n)    # near single-host speed
            other = dep.run(batch=my_batch)  # explicit Emit batch pytree

    ``transport`` is a name (``"inprocess"`` / ``"pipe"`` / ``"shm"`` /
    ``"device"``) or a ready :class:`ChannelTransport` (e.g.
    ``SharedMemoryRing(slot_bytes=...)``); the process transports need
    ``factory=(picklable_callable, args)``.  ``device`` is where the hosts
    run (``None``: the card; ``"cpu"`` on request).  Every :meth:`run`
    returns a :class:`~.runtime.ClusterResult` whose per-host
    :class:`~.runtime.HostReport`\\ s carry streaming telemetry, the chosen
    cut-channel capacities, and the number of stage callables built during
    that batch (0 once warm).

    ``snapshot_every=N`` with ``snapshot_dir=DIR`` makes the deployment
    durable: each host snapshots its fold state every N chunks under
    ``DIR/host_<h>`` and the controller its meta under ``DIR/meta``.
    ``profile=`` (a :class:`~.costs.CostProfile`) sizes coalesced cut
    channels and prices the autoscaler's migrations; ``autoscale=`` (an
    :class:`~.autoscale.AutoscalePolicy`, or ``True`` for its defaults)
    polls the deployment's metrics after every batch and resizes it.
    """

    def __init__(self, net: Optional[Network] = None, *,
                 hosts: Optional[int] = None,
                 plan: Optional[PartitionPlan] = None,
                 transport="inprocess",
                 microbatch_size: int = 8,
                 max_in_flight: Optional[int] = None,
                 lanes: Optional[int] = None,
                 fuse: bool = True,
                 factory: Optional[tuple] = None,
                 timeout_s: float = 300.0,
                 trace: bool = False,
                 snapshot_every: int = 0,
                 snapshot_dir: Optional[str] = None,
                 coalesce_bytes: int = 0,
                 profile=None,
                 device=None,
                 autoscale=None):
        if net is None:
            if factory is None:
                raise NetworkError("ClusterDeployment: need net= or factory=")
            net = factory[0](*factory[1])
        if plan is None:
            if hosts is None:
                raise NetworkError("ClusterDeployment: need hosts= or plan=")
            plan = partition(net, hosts=hosts)
        if snapshot_every and not snapshot_dir:
            raise NetworkError(
                "ClusterDeployment: snapshot_every needs snapshot_dir=")
        self.net = net
        cfg = ExecConfig(microbatch_size, max_in_flight, lanes, fuse,
                         trace=trace, snapshot_every=snapshot_every,
                         snapshot_dir=snapshot_dir,
                         coalesce_bytes=coalesce_bytes, profile=profile,
                         device=None if device is None else str(device))
        t: ChannelTransport = (make_transport(transport)
                               if isinstance(transport, str) else transport)
        if coalesce_bytes:
            t.coalesce_bytes = coalesce_bytes
        store = DeploymentStore(snapshot_dir) if snapshot_dir else None
        self.controller = ClusterController(net, plan, cfg, t, factory,
                                            timeout_s, store=store)
        # autoscale= is a policy (or True for the defaults), NOT part of
        # ExecConfig: the policy holds live hysteresis state and must not
        # ride the durable cfg into adopt()
        self.autoscaler = None
        if autoscale is not None and autoscale is not False:
            from .autoscale import Autoscaler, AutoscalePolicy
            pol = AutoscalePolicy() if autoscale is True else autoscale
            self.autoscaler = Autoscaler(self.controller, pol,
                                         profile=profile)

    @classmethod
    def adopt(cls, snapshot_dir: str, *, factory: tuple,
              transport="inprocess", timeout_s: float = 300.0,
              trace: bool = False,
              salvage: Optional[dict] = None) -> "ClusterDeployment":
        """Stand a brand-new controller up over a previous deployment's
        on-disk state (``snapshot_dir``) — the controller-crash recovery
        path.  The epoch is bumped across the adopt, the refinement is
        re-proved (``dep.events[-1].refined``), and any pending failed
        batch replays from the durable fold snapshots at the next
        :meth:`recover`.

        ``factory=(picklable_callable, args)`` rebuilds the network (the
        declarative half that does not live on disk).  ``salvage`` hands
        over a dead controller's still-live wiring
        (:meth:`salvageable`), so surviving warm workers are re-parked with
        0 new stage builds; without it every host spawns fresh.  The hosts
        run where the adopted deployment ran (the card unless it was
        deployed on the CPU).
        """
        store = DeploymentStore(snapshot_dir)
        meta = store.load_meta()
        if meta is None:
            raise NetworkError(
                f"adopt: no deployment meta under {snapshot_dir!r}")
        net = factory[0](*factory[1])
        cfgd = dict(meta["cfg"])
        dep = cls(net, plan=partition(net, assignment=meta["assignment"]),
                  transport=transport,
                  microbatch_size=cfgd["microbatch_size"],
                  max_in_flight=cfgd["max_in_flight"],
                  lanes=cfgd["lanes"], fuse=cfgd["fuse"], factory=factory,
                  timeout_s=timeout_s, trace=trace or cfgd["trace"],
                  snapshot_every=cfgd["snapshot_every"],
                  snapshot_dir=snapshot_dir,
                  coalesce_bytes=cfgd.get("coalesce_bytes", 0),
                  device=cfgd["device"])
        dep.controller.adopt_state(meta, salvage=salvage)
        return dep

    def salvageable(self) -> dict:
        """The live wiring another controller needs to adopt this
        deployment's surviving workers in-process (the ``salvage=`` value
        for :meth:`adopt`).  Meaningful only while the workers are alive —
        a real controller crash takes thread-backed hosts with it, so this
        models the hosts-outlive-controller topology."""
        c = self.controller
        return {"transport": c.transport, "procs": c._procs,
                "threads": c._threads, "work_qs": c._work_qs,
                "result_q": c._result_q, "result_qs": c._result_qs,
                "executors": c.executors, "devices": c._devices}

    # -- the control plane, surfaced ---------------------------------------
    @property
    def plan(self) -> PartitionPlan:
        return self.controller.plan

    @property
    def capacities(self) -> dict:
        return self.controller.capacities

    @property
    def transport(self) -> ChannelTransport:
        return self.controller.transport

    @property
    def executors(self) -> dict:
        """Thread hosts only: the live per-host executors."""
        return self.controller.executors

    @property
    def epoch(self) -> int:
        """Plan epoch: 1 at start()."""
        return self.controller.epoch

    @property
    def events(self) -> list:
        """:class:`~.control.RecoveryEvent` per recovery, reconfiguration
        or adoption."""
        return self.controller.events

    @property
    def autoscale_events(self) -> list:
        """:class:`~.autoscale.AutoscaleEvent` per autoscale decision
        (executed or vetoed), oldest first; [] without ``autoscale=``."""
        return [] if self.autoscaler is None else self.autoscaler.events

    @property
    def durable_events(self) -> list:
        """:class:`~.durable.DurabilityEvent` per meta snapshot, restore
        from a fold snapshot and adoption, oldest first."""
        return self.controller.durable_events

    @property
    def cfg(self) -> ExecConfig:
        return self.controller.cfg

    @property
    def factory(self) -> Optional[tuple]:
        return self.controller.factory

    @property
    def timeout_s(self) -> float:
        return self.controller.timeout_s

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "ClusterDeployment":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def start(self) -> None:
        """Stand the deployment up (idempotent): transport FIFOs and one
        parked worker per host."""
        self.controller.start()

    def close(self) -> None:
        """Shut the workers down and release the transport (idempotent;
        safe to call after a failed start — whatever came up goes down)."""
        self.controller.close()

    def kill_host(self, host: int) -> None:
        """Fault injection (process transports): SIGKILL one host's worker
        mid-flight.  The next batch detects the corpse, quiesces the
        survivors resumably, and raises ``ClusterError``; :meth:`recover`
        brings the deployment back."""
        self.controller.kill_host(host)

    def restart_host(self, host: int) -> None:
        """Respawn one host's worker against the warm transport."""
        self.controller.restart_host(host)

    def reconfigure(self, *, hosts: Optional[int] = None, plan=None):
        """Re-fit the same network to a different host count between
        batches — scale-out/in as an epoch-bumped replan, not a restart
        (see :meth:`ClusterController.reconfigure`).  Hosts whose wiring
        is unchanged keep their warm executors.  Returns the
        :class:`~.control.RecoveryEvent` (``mode="reconfigure"``,
        ``refined`` = the refinement re-proof)."""
        return self.controller.reconfigure(hosts=hosts, plan=plan)

    def recover(self, mode: str = "restart") -> Optional[ClusterResult]:
        """Repair a failed deployment and replay the failed batch's lost
        chunks (see :meth:`ClusterController.recover`).  ``mode="restart"``
        respawns dead workers under the unchanged plan; ``mode="rebalance"``
        moves the failed hosts' processes onto survivors via the planner.
        Returns the replayed batch's completed result."""
        return self.controller.recover(mode=mode, replay=True)

    # -- execution ---------------------------------------------------------
    def run(self, instances: Optional[int] = None, *,
            batch=None) -> ClusterResult:
        """Stream one batch through the warm deployment.

        Provide ``instances`` (the host owning the real Emit materialises
        its own items, exactly like ``run_cluster``) or an explicit
        ``batch`` pytree for the network's Emit.  Returns the merged Collect
        dict with fresh per-host reports; raises :class:`ClusterError` on
        any host failure.  After a failure the deployment is not poisoned:
        :meth:`recover` replays the failed batch, or the next :meth:`run`
        recovers without replay and moves on.

        Deployed with ``autoscale=``, every completed batch is followed by
        one policy poll: a sustained load signal resizes the plan between
        batches as an epoch-bumped replan (:attr:`autoscale_events`
        records each decision, executed or vetoed)."""
        out = self.controller.run_batch(instances, batch=batch)
        if self.autoscaler is not None:
            self.autoscaler.poll()
        return out

    # -- observability (deploy with ``trace=True``) --------------------------
    def merged_trace(self) -> list:
        """All trace events recorded so far — controller spans plus every
        host's shipped ring buffer — merged onto the controller clock."""
        return self.controller.merged_trace()

    def export_trace(self, path: Optional[str] = None):
        """Export the merged trace as Chrome trace-event JSON."""
        return self.controller.export_trace(path)

    def clear_trace(self) -> None:
        self.controller.clear_trace()

    def metrics(self):
        """A :class:`~..core.trace.MetricsSnapshot` of the live deployment:
        queue depths/occupancy now, plus per-host throughput, stall rates
        and channel bytes/s from the last completed batch."""
        return self.controller.metrics()
