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
  ``device``) or a long-running spawned OS process (``pipe``) — each
  holding a warm :class:`~.runtime.PartitionExecutor` whose stage callables
  are built once and persist across batches;
* :meth:`run` posts one batch descriptor per host (chunk bounds + instance
  count — not respawning anything) and merges the per-host results, bit-
  identical to ``run_sequential`` every time;
* :meth:`close` (or the context manager exit) shuts the workers down and
  releases the transport.

This class is the user-facing facade over
:class:`.control.ClusterController`.  A host failure mid-batch raises
:class:`~.runtime.ClusterError` carrying the §8-style cluster report.
Repairing the deployment after that (:meth:`recover`, :meth:`kill_host`,
:meth:`restart_host`, :meth:`reconfigure`) and adopting a durable one
(:meth:`adopt`) come with the elastic and durable cluster slices of the
port, and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import Optional

from ..core.dataflow import Network, NetworkError
from .control import ClusterController
from .partition import PartitionPlan, partition
from .runtime import _DURABLE_SLICE, ClusterResult, ExecConfig
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

    ``transport`` is a name (``"inprocess"`` / ``"pipe"`` / ``"device"``)
    or a ready :class:`ChannelTransport`; the process transport needs
    ``factory=(picklable_callable, args)``.  ``device`` is where the hosts
    run (``None``: the card; ``"cpu"`` on request).  Every :meth:`run`
    returns a :class:`~.runtime.ClusterResult` whose per-host
    :class:`~.runtime.HostReport`\\ s carry streaming telemetry, the chosen
    cut-channel capacities, and the number of stage callables built during
    that batch (0 once warm).
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
                 device=None):
        if snapshot_every or snapshot_dir:
            raise NotImplementedError(_DURABLE_SLICE)
        if net is None:
            if factory is None:
                raise NetworkError("ClusterDeployment: need net= or factory=")
            net = factory[0](*factory[1])
        if plan is None:
            if hosts is None:
                raise NetworkError("ClusterDeployment: need hosts= or plan=")
            plan = partition(net, hosts=hosts)
        self.net = net
        cfg = ExecConfig(microbatch_size, max_in_flight, lanes, fuse,
                         trace=trace, coalesce_bytes=coalesce_bytes,
                         profile=profile,
                         device=None if device is None else str(device))
        t: ChannelTransport = (make_transport(transport)
                               if isinstance(transport, str) else transport)
        if coalesce_bytes:
            t.coalesce_bytes = coalesce_bytes
        self.controller = ClusterController(net, plan, cfg, t, factory,
                                            timeout_s)

    @classmethod
    def adopt(cls, snapshot_dir: str, **kw) -> "ClusterDeployment":
        raise NotImplementedError(
            "adopting a durable deployment comes with the durable cluster "
            "slice of the port (cluster/durable.py with train/checkpoint.py)")

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
        """:class:`~.control.RecoveryEvent` per recovery (none until the
        elastic slice)."""
        return self.controller.events

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
        self.controller.kill_host(host)

    def restart_host(self, host: int) -> None:
        self.controller.restart_host(host)

    def reconfigure(self, *, hosts: Optional[int] = None, plan=None):
        return self.controller.reconfigure(hosts=hosts, plan=plan)

    def recover(self, mode: str = "restart") -> Optional[ClusterResult]:
        return self.controller.recover(mode=mode, replay=True)

    # -- execution ---------------------------------------------------------
    def run(self, instances: Optional[int] = None, *,
            batch=None) -> ClusterResult:
        """Stream one batch through the warm deployment.

        Provide ``instances`` (the host owning the real Emit materialises
        its own items, exactly like ``run_cluster``) or an explicit
        ``batch`` pytree for the network's Emit.  Returns the merged Collect
        dict with fresh per-host reports; raises :class:`ClusterError` on
        any host failure."""
        return self.controller.run_batch(instances, batch=batch)

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
