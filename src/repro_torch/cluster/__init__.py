"""Cluster runtime — multi-host process networks (paper §7, Cluster Builder).

The paper's capstone runs the same Mandelbrot farm unchanged on a multicore
processor and a workstation cluster.  This package is that step for the
port's networks: :func:`partition` splits a verified Network across hosts at
channel boundaries (with a CSP proof that the partitioned network
trace-refines the unpartitioned one), :mod:`.transport` realises the cut
channels as bounded FIFO pipes (thread hosts over queues, thread hosts
whose tensors stay on the card, or spawned OS processes over queues or a
shared-memory slot ring), and :class:`ClusterDeployment` stands the whole
thing up ONCE and then streams batch after batch through the warm hosts,
recovering from a failed or killed host (restart or rebalance, then a
replay of the lost chunks) and refitting itself to another host count;
:func:`run_cluster` is the one-shot convenience on top.  A deployment with
a :class:`DeploymentStore` (``snapshot_every=`` / ``snapshot_dir=``) is
durable: hosts snapshot their fold state, a failed stateful host replays
from its last snapshot, and :meth:`ClusterDeployment.adopt` takes the
deployment over after its controller died.  The fault-injection
simulator (:mod:`.sim`) drives all of it through seeded kill and stall
schedules and asserts the §6.1.1 invariants after each.

Cost calibration and the autoscaler come with later slices.
"""

from .control import ClusterController, RecoveryEvent
from .deploy import ClusterDeployment
from .durable import DeploymentStore, DurabilityEvent
from .partition import (PartitionPlan, abstract_partitioned_model,
                        auto_assignment, check_redeployment,
                        check_refinement, cost_assignment, partition,
                        repartition_without)
from .runtime import (ClusterError, ClusterResult, ExecConfig, HostReport,
                      PartitionExecutor, derive_cut_capacities,
                      make_host_executor, run_cluster)
from .sim import (FaultEvent, FaultSchedule, SimClock, SimTransport,
                  run_coalesce_kill_scenario, run_kill_controller_scenario,
                  run_pipe_brick_scenario, run_scenario,
                  run_stall_race_scenario, run_workload_scenario)
from .transport import (ChannelTransport, DeviceTransport, InProcess,
                        MultiProcessPipe, SharedMemoryRing, TransportError,
                        make_transport)

__all__ = [
    "PartitionPlan", "partition", "auto_assignment", "cost_assignment",
    "repartition_without",
    "abstract_partitioned_model", "check_refinement", "check_redeployment",
    "ChannelTransport", "InProcess", "MultiProcessPipe", "SharedMemoryRing",
    "DeviceTransport",
    "TransportError", "make_transport",
    "PartitionExecutor", "run_cluster", "ClusterResult", "ClusterError",
    "HostReport", "ExecConfig", "ClusterDeployment", "ClusterController",
    "RecoveryEvent", "derive_cut_capacities", "make_host_executor",
    "DeploymentStore", "DurabilityEvent",
    "FaultEvent", "FaultSchedule", "SimClock", "SimTransport",
    "run_scenario", "run_pipe_brick_scenario",
    "run_kill_controller_scenario", "run_stall_race_scenario",
    "run_coalesce_kill_scenario", "run_workload_scenario",
]
