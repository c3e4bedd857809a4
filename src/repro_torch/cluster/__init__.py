"""Cluster runtime — multi-host process networks (paper §7, Cluster Builder).

The paper's capstone runs the same Mandelbrot farm unchanged on a multicore
processor and a workstation cluster.  This package is that step for the
port's networks: :func:`partition` splits a verified Network across hosts at
channel boundaries (with a CSP proof that the partitioned network
trace-refines the unpartitioned one), :mod:`.transport` realises the cut
channels as bounded FIFO pipes (thread hosts over queues, thread hosts
whose tensors stay on the card, or spawned OS processes), and
:class:`ClusterDeployment` stands the whole thing up ONCE and then streams
batch after batch through the warm hosts; :func:`run_cluster` is the
one-shot convenience on top.

This slice brings the path a healthy deployment walks.  The shared-memory
ring transport, elastic recovery and reconfiguration, durability, the
simulator, cost calibration and the autoscaler come with later slices, and
their entry points here raise ``NotImplementedError`` naming them.
"""

from .control import ClusterController, RecoveryEvent
from .deploy import ClusterDeployment
from .partition import (PartitionPlan, abstract_partitioned_model,
                        auto_assignment, check_redeployment,
                        check_refinement, cost_assignment, partition,
                        repartition_without)
from .runtime import (ClusterError, ClusterResult, ExecConfig, HostReport,
                      PartitionExecutor, derive_cut_capacities,
                      make_host_executor, run_cluster)
from .transport import (ChannelTransport, DeviceTransport, InProcess,
                        MultiProcessPipe, TransportError, make_transport)

__all__ = [
    "PartitionPlan", "partition", "auto_assignment", "cost_assignment",
    "repartition_without",
    "abstract_partitioned_model", "check_refinement", "check_redeployment",
    "ChannelTransport", "InProcess", "MultiProcessPipe", "DeviceTransport",
    "TransportError", "make_transport",
    "PartitionExecutor", "run_cluster", "ClusterResult", "ClusterError",
    "HostReport", "ExecConfig", "ClusterDeployment", "ClusterController",
    "RecoveryEvent", "derive_cut_capacities", "make_host_executor",
]
