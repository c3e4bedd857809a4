"""Groovy Parallel Patterns, PyTorch edition — the paper's primary
contribution.

A process-oriented parallel-patterns library: declarative networks of
terminals / functionals / connectors, verified statically (``verify``) and by
a bounded CSP model checker (``csp``), executable as a sequential oracle
(``run_sequential``), as one fused program (``build``) and as a streaming
microbatch pipeline (``CompiledNetwork.run_streaming``).  Higher-level
patterns and the shared-data engines mirror the paper's §5.
"""

from .builder import CompiledNetwork, StageLog, build, run_sequential
from .dataflow import (
    ChannelDef,
    Distribution,
    Kind,
    Network,
    NetworkError,
    ProcessDef,
    TensorSpec,
    UT,
)
from .engine import (
    IterativeEngine,
    MultiCoreEngine,
    Stencil,
    StencilEngine,
    narrow,
)
from .patterns import (
    DataParallelCollect,
    GroupOfPipelineCollects,
    OnePipelineCollect,
    TaskParallelOfGroupCollects,
)
from .processes import (
    AnyFanOne,
    Collect,
    CombineNto1,
    Emit,
    EmitWithLocal,
    ListParOne,
    ListSeqOne,
    OneFanAny,
    OneFanList,
    OneParCastList,
    OneSeqCastList,
    Worker,
)
from . import csp
from . import netlog
from . import trace
from . import stream
from .stream import (StreamExecutor, StreamStats, microbatch_plan,
                     slice_microbatch, stack_microbatches)
from .verify import VerificationReport, verify

__all__ = [
    # dataflow
    "Network", "NetworkError", "ProcessDef", "ChannelDef", "TensorSpec",
    "Kind", "Distribution", "UT",
    # processes
    "Emit", "EmitWithLocal", "Collect", "Worker",
    "OneFanAny", "OneFanList", "OneSeqCastList", "OneParCastList",
    "AnyFanOne", "ListSeqOne", "ListParOne", "CombineNto1",
    # builder
    "build", "run_sequential", "CompiledNetwork", "StageLog",
    # verification
    "verify", "VerificationReport", "csp",
    # patterns
    "DataParallelCollect", "OnePipelineCollect", "GroupOfPipelineCollects",
    "TaskParallelOfGroupCollects",
    # engines
    "IterativeEngine", "Stencil", "MultiCoreEngine", "StencilEngine",
    "narrow",
    # streaming microbatch runtime
    "stream", "StreamExecutor", "StreamStats", "microbatch_plan",
    "slice_microbatch", "stack_microbatches",
    # visualisation (paper §13 future work) + unified tracing/metrics plane
    "netlog", "trace",
]
