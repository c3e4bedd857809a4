"""Dataflow graph abstractions — the GPP process network, PyTorch edition.

The paper's process network is a directed graph of *processes* joined by
synchronous *channels*.  On the GPU the network runs as one fused program
over the whole item batch (or as a stream of microbatches), so a ``Channel``
becomes a typed edge (an optional shape/dtype spec) and a ``Process`` becomes
a function on tensors.  The CSP safety property the paper obtains from
copy-once channel semantics holds as long as stage functions do not mutate
their inputs in place: every stage returns new tensors.

Three process classes (paper §4):

* **terminals**  — ``Emit`` (source) and ``Collect`` (sink),
* **functionals** — ``Worker`` and compositions thereof (groups / pipelines),
* **connectors** — *spreaders* (one-to-many) and *reducers* (many-to-one).

Connectors carry no user computation; they determine data distribution and are
realised by the builder as splits and interleavings of the batch axis.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Sequence

import torch

__all__ = [
    "TensorSpec",
    "Kind",
    "Distribution",
    "ProcessDef",
    "ChannelDef",
    "Network",
    "NetworkError",
    "UT",
]


class UT:
    """UniversalTerminator sentinel (paper §4.3.1).

    In stream (host-level) execution the UT object flows through the network
    and triggers orderly shutdown.  In compiled execution termination is
    structural (the program ends), but the CSP model checker still reasons
    about UT propagation explicitly.
    """

    _instance: Optional["UT"] = None

    def __new__(cls) -> "UT":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return "UT"


class Kind(enum.Enum):
    """GPP process taxonomy."""

    EMIT = "emit"
    COLLECT = "collect"
    WORKER = "worker"
    SPREADER = "spreader"
    REDUCER = "reducer"
    ENGINE = "engine"


class Distribution(enum.Enum):
    """How a connector distributes data (paper §4.5).

    ``FAN``      one item to exactly one successor (``OneFanAny``/``OneFanList``):
                 work partitioning → block sharding over a mesh axis.
    ``SEQ_CAST`` copy of the item to every successor, sequentially
                 (``OneSeqCastList``): replication.
    ``PAR_CAST`` copy of the item to every successor, in parallel
                 (``OneParCastList``): replication (identical compiled form —
                 the seq/par distinction is a JVM-scheduling artefact with no
                 SPMD analogue; recorded in DESIGN.md).
    ``MERGE``    reducer: interleave many inputs into one ordered flow
                 (``ListSeqOne``/``AnyFanOne``): all-gather.
    ``COMBINE``  reducer: fold many inputs into one value (``CombineNto1``):
                 psum-style reduction with a user combine fn.
    """

    FAN = "fan"
    SEQ_CAST = "seq_cast"
    PAR_CAST = "par_cast"
    MERGE = "merge"
    COMBINE = "combine"


@dataclasses.dataclass
class ProcessDef:
    """A node of the network.

    ``fn`` signatures by kind:

    * EMIT:    ``fn(index:int) -> item``  (host) or a ``DataSource`` object
    * WORKER:  ``fn(item, *modifier) -> item``  (pure, on tensors unless
               ``host_only=True``)
    * COLLECT: ``fn(acc, item) -> acc``  with ``init`` and ``finalise(acc)``
    * SPREADER/REDUCER: ``fn`` unused (``COMBINE`` uses ``fn(a, b) -> a``)
    """

    name: str
    kind: Kind
    fn: Optional[Callable] = None
    # connector detail
    distribution: Optional[Distribution] = None
    # worker detail
    modifier: Sequence[Any] = ()
    host_only: bool = False  # not a tensor function (e.g. dict-building collectors)
    batched: bool = False  # fn consumes the whole item batch (leading axis) at once
    # collect detail
    init: Any = None
    finalise: Optional[Callable] = None
    jit_combine: bool = False  # True if collect fn is associative + on tensors
    # engine detail (IterativeEngine / StencilEngine wrap themselves here)
    engine: Any = None
    # distribution intent: mesh axis this node's FAN uses (kept for parity
    # with the JAX package's networks; one GPU has no mesh)
    axis: Any = None
    # CSP-model detail: symbolic function tag (workers of the same stage share
    # one — paper CSPm Def 7 gives each *stage* its own f); FAN nondeterminism
    tag: Any = None
    fan_any: bool = False  # OneFanAny: item may go to ANY successor

    def __post_init__(self) -> None:
        if self.kind in (Kind.SPREADER, Kind.REDUCER) and self.distribution is None:
            raise NetworkError(f"connector {self.name!r} needs a Distribution")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one tensor on a channel (a pytree leaf: the
    counterpart of ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ChannelDef:
    """A typed edge.  ``spec`` is an optional pytree of :class:`TensorSpec`
    used for early type checking.

    ``capacity`` is the CSP buffering depth of the channel: 0 means the
    classic unbuffered rendezvous (the paper's synchronous channel), ``k > 0``
    means up to ``k`` items may sit in the channel before the writer blocks.
    Compiled fused execution ignores it (the whole batch is one value on the
    wire); the streaming microbatch executor turns the network's minimum
    positive capacity into its bounded in-flight depth (backpressure).
    """

    src: str
    dst: str
    spec: Any = None
    capacity: int = 0


class NetworkError(ValueError):
    """Raised when gppBuilder-style validation refuses a network (paper §11.4)."""


class Network:
    """A declarative process network (the DSL object).

    Mirrors the paper's usage: the user instantiates processes and lists them;
    the builder synthesises channels and the parallel harness::

        net = Network("mcpi")
        net.add(Emit(...), OneFanAny(), Group(fn, workers=4), AnyFanOne(),
                Collect(...))

    ``add`` chains processes in declaration order (exactly the paper's
    Listing 3 semantics, where adjacency implies a channel).  Non-linear
    topologies use ``connect`` explicitly.
    """

    def __init__(self, name: str):
        self.name = name
        self.procs: dict[str, ProcessDef] = {}
        self.channels: list[ChannelDef] = []
        self.placement: dict[str, int] = {}  # explicit host pins (cluster)
        self._tail: Optional[str] = None
        self._frozen = False

    # -- construction -----------------------------------------------------
    def add(self, *procs: ProcessDef) -> "Network":
        """Append processes, auto-connecting each to the previous one."""
        self._check_mutable()
        for p in procs:
            self._register(p)
            if self._tail is not None:
                self.channels.append(ChannelDef(self._tail, p.name))
            self._tail = p.name
        return self

    def connect(self, src: str, dst: str, spec: Any = None, *,
                capacity: int = 0) -> "Network":
        self._check_mutable()
        for endpoint in (src, dst):
            if endpoint not in self.procs:
                raise NetworkError(f"connect: unknown process {endpoint!r}")
        if capacity < 0:
            raise NetworkError(f"connect: capacity must be >= 0, got {capacity}")
        self.channels.append(ChannelDef(src, dst, spec, capacity))
        return self

    def place(self, process: str, *, host: int) -> "Network":
        """Pin ``process`` to ``host`` for cluster deployment.

        Placement is advisory metadata consumed by
        the cluster planner: pinned processes keep their
        host, the rest are balanced automatically.  A network with no
        placements partitions fully automatically; a placement that would
        make the host graph cyclic (or cut an un-cuttable channel) is
        rejected by the planner, not here.
        """
        if process not in self.procs:
            raise NetworkError(f"place: unknown process {process!r}")
        if host < 0:
            raise NetworkError(f"place: host must be >= 0, got {host}")
        self.placement[process] = host
        return self

    def branch(self, at: str) -> "Network":
        """Continue ``add`` chaining from an earlier process (fan-out)."""
        self._check_mutable()
        if at not in self.procs:
            raise NetworkError(f"branch: unknown process {at!r}")
        self._tail = at
        return self

    def _register(self, p: ProcessDef) -> None:
        if p.name in self.procs:
            raise NetworkError(f"duplicate process name {p.name!r}")
        self.procs[p.name] = p

    def _check_mutable(self) -> None:
        if self._frozen:
            raise NetworkError("network already built; construct a new one")

    # -- graph views ------------------------------------------------------
    def successors(self, name: str) -> list[str]:
        return [c.dst for c in self.channels if c.src == name]

    def predecessors(self, name: str) -> list[str]:
        return [c.src for c in self.channels if c.dst == name]

    def emits(self) -> list[ProcessDef]:
        return [p for p in self.procs.values() if p.kind is Kind.EMIT]

    def collects(self) -> list[ProcessDef]:
        return [p for p in self.procs.values() if p.kind is Kind.COLLECT]

    def min_capacity(self) -> Optional[int]:
        """Smallest positive channel capacity, or None if all channels are
        unbuffered rendezvous.  The streaming executor uses this as its
        bounded in-flight depth (the tightest buffer backpressures the
        whole pipeline, exactly as in a CSP buffered-channel chain)."""
        caps = [c.capacity for c in self.channels if c.capacity > 0]
        return min(caps) if caps else None

    def toposort(self) -> list[str]:
        indeg = {n: 0 for n in self.procs}
        for c in self.channels:
            indeg[c.dst] += 1
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: list[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in self.successors(n):
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
            ready.sort()
        if len(order) != len(self.procs):
            raise NetworkError(f"network {self.name!r} contains a cycle")
        return order

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Network({self.name!r}, procs={list(self.procs)}, "
            f"channels={[(c.src, c.dst) for c in self.channels]})"
        )
