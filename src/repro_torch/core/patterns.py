"""Higher-level patterns (paper §3, §5): farms, pipelines, composites.

Each factory returns a fully-wired :class:`Network`, mirroring the paper's
one-liner patterns (``DataParallelCollect``, ``TaskParallelOfGroupCollects``,
``GroupOfPipelineCollects``, ``OnePipelineCollect``).

``explicit=True`` materialises one Worker node per parallel worker with
fan/merge connectors around them — the form used by the stream oracle and the
CSP model checker (it is the paper's Listing 3 expansion).  The default
(``explicit=False``) is the compiled form: a single vmapped Worker whose item
axis is sharded over ``axis`` — the SPMD realisation of the same network (the
two are proved trace-equivalent by tests/test_csp.py).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from .dataflow import Network
from .processes import (
    AnyFanOne,
    Collect,
    Emit,
    ListSeqOne,
    OneFanAny,
    OneFanList,
    Worker,
)

__all__ = [
    "DataParallelCollect",
    "OnePipelineCollect",
    "GroupOfPipelineCollects",
    "TaskParallelOfGroupCollects",
]


def _collect(collector, init, finalise, jit_combine):
    return Collect(collector, init=init, finalise=finalise,
                   jit_combine=jit_combine, name="collect")


def DataParallelCollect(
    *,
    create: Callable[[int], Any],
    function: Callable,
    collector: Callable,
    workers: int,
    init: Any = 0,
    finalise: Optional[Callable] = None,
    modifier: Sequence[Any] = (),
    axis: Any = None,
    jit_combine: bool = False,
    explicit: bool = False,
    name: str = "farm",
) -> Network:
    """The data-parallel farm (paper Listing 2 / Figure 2):
    Emit → OneFanAny → AnyGroupAny(workers) → AnyFanOne → Collect."""
    net = Network(name)
    net.add(Emit(create, name="emit"))
    if explicit:
        net.add(OneFanAny(destinations=workers, axis=axis, name="ofa"))
        wnames = []
        for w in range(workers):
            wn = f"worker{w}"
            net.procs[wn] = Worker(function, modifier=modifier, name=wn, tag="f")
            net.connect("ofa", wn)
            wnames.append(wn)
        net.procs["afo"] = AnyFanOne(sources=workers, name="afo")
        for wn in wnames:
            net.connect(wn, "afo")
        net._tail = "afo"
        net.add(_collect(collector, init, finalise, jit_combine))
    else:
        net.add(
            OneFanAny(destinations=workers, axis=axis, name="ofa"),
            Worker(function, modifier=modifier, name="group", tag="f"),
            AnyFanOne(sources=workers, name="afo"),
            _collect(collector, init, finalise, jit_combine),
        )
    return net


def OnePipelineCollect(
    *,
    create: Callable[[int], Any],
    stage_ops: Sequence[Callable],
    collector: Callable,
    init: Any = 0,
    finalise: Optional[Callable] = None,
    jit_combine: bool = False,
    name: str = "pipeline",
) -> Network:
    """Task-parallel pipeline ending in a Collect (paper §5.2).

    Must have ≥2 stages (paper's rule) — enforced here.
    """
    if len(stage_ops) < 2:
        raise ValueError("Pipelines always have at least two stages (paper §5.2)")
    net = Network(name)
    net.add(Emit(create, name="emit"))
    for s, op in enumerate(stage_ops):
        net.add(Worker(op, name=f"stage{s}", tag=f"s{s}"))
    net.add(_collect(collector, init, finalise, jit_combine))
    return net


def GroupOfPipelineCollects(
    *,
    create: Callable[[int], Any],
    stage_ops: Sequence[Callable],
    collector: Callable,
    groups: int,
    init: Any = 0,
    finalise: Optional[Callable] = None,
    axis: Any = None,
    jit_combine: bool = False,
    explicit: bool = False,
    name: str = "GoP",
) -> Network:
    """Group of pipelines (paper Listing 13): ``groups`` parallel pipelines,
    each a chain of ``stage_ops`` workers, merged into a single Collect."""
    net = Network(name)
    net.add(Emit(create, name="emit"))
    if explicit:
        net.add(OneFanList(destinations=groups, name="ofl"))
        last = []
        for g in range(groups):
            prev = "ofl"
            for s, op in enumerate(stage_ops):
                wn = f"p{g}s{s}"
                net.procs[wn] = Worker(op, name=wn, tag=f"s{s}")
                net.connect(prev, wn)
                prev = wn
            last.append(prev)
        net.procs["lso"] = ListSeqOne(name="lso")
        for wn in last:
            net.connect(wn, "lso")
        net._tail = "lso"
        net.add(_collect(collector, init, finalise, jit_combine))
    else:
        net.add(OneFanList(destinations=groups, axis=axis, name="ofl"))
        for s, op in enumerate(stage_ops):
            net.add(Worker(op, name=f"stage{s}", tag=f"s{s}"))
        net.add(ListSeqOne(name="lso"),
                _collect(collector, init, finalise, jit_combine))
    return net


def TaskParallelOfGroupCollects(
    *,
    create: Callable[[int], Any],
    stage_ops: Sequence[Callable],
    collector: Callable,
    workers: int,
    init: Any = 0,
    finalise: Optional[Callable] = None,
    axis: Any = None,
    jit_combine: bool = False,
    explicit: bool = False,
    name: str = "PoG",
) -> Network:
    """Pipeline of groups (paper Listing 14): each stage is a group of
    ``workers`` parallel Workers; groups are chained via connectors."""
    net = Network(name)
    net.add(Emit(create, name="emit"))
    if explicit:
        prev_merge = None
        for s, op in enumerate(stage_ops):
            fan = f"fan{s}"
            net.procs[fan] = OneFanList(destinations=workers, name=fan)
            net.connect(prev_merge if prev_merge else "emit", fan)
            merge = f"merge{s}"
            net.procs[merge] = ListSeqOne(name=merge)
            for w in range(workers):
                wn = f"g{s}w{w}"
                net.procs[wn] = Worker(op, name=wn, tag=f"s{s}")
                net.connect(fan, wn)
                net.connect(wn, merge)
            prev_merge = merge
        net._tail = prev_merge
        net.add(_collect(collector, init, finalise, jit_combine))
    else:
        net.add(OneFanList(destinations=workers, axis=axis, name="fan0"))
        for s, op in enumerate(stage_ops):
            net.add(Worker(op, name=f"group{s}", tag=f"s{s}"))
        net.add(ListSeqOne(name="lso"),
                _collect(collector, init, finalise, jit_combine))
    return net
