"""The GPP process constructors (paper §4.3–§4.5), as ProcessDef factories.

Names follow the paper exactly so the examples read like the paper's listings:
``Emit``, ``Collect``, ``Worker``, spreaders ``OneFanAny``/``OneFanList``/
``OneSeqCastList``/``OneParCastList``, reducers ``AnyFanOne``/``ListSeqOne``/
``CombineNto1``.

Each call returns a :class:`.dataflow.ProcessDef`; semantics are
given to them by the builder (fused program) or the stream interpreter
(host-level, faithful CSP-ish semantics used as the sequential oracle).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional, Sequence

from .dataflow import Distribution, Kind, ProcessDef

__all__ = [
    "Emit",
    "EmitWithLocal",
    "Collect",
    "Worker",
    "OneFanAny",
    "OneFanList",
    "OneSeqCastList",
    "OneParCastList",
    "AnyFanOne",
    "ListSeqOne",
    "ListParOne",
    "CombineNto1",
]

_counter = itertools.count()


def _auto(name: Optional[str], prefix: str) -> str:
    return name if name is not None else f"{prefix}{next(_counter)}"


# --------------------------------------------------------------------------
# terminals
# --------------------------------------------------------------------------

def Emit(create: Callable[[int], Any], *, name: Optional[str] = None) -> ProcessDef:
    """Terminal source (paper §4.3.1).

    ``create(i)`` returns the i-th data object.  The number of instances is
    supplied at run time (paper: ``normalTermination`` return); in compiled
    mode the batch size is the instance count.
    """
    return ProcessDef(name=_auto(name, "emit"), kind=Kind.EMIT, fn=create)


def EmitWithLocal(
    create: Callable[[int, Any], tuple[Any, Any]],
    local_init: Callable[[], Any],
    *,
    name: Optional[str] = None,
) -> ProcessDef:
    """Emit with a local helper object (paper §6.5, Goldbach's sieve).

    ``create(i, local) -> (item, local)`` threads local state through the
    emission loop (a scan carry in compiled mode).
    """
    p = ProcessDef(name=_auto(name, "emitL"), kind=Kind.EMIT, fn=create)
    p.modifier = (local_init,)
    return p


def Collect(
    collector: Callable[[Any, Any], Any],
    *,
    init: Any = 0,
    finalise: Optional[Callable[[Any], Any]] = None,
    jit_combine: bool = False,
    host_only: bool = False,
    name: Optional[str] = None,
) -> ProcessDef:
    """Terminal sink (paper §4.3.3): fold ``collector`` over arriving items,
    then ``finalise`` the accumulator.

    ``jit_combine=True`` declares the fold associative and a function on
    tensors, so the builder may evaluate it on the device inside the fused
    program (the fastest path).  Otherwise the fold runs host-side over the
    batched worker outputs — the paper's collector semantics exactly.
    """
    return ProcessDef(
        name=_auto(name, "collect"),
        kind=Kind.COLLECT,
        fn=collector,
        init=init,
        finalise=finalise,
        jit_combine=jit_combine,
        host_only=host_only,
    )


# --------------------------------------------------------------------------
# functionals
# --------------------------------------------------------------------------

def Worker(
    fn: Callable,
    *,
    modifier: Sequence[Any] = (),
    host_only: bool = False,
    batched: bool = False,
    tag: Optional[str] = None,
    name: Optional[str] = None,
) -> ProcessDef:
    """The basic functional (paper §4.4): ``fn(item, *modifier) -> item``.

    Conforms to I/O-SEQ: one input channel, one output channel, one compute
    phase.  The builder checks this structurally (verify.py).

    ``batched=True`` declares that ``fn`` consumes the whole item batch at
    once (leading axis = instances) instead of being vmapped per item — used
    by the LM layers where an "item" is a global batch.
    """
    return ProcessDef(
        name=_auto(name, "worker"),
        kind=Kind.WORKER,
        fn=fn,
        modifier=tuple(modifier),
        host_only=host_only,
        batched=batched,
        tag=tag,
    )


# --------------------------------------------------------------------------
# connectors: spreaders (paper §4.5.1)
# --------------------------------------------------------------------------

def OneFanAny(*, destinations: int = 0, axis: Any = None,
              name: Optional[str] = None) -> ProcessDef:
    """One input; each item goes to *any* free consumer (work-stealing farm).

    Compiled realisation: block sharding of the item batch over ``axis``
    (dynamic work distribution has no SPMD analogue inside a step; at the
    host layer the serving scheduler provides the any-channel semantics).
    """
    del destinations  # arity comes from the graph; kept for paper parity
    return ProcessDef(
        name=_auto(name, "ofa"), kind=Kind.SPREADER,
        distribution=Distribution.FAN, axis=axis, fan_any=True,
    )


def OneFanList(*, destinations: int = 0, axis: Any = None,
               name: Optional[str] = None) -> ProcessDef:
    """One input; items round-robin across an indexed channel list.

    Compiled realisation: *static* block sharding over ``axis`` — identical
    tensor layout to OneFanAny; the any/list distinction matters only for the
    host-level stream interpreter and the CSP model.
    """
    del destinations
    return ProcessDef(
        name=_auto(name, "ofl"), kind=Kind.SPREADER,
        distribution=Distribution.FAN, axis=axis,
    )


def OneSeqCastList(*, axis: Any = None, name: Optional[str] = None) -> ProcessDef:
    """Broadcast a deep copy of each item to all successors, sequentially.

    Compiled realisation: every successor reads the same tensor.  Stage
    functions return new tensors and never write their inputs, so the
    paper's deep-copy requirement holds without a copy.
    """
    return ProcessDef(
        name=_auto(name, "oscl"), kind=Kind.SPREADER,
        distribution=Distribution.SEQ_CAST, axis=axis,
    )


def OneParCastList(*, axis: Any = None, name: Optional[str] = None) -> ProcessDef:
    """Broadcast in parallel — same compiled form as OneSeqCastList."""
    return ProcessDef(
        name=_auto(name, "opcl"), kind=Kind.SPREADER,
        distribution=Distribution.PAR_CAST, axis=axis,
    )


# --------------------------------------------------------------------------
# connectors: reducers (paper §4.5.3)
# --------------------------------------------------------------------------

def AnyFanOne(*, sources: int = 0, axis: Any = None,
              name: Optional[str] = None) -> ProcessDef:
    """Many writers, one reader, arrival order (fairSelect).

    Compiled realisation: all-gather along ``axis`` (device order; arrival
    order is meaningless once the step is a single program)."""
    del sources
    return ProcessDef(
        name=_auto(name, "afo"), kind=Kind.REDUCER,
        distribution=Distribution.MERGE, axis=axis,
    )


def ListSeqOne(*, axis: Any = None, name: Optional[str] = None) -> ProcessDef:
    """Indexed channel list read in order → ordered all-gather."""
    return ProcessDef(
        name=_auto(name, "lso"), kind=Kind.REDUCER,
        distribution=Distribution.MERGE, axis=axis,
    )


def ListParOne(*, axis: Any = None, name: Optional[str] = None) -> ProcessDef:
    """Read all inputs in parallel, output the list — all-gather."""
    return ProcessDef(
        name=_auto(name, "lpo"), kind=Kind.REDUCER,
        distribution=Distribution.MERGE, axis=axis,
    )


def CombineNto1(
    combine: Callable[[Any, Any], Any],
    *,
    axis: Any = None,
    name: Optional[str] = None,
) -> ProcessDef:
    """Fold all inputs into one object (paper §6.5).

    ``combine`` must be associative; compiled realisation is a tree reduction
    (psum when combine is addition over arrays).
    """
    return ProcessDef(
        name=_auto(name, "combine"), kind=Kind.REDUCER,
        distribution=Distribution.COMBINE, fn=combine, axis=axis,
    )
