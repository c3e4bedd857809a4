"""Static network verification — the gppBuilder legality check (paper §11.4).

The paper's builder "will refuse to create a process network that does not
ensure the correct communication structures between the processes"; a network
it accepts is then guaranteed deadlock/livelock free and terminating because
every component conforms to I/O-SEQ and UT propagation (§9.1, §4.6).

We reproduce that split:

* :func:`verify` — structural legality (this module).  Cheap, always run by
  the builder.  A network passing ``verify`` is in the class whose CSP models
  were proved correct (and which :mod:`.csp` can re-check
  mechanically for bounded instances).
* :mod:`.csp` — the FDR4-lite explicit-state checker that re-proves
  deadlock-freedom / termination / determinism per network instance.

Checks performed (each mirrors a paper requirement):

1. at least one Emit and at least one Collect (terminals exist),
2. acyclicity — I/O-SEQ composition is only proved for feed-forward nets;
   iteration lives *inside* engines,
3. every process lies on an Emit→Collect path (no orphan work, so UT reaches
   every process: termination),
4. arity conformance: Emit 0-in/1-out; Collect ≥1-in/0-out; Worker exactly
   1-in/1-out (I/O-SEQ); spreaders 1-in/≥1-out; reducers ≥1-in/1-out,
5. single-producer channels: a non-reducer never has >1 predecessor
   (the paper's "object references are never shared" invariant),
6. declared channel specs (if any) are consistent shape/dtype pytrees.
"""

from __future__ import annotations

from typing import Iterable

import torch.utils._pytree as pytree

from .dataflow import Kind, Network, NetworkError

__all__ = ["verify", "VerificationReport"]


class VerificationReport:
    """Evidence object returned by :func:`verify` (kept for logging/tests)."""

    def __init__(self) -> None:
        self.checks: list[tuple[str, str]] = []

    def record(self, check: str, detail: str = "ok") -> None:
        self.checks.append((check, detail))

    def __repr__(self) -> str:  # pragma: no cover
        return f"VerificationReport({self.checks})"


def _reachable(net: Network, roots: Iterable[str], forward: bool) -> set[str]:
    seen = set(roots)
    frontier = list(roots)
    step = net.successors if forward else net.predecessors
    while frontier:
        n = frontier.pop()
        for m in step(n):
            if m not in seen:
                seen.add(m)
                frontier.append(m)
    return seen


def verify(net: Network) -> VerificationReport:
    """Raise :class:`NetworkError` if the network is illegal; else return
    a report of the checks performed."""
    rep = VerificationReport()

    emits = net.emits()
    collects = net.collects()
    if not emits:
        raise NetworkError(f"{net.name}: no Emit terminal — nothing flows")
    if not collects:
        raise NetworkError(f"{net.name}: no Collect terminal — results are lost")
    rep.record("terminals", f"{len(emits)} emit(s), {len(collects)} collect(s)")

    # 2. acyclic (toposort raises on cycles)
    order = net.toposort()
    rep.record("acyclic", f"toposort over {len(order)} processes")

    # 3. reachability / co-reachability → UT reaches everyone
    fwd = _reachable(net, [e.name for e in emits], forward=True)
    bwd = _reachable(net, [c.name for c in collects], forward=False)
    for name in net.procs:
        if name not in fwd:
            raise NetworkError(
                f"{net.name}: process {name!r} unreachable from any Emit "
                "(UT would never arrive; it could not terminate)")
        if name not in bwd:
            raise NetworkError(
                f"{net.name}: process {name!r} cannot reach any Collect "
                "(its output is dropped; the channel write would block forever)")
    rep.record("reachability", "all processes on an Emit→Collect path")

    # 4/5. arity + single-producer
    for name, p in net.procs.items():
        nin = len(net.predecessors(name))
        nout = len(net.successors(name))
        if p.kind is Kind.EMIT:
            if nin != 0:
                raise NetworkError(f"{net.name}: Emit {name!r} has inputs")
            if nout < 1:
                raise NetworkError(f"{net.name}: Emit {name!r} has no output")
        elif p.kind is Kind.COLLECT:
            if nout != 0:
                raise NetworkError(f"{net.name}: Collect {name!r} has outputs")
            if nin < 1:
                raise NetworkError(f"{net.name}: Collect {name!r} has no input")
        elif p.kind in (Kind.WORKER, Kind.ENGINE):
            if nin != 1 or nout != 1:
                raise NetworkError(
                    f"{net.name}: {p.kind.value} {name!r} violates I/O-SEQ "
                    f"(needs exactly 1-in/1-out, has {nin}-in/{nout}-out)")
        elif p.kind is Kind.SPREADER:
            if nin != 1 or nout < 1:
                raise NetworkError(
                    f"{net.name}: spreader {name!r} needs 1-in/≥1-out, "
                    f"has {nin}/{nout}")
        elif p.kind is Kind.REDUCER:
            if nin < 1 or nout != 1:
                raise NetworkError(
                    f"{net.name}: reducer {name!r} needs ≥1-in/1-out, "
                    f"has {nin}/{nout}")
        # single-producer invariant (reducers exempt by definition)
        if p.kind is not Kind.REDUCER and p.kind is not Kind.COLLECT and nin > 1:
            raise NetworkError(
                f"{net.name}: {name!r} has {nin} producers but is not a "
                "reducer — object references would be shared")
    rep.record("arity", "I/O-SEQ conformance for all processes")

    # 6. channel spec consistency (best-effort; specs are optional)
    for c in net.channels:
        if c.spec is None:
            continue
        for leaf in pytree.tree_leaves(c.spec):
            if not hasattr(leaf, "shape") or not hasattr(leaf, "dtype"):
                raise NetworkError(
                    f"{net.name}: channel {c.src}->{c.dst} spec leaf {leaf!r} "
                    "is not shape/dtype-typed")
    rep.record("channel-specs", "declared specs well-formed")
    return rep
