"""FDR4-lite: a bounded explicit-state CSP model checker for GPP networks.

The paper proves its process library correct by writing CSPm models of Emit /
Spread / Workers / Reduce / Collect and checking them in FDR4 (§4.6, CSPm
Definitions 1–6), and proves Pipeline-of-Groups ≡ Group-of-Pipelines by
refinement (§6.1.1, CSPm Definition 7).  FDR is not available here, so this
module re-implements the needed fragment:

* each GPP process becomes a small labelled transition system (LTS) with
  synchronous point-to-point channel events and UT (UniversalTerminator)
  propagation — transcribed from the paper's CSPm definitions;
* the network is their synchronous parallel composition; we BFS the global
  state space and check

  - **deadlock freedom**: every non-final reachable state has an enabled event,
  - **divergence freedom**: the model has no internal (tau) actions, and the
    reachable graph of a finite-emission network is acyclic ⇒ no livelock,
  - **termination**: every maximal path ends with all processes DONE,
  - **determinism** (observable): all terminal states agree on the multiset
    of values received by each Collect,
  - **trace refinement / equivalence**: the sets of observable traces (events
    on channels into Collect processes, internals hidden) of two networks are
    compared — the paper's ``[T=`` check in both directions.

Values are symbolic: items are ``('i', k)`` and a worker tagged ``f`` maps
``v ↦ ('f', v)``, so pipeline composition is visible in the traces exactly as
in CSPm Definition 1's ``create()`` chain.

State spaces are tiny for the unit networks being checked (the same networks
the paper checks), so plain BFS suffices; ``max_states`` guards runaways.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Hashable, Optional

from .dataflow import Distribution, Kind, Network

__all__ = ["CSPModel", "ExplorationResult", "check", "trace_equivalent",
           "trace_refines", "trace_chain_refines"]

UT = "UT"
DONE = ("done",)


@dataclasses.dataclass
class _Proc:
    name: str
    kind: Kind
    dist: Optional[Distribution]
    ins: tuple  # ordered channel ids
    outs: tuple
    tag: str  # symbolic function name for workers
    fan_any: bool = False


def _channels(net: Network) -> list[tuple[str, str]]:
    return [(c.src, c.dst) for c in net.channels]


class CSPModel:
    """Synchronous composition of the per-process LTSs of ``net``."""

    def __init__(self, net: Network, instances: int):
        self.net = net
        self.n = instances
        self.chans = _channels(net)
        self.procs: list[_Proc] = []
        order = list(net.procs)  # cycles allowed: the checker
        # itself detects the deadlocks they cause
        for name in order:
            p = net.procs[name]
            ins = tuple(c for c in self.chans if c[1] == name)
            outs = tuple(c for c in self.chans if c[0] == name)
            self.procs.append(_Proc(name, p.kind, p.distribution, ins, outs,
                                    tag=p.tag if p.tag is not None else name,
                                    fan_any=p.fan_any))
        self.index = {p.name: i for i, p in enumerate(self.procs)}
        # observable alphabet: channels whose reader is a Collect
        self.observable = {c for c in self.chans
                           if net.procs[c[1]].kind is Kind.COLLECT}

    # -- initial local states ------------------------------------------------
    def _init_state(self, p: _Proc) -> tuple:
        if p.kind is Kind.EMIT:
            return ("emit", 0)
        if p.kind is Kind.SPREADER:
            if p.dist is Distribution.FAN:
                return ("read", 0)  # rr counter
            return ("read",)
        if p.kind in (Kind.WORKER, Kind.ENGINE):
            return ("read",)
        if p.kind is Kind.REDUCER:
            if p.dist is Distribution.COMBINE:
                return ("comb", frozenset(), ())
            return ("merge", frozenset())
        if p.kind is Kind.COLLECT:
            return ("coll", frozenset(), ())
        raise AssertionError(p.kind)

    # -- offers ---------------------------------------------------------------
    # an offer is ('w', chan, value) or ('r', chan); rendezvous pairs them.
    def _offers(self, p: _Proc, s: tuple) -> list[tuple]:
        k = s[0]
        if s == DONE or k == "done_collect":
            return []
        if p.kind is Kind.EMIT:
            if k == "emit":
                i = s[1]
                if i < self.n:
                    rr = i % len(p.outs)
                    return [("w", p.outs[rr], ("i", i))]
                return [("w", p.outs[0], UT)] if p.outs else []
            if k == "emit_ut":
                return [("w", p.outs[s[1]], UT)]
        elif p.kind is Kind.SPREADER:
            if k == "read":
                return [("r", p.ins[0])]
            if k == "write":  # FAN round-robin: pending item to outs[rr]
                return [("w", p.outs[s[2]], s[1])]
            if k == "writeany":  # OneFanAny: any free successor may take it
                return [("w", c, s[1]) for c in p.outs]
            if k == "cast":  # SEQ_CAST: copy k-th
                return [("w", p.outs[s[2]], s[1])]
            if k == "castp":  # PAR_CAST: any remaining, nondeterministic
                return [("w", c, s[1]) for c in s[2]]
            if k == "ut":
                return [("w", p.outs[s[1]], UT)]
        elif p.kind in (Kind.WORKER, Kind.ENGINE):
            if k == "read":
                return [("r", p.ins[0])]
            if k == "write":
                return [("w", p.outs[0], s[1])]
            if k == "wut":
                return [("w", p.outs[0], UT)]
        elif p.kind is Kind.REDUCER:
            if k in ("merge", "comb"):
                closed = s[1]
                return [("r", c) for c in p.ins if c not in closed]
            if k == "mwrite":
                return [("w", p.outs[0], s[1])]
            if k == "cwrite":
                return [("w", p.outs[0], ("comb", s[1]))]
            if k in ("mut", "cut"):
                return [("w", p.outs[0], UT)]
        elif p.kind is Kind.COLLECT:
            if k == "coll":
                closed = s[1]
                return [("r", c) for c in p.ins if c not in closed]
        return []

    # -- local steps ------------------------------------------------------------
    def _after_write(self, p: _Proc, s: tuple, chan) -> tuple:
        k = s[0]
        if p.kind is Kind.EMIT:
            if k == "emit":
                i = s[1]
                if i < self.n:
                    return ("emit", i + 1)
                # wrote UT on outs[0]
                return ("emit_ut", 1) if len(p.outs) > 1 else DONE
            if k == "emit_ut":
                j = s[1] + 1
                return ("emit_ut", j) if j < len(p.outs) else DONE
        elif p.kind is Kind.SPREADER:
            if k == "write":
                return ("read", (s[2] + 1) % len(p.outs))
            if k == "writeany":
                return ("read", s[2])
            if k == "cast":
                j = s[2] + 1
                return ("cast", s[1], j) if j < len(p.outs) else ("read",)
            if k == "castp":
                rem = s[2] - {chan}
                return ("castp", s[1], rem) if rem else ("read",)
            if k == "ut":
                j = s[1] + 1
                return ("ut", j) if j < len(p.outs) else DONE
        elif p.kind in (Kind.WORKER, Kind.ENGINE):
            if k == "write":
                return ("read",)
            if k == "wut":
                return DONE
        elif p.kind is Kind.REDUCER:
            if k == "mwrite":
                return ("merge", s[2])
            if k == "cwrite":
                return ("cut",)
            if k == "mut" or k == "cut":
                return DONE
        raise AssertionError((p.name, s, "write"))

    def _after_read(self, p: _Proc, s: tuple, chan, value) -> tuple:
        k = s[0]
        if p.kind is Kind.SPREADER:
            if value == UT:
                return ("ut", 0)
            if p.dist is Distribution.FAN:
                if p.fan_any:
                    return ("writeany", value, s[1])
                return ("write", value, s[1])
            if p.dist is Distribution.SEQ_CAST:
                return ("cast", value, 0)
            return ("castp", value, frozenset(p.outs))
        if p.kind in (Kind.WORKER, Kind.ENGINE):
            if value == UT:
                return ("wut",)
            # a tuple tag is a fused stage chain: apply each component in
            # order, nesting exactly as the unfused chain of workers would —
            # fusion is function composition, observably nothing more
            if isinstance(p.tag, tuple):
                v = value
                for t in p.tag:
                    v = (t, v)
                return ("write", v)
            return ("write", (p.tag, value))
        if p.kind is Kind.REDUCER:
            closed = s[1]
            if p.dist is Distribution.COMBINE:
                acc = s[2]
                if value == UT:
                    closed = closed | {chan}
                    if len(closed) == len(p.ins):
                        return ("cwrite", acc)
                    return ("comb", closed, acc)
                return ("comb", closed, tuple(sorted(acc + (value,), key=repr)))
            # MERGE
            if value == UT:
                closed = closed | {chan}
                if len(closed) == len(p.ins):
                    return ("mut",)
                return ("merge", closed)
            return ("mwrite", value, closed)
        if p.kind is Kind.COLLECT:
            closed, acc = s[1], s[2]
            if value == UT:
                closed = closed | {chan}
                if len(closed) == len(p.ins):
                    return ("done_collect", acc)
                return ("coll", closed, acc)
            return ("coll", closed, tuple(sorted(acc + (value,), key=repr)))
        raise AssertionError((p.name, s, "read"))

    # -- global exploration -------------------------------------------------
    def initial(self) -> tuple:
        return tuple(self._init_state(p) for p in self.procs)

    def transitions(self, gs: tuple) -> list[tuple[tuple, tuple]]:
        """Enabled rendezvous: returns [(event, next_global_state)].

        event = (channel, value)."""
        writers: dict[Any, list[tuple[int, Any]]] = {}
        readers: dict[Any, list[int]] = {}
        for i, p in enumerate(self.procs):
            for off in self._offers(p, gs[i]):
                if off[0] == "w":
                    writers.setdefault(off[1], []).append((i, off[2]))
                else:
                    readers.setdefault(off[1], []).append(i)
        out = []
        for chan, ws in writers.items():
            for (wi, val) in ws:
                for ri in readers.get(chan, ()):
                    ns = list(gs)
                    ns[wi] = self._after_write(self.procs[wi], gs[wi], chan)
                    ns[ri] = self._after_read(self.procs[ri], gs[ri], chan, val)
                    out.append(((chan, val), tuple(ns)))
        return out

    def is_final(self, gs: tuple) -> bool:
        return all(s == DONE or s[0] == "done_collect" for s in gs)

    def outcome(self, gs: tuple) -> tuple:
        """Multiset of values received by each Collect, at a final state."""
        return tuple(s[1] for s in gs if s[0] == "done_collect")


@dataclasses.dataclass
class ExplorationResult:
    n_states: int
    deadlocks: list
    outcomes: set
    acyclic: bool
    all_paths_terminate: bool
    traces: Optional[set] = None

    @property
    def deadlock_free(self) -> bool:
        return not self.deadlocks

    @property
    def deterministic(self) -> bool:
        return len(self.outcomes) <= 1

    @property
    def divergence_free(self) -> bool:
        # no tau actions exist in the model; livelock requires a cycle
        return self.acyclic


def check(net: Network, instances: int = 3, *, max_states: int = 500_000,
          collect_traces: bool = False) -> ExplorationResult:
    """Explore the full state space and evaluate the paper's assertions
    (CSPm Definition 6): deadlock-free, divergence-free, deterministic,
    terminating."""
    m = CSPModel(net, instances)
    init = m.initial()
    seen = {init}
    frontier = deque([init])
    deadlocks = []
    outcomes = set()
    edges = 0
    succ_cache: dict[tuple, list] = {}
    while frontier:
        gs = frontier.popleft()
        trs = m.transitions(gs)
        succ_cache[gs] = [ns for _, ns in trs]
        edges += len(trs)
        if not trs:
            if m.is_final(gs):
                outcomes.add(m.outcome(gs))
            else:
                deadlocks.append(gs)
        for _, ns in trs:
            if ns not in seen:
                seen.add(ns)
                if len(seen) > max_states:
                    raise RuntimeError(
                        f"state space exceeds max_states={max_states}")
                frontier.append(ns)
    acyclic = _is_dag(init, succ_cache)
    # with acyclicity + no deadlocks, every maximal path ends in a final state
    all_term = acyclic and not deadlocks
    traces = None
    if collect_traces:
        traces = _observable_traces(m, init, max_traces=200_000)
    return ExplorationResult(len(seen), deadlocks, outcomes, acyclic,
                             all_term, traces)


def _is_dag(init, succ: dict) -> bool:
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict = {}
    stack = [(init, iter(succ.get(init, ())))]
    color[init] = GREY
    while stack:
        node, it = stack[-1]
        advanced = False
        for nxt in it:
            c = color.get(nxt, WHITE)
            if c == GREY:
                return False
            if c == WHITE:
                color[nxt] = GREY
                stack.append((nxt, iter(succ.get(nxt, ()))))
                advanced = True
                break
        if not advanced:
            color[node] = BLACK
            stack.pop()
    return True


def _observable_traces(m: CSPModel, init, max_traces: int) -> set:
    """All observable traces (events on channels into Collects, hidden rest).

    Memoised DFS over (state → set of observable suffix-traces)."""
    memo: dict[tuple, frozenset] = {}

    def suffixes(gs: tuple) -> frozenset:
        if gs in memo:
            return memo[gs]
        memo[gs] = frozenset()  # cycle guard (graph is a DAG for finite n)
        trs = m.transitions(gs)
        if not trs:
            memo[gs] = frozenset({()})
            return memo[gs]
        acc = set()
        for (chan, val), ns in trs:
            tails = suffixes(ns)
            if chan in m.observable:
                ev = (chan[1], val)  # (collect_name, value)
                acc.update((ev,) + t for t in tails)
            else:
                acc.update(tails)
            if len(acc) > max_traces:
                raise RuntimeError("trace set exceeds max_traces")
        memo[gs] = frozenset(acc)
        return memo[gs]

    return set(suffixes(init))


def trace_equivalent(net_a: Network, net_b: Network, instances: int = 3,
                     **kw) -> bool:
    """Paper §6.1.1 (CSPm Definition 7): GoP ≡ PoG refinement.

    Note on faithfulness: FDR's assertion in Definition 7 hides *all* data
    channels ``{|a..f|}``, so the observable alphabet is only the Collect's
    ``finished`` signal — the mechanical check is *termination equivalence*.
    The paper's prose additionally claims both topologies "produce the same
    result".  We check both, and the second is strictly stronger:

    1. both networks are deadlock-free and all paths terminate
       (≡ the paper's mutual ``[T=`` after hiding), and
    2. the sets of possible final collected outcomes (multiset of values per
       Collect) are identical and singleton — same result on every schedule.

    (Raw collect-arrival *orderings* differ between the two topologies — a
    pipeline preserves FIFO order per lane while staged groups can reorder
    across stages — which is exactly why FDR must hide the data channels for
    the refinement to hold.  tests/test_csp.py pins this asymmetry.)
    """
    ra = check(net_a, instances, **kw)
    rb = check(net_b, instances, **kw)
    if not (ra.deadlock_free and ra.all_paths_terminate):
        return False
    if not (rb.deadlock_free and rb.all_paths_terminate):
        return False
    return ra.outcomes == rb.outcomes and len(ra.outcomes) == 1


def trace_refines(spec: Network, impl: Network, instances: int = 3,
                  **kw) -> bool:
    """FDR's actual ``spec [T= impl`` on the *observable trace sets* (events
    on channels into Collects, internals hidden): every observable trace the
    implementation can exhibit, the specification can too.

    This is strictly finer than :func:`trace_equivalent`'s outcome check —
    it compares arrival *orderings*, not just final multisets — which is
    what re-deployment (:func:`repro.cluster.partition.check_redeployment`)
    needs: a swapped plan must not introduce a collect-arrival interleaving
    the original network could never produce.  Traces compare on the
    ``(collect, value)`` events themselves, so the two networks may have
    entirely different internal topology (relays, shims) as long as the
    observable behaviour is contained."""
    rs = check(spec, instances, collect_traces=True, **kw)
    ri = check(impl, instances, collect_traces=True, **kw)
    return ri.traces <= rs.traces


def trace_chain_refines(spec: Network, impls, instances: int = 3,
                        **kw) -> bool:
    """The elastic control plane's §6.1.1 obligation over the WHOLE life of
    a deployment: ``spec`` is the original network, ``impls`` the partitioned
    models of every plan epoch it ran (epoch 1, then one per recovery).
    Each state space is explored exactly once, then — mechanically:

    1. the spec and every epoch model are deadlock-free and terminating,
    2. every epoch model's final-outcome set equals the spec's (singleton:
       the same result on every interleaving),
    3. every epoch model's observable trace set is contained in the spec's
       (``spec [T= model``), and *consecutive* epochs' trace sets are equal
       — epoch N and N+1 are observably the same deployment, not merely
       both valid ones.

    :func:`repro.cluster.partition.check_redeployment` is the pairwise
    (N, N+1) instance of this; the fault-injection simulator
    (:mod:`repro.cluster.sim`) calls the chained form once per scenario
    over every epoch its fault schedule produced — calling
    :func:`trace_refines` pairwise instead would re-explore each epoch's
    state space up to three times."""
    rs = check(spec, instances, collect_traces=True, **kw)
    if not (rs.deadlock_free and rs.all_paths_terminate
            and len(rs.outcomes) == 1):
        return False
    prev_traces = None
    for impl in impls:
        ri = check(impl, instances, collect_traces=True, **kw)
        if not (ri.deadlock_free and ri.all_paths_terminate):
            return False
        if ri.outcomes != rs.outcomes or not ri.traces <= rs.traces:
            return False
        if prev_traces is not None and ri.traces != prev_traces:
            return False
        prev_traces = ri.traces
    return True
