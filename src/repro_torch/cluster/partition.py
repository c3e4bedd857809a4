"""Host-assignment planning: split a verified Network across hosts.

The paper's capstone (§7) runs the same Mandelbrot farm unchanged on a
multicore machine and a workstation cluster; Kerridge's Cluster Builder DSL
partitions a GPP network over hosts by naming which processes run where.
This module is that planner for our networks:

* explicit pins via :meth:`..core.dataflow.Network.place`,
* an automatic balanced cut (:func:`auto_assignment`) that splits the
  topological order into contiguous host blocks weighted by functional
  stages (Workers/Engines carry the compute; connectors are cheap),
* per-host *subnetworks* with boundary shims: each cut channel ``a -> b``
  becomes ``a -> __xh_out__a__b`` (an egress Collect shim) on the producer
  host and ``__xh_in__a__b -> b`` (an ingress Emit shim) on the consumer
  host, so every partition is itself a legal GPP network (``verify`` passes)
  and is driven by the unmodified streaming executor.

Legality of a plan (:func:`partition` raises ``NetworkError`` otherwise):

* the host graph (processes contracted by host) is acyclic — transports are
  FIFO pipes, a host cycle would deadlock them,
* every cut channel's source has out-degree 1 — connector fan-outs are
  never split across hosts (a spreader and its branches co-locate),
* every host's subnetwork passes the gppBuilder legality check.

The refinement story (paper §6.1.1 lifted to deployment): the partitioned
network is modelled in CSP by replacing each cut channel with a transparent
relay process (a 1-in/1-out MERGE reducer — the transport), and
:func:`check_refinement` proves via :mod:`..core.csp` that this model
and the unpartitioned network trace-refine each other: same termination
guarantee, same collected outcome on every interleaving.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import csp
from ..core.dataflow import (ChannelDef, Distribution, Kind, Network,
                             NetworkError, ProcessDef)
from ..core.verify import verify

__all__ = [
    "PartitionPlan",
    "partition",
    "auto_assignment",
    "cost_assignment",
    "repartition_without",
    "ingress_shim",
    "egress_shim",
    "is_shim",
    "abstract_partitioned_model",
    "check_refinement",
    "check_redeployment",
]

_IN = "__xh_in__"
_OUT = "__xh_out__"


def ingress_shim(src: str, dst: str) -> str:
    return f"{_IN}{src}__{dst}"


def egress_shim(src: str, dst: str) -> str:
    return f"{_OUT}{src}__{dst}"


def is_shim(name: str) -> bool:
    return name.startswith(_IN) or name.startswith(_OUT)


@dataclasses.dataclass
class PartitionPlan:
    """A validated host assignment of one network."""

    net: Network
    assignment: dict[str, int]  # process name -> host
    n_hosts: int
    cut: list[ChannelDef] = dataclasses.field(default_factory=list)

    def hosts(self) -> list[int]:
        """Hosts that actually own processes, ascending."""
        return sorted(set(self.assignment.values()))

    def procs_of(self, host: int) -> list[str]:
        return [n for n, h in self.assignment.items() if h == host]

    def ingress_of(self, host: int) -> list[ChannelDef]:
        """Cut channels arriving at ``host``, in network channel order."""
        return [c for c in self.cut if self.assignment[c.dst] == host]

    def egress_of(self, host: int) -> list[ChannelDef]:
        """Cut channels leaving ``host``, in network channel order."""
        return [c for c in self.cut if self.assignment[c.src] == host]

    def subnetwork(self, host: int) -> Network:
        """The legal GPP network this host runs: local processes + boundary
        shims for every cut channel touching the host."""
        sub = Network(f"{self.net.name}@h{host}")
        local = set(self.procs_of(host))
        for name in self.net.toposort():
            if name in local:
                sub.procs[name] = self.net.procs[name]
        for c in self.net.channels:
            a_in, b_in = c.src in local, c.dst in local
            if a_in and b_in:
                sub.channels.append(c)
            elif a_in:  # egress: producer-side Collect shim
                shim = egress_shim(c.src, c.dst)
                sub.procs[shim] = ProcessDef(name=shim, kind=Kind.COLLECT,
                                             fn=None, host_only=True)
                sub.channels.append(
                    ChannelDef(c.src, shim, c.spec, c.capacity))
            elif b_in:  # ingress: consumer-side Emit shim
                shim = ingress_shim(c.src, c.dst)
                sub.procs[shim] = ProcessDef(name=shim, kind=Kind.EMIT,
                                             fn=None)
                sub.channels.append(
                    ChannelDef(shim, c.dst, c.spec, c.capacity))
        verify(sub)
        return sub

    def describe(self) -> str:
        lines = [f"partition of {self.net.name!r} over "
                 f"{len(self.hosts())} host(s):"]
        for h in self.hosts():
            lines.append(f"  host {h}: {', '.join(self.procs_of(h))}")
        for c in self.cut:
            lines.append(f"  cut: {c.src} -> {c.dst} "
                         f"(host {self.assignment[c.src]} -> "
                         f"{self.assignment[c.dst]}, capacity={c.capacity})")
        return "\n".join(lines)


def auto_assignment(net: Network, n_hosts: int) -> dict[str, int]:
    """Balanced contiguous cut of the topological order.

    Workers/Engines weigh 1 (they carry the compute), terminals and
    connectors 1/4 (so small networks still spread).  Contiguity in
    topological order makes the host graph acyclic by construction; a repair
    pass then co-locates every spreader's branches with the spreader itself
    (cut channels must have out-degree-1 sources), cascading in topo order.
    """
    order = net.toposort()
    weight = {n: 1.0 if net.procs[n].kind in (Kind.WORKER, Kind.ENGINE)
              else 0.25 for n in order}
    total = sum(weight.values())
    assignment: dict[str, int] = {}
    acc = 0.0
    for name in order:
        # host h owns the weight interval [h*total/n, (h+1)*total/n)
        h = min(n_hosts - 1, int(acc * n_hosts / total))
        assignment[name] = h
        acc += weight[name]
    return _repair_fans(net, assignment)


def _repair_fans(net: Network, assignment: dict[str, int]) -> dict[str, int]:
    """Co-locate every fan-out's branches with their spreader (cut channels
    must leave out-degree-1 sources); topo order cascades chained fans."""
    for name in net.toposort():
        succs = net.successors(name)
        if len(succs) > 1:
            for s in succs:
                assignment[s] = assignment[name]
    return assignment


def cost_assignment(net: Network, n_hosts: int, profile,
                    *, transport: Optional[str] = None) -> dict[str, int]:
    """Cut by measured *time*, not process count: choose the contiguous
    topological split whose bottleneck host — per-chunk stage time plus the
    transfer cost of the channels its block cuts — is minimal.

    ``profile`` is any object with ``time_of(name)`` (per-chunk stage
    seconds), ``out_bytes_of(name)`` (bytes of one output record) and
    ``transfer_s(nbytes, transport)`` — the JAX package's ``CostProfile``
    shape; measuring one is the cost-calibration slice's work;
    ``transport`` names the bandwidth used to price cut traffic.  Exact
    O(N²·H) interval DP over the topological order: ``f[h][i]`` = the best
    achievable bottleneck when the first ``i`` processes occupy ``h``
    hosts.  Fewer hosts than ``n_hosts`` are allowed — when one stage
    dwarfs the rest, splitting the cheap remainder only adds transfer cost.
    The result is an assignment dict for :func:`partition`, which validates
    it and emits just another provable :class:`PartitionPlan`.
    """
    if n_hosts < 1:
        raise NetworkError(
            f"cost_assignment: hosts must be >= 1, got {n_hosts}")
    order = net.toposort()
    n = len(order)
    pos = {name: i for i, name in enumerate(order)}
    stage_s = [profile.time_of(name) for name in order]
    # prefix sums: compute time of the contiguous block order[a:b]
    pref = [0.0]
    for s in stage_s:
        pref.append(pref[-1] + s)
    # channel transfer prices, by (src_pos, dst_pos)
    edges = [(pos[c.src], pos[c.dst],
              profile.transfer_s(profile.out_bytes_of(c.src), transport))
             for c in net.channels]

    def block_cost(a: int, b: int) -> float:
        """Per-chunk time of host block order[a:b]: its stages plus every
        channel crossing the block boundary (the host pays pack/unpack on
        both its ingress and its egress)."""
        t = pref[b] - pref[a]
        for sp, dp, price in edges:
            if (sp < a <= dp < b) or (a <= sp < b <= dp):
                t += price
        return t

    INF = float("inf")
    # f[h][i]: best bottleneck with order[:i] on h hosts; cut[h][i] = the j
    # achieving it (order[j:i] is host h-1's block)
    f = [[INF] * (n + 1) for _ in range(n_hosts + 1)]
    cutp = [[0] * (n + 1) for _ in range(n_hosts + 1)]
    f[0][0] = 0.0
    for h in range(1, n_hosts + 1):
        for i in range(1, n + 1):
            best, best_j = INF, 0
            for j in range(h - 1, i):
                if f[h - 1][j] == INF:
                    continue
                c = max(f[h - 1][j], block_cost(j, i))
                if c < best:
                    best, best_j = c, j
            f[h][i], cutp[h][i] = best, best_j
    h_best = min(range(1, n_hosts + 1), key=lambda h: f[h][n])
    assignment: dict[str, int] = {}
    i = n
    for h in range(h_best, 0, -1):
        j = cutp[h][i]
        for k in range(j, i):
            assignment[order[k]] = h - 1
        i = j
    return _repair_fans(net, assignment)


def partition(net: Network, *, hosts: Optional[int] = None,
              assignment: Optional[dict[str, int]] = None) -> PartitionPlan:
    """Plan a cluster deployment of ``net``.

    ``assignment`` (or ``net.placement`` pins merged over the automatic
    balanced cut) maps process names to hosts; validation raises
    ``NetworkError`` on an illegal cut.
    """
    verify(net)
    if assignment is None:
        if hosts is None:
            raise NetworkError("partition: need hosts= or assignment=")
        if hosts < 1:
            raise NetworkError(f"partition: hosts must be >= 1, got {hosts}")
        assignment = auto_assignment(net, hosts)
        assignment.update(net.placement)  # explicit pins win
    else:
        assignment = dict(assignment)
    missing = set(net.procs) - set(assignment)
    if missing:
        raise NetworkError(f"partition: no host for {sorted(missing)}")
    n_hosts = max(assignment.values()) + 1
    if min(assignment.values()) < 0:
        raise NetworkError("partition: negative host id")

    cut = [c for c in net.channels
           if assignment[c.src] != assignment[c.dst]]
    plan = PartitionPlan(net, assignment, n_hosts, cut)

    # host graph must be acyclic (FIFO transports cannot close a cycle)
    host_edges = {(assignment[c.src], assignment[c.dst]) for c in cut}
    if _has_cycle(plan.hosts(), host_edges):
        raise NetworkError(
            f"partition: host graph cyclic ({sorted(host_edges)}) — "
            "an assignment must be monotone along the dataflow")
    # cut channels leave only out-degree-1 sources (never split a fan)
    for c in cut:
        if len(net.successors(c.src)) != 1:
            raise NetworkError(
                f"partition: cannot cut {c.src!r} -> {c.dst!r}: "
                f"{c.src!r} fans out to {net.successors(c.src)}; a "
                "spreader and its branches must share a host")
    for h in plan.hosts():
        plan.subnetwork(h)  # raises NetworkError if a partition is illegal
    return plan


def repartition_without(plan: PartitionPlan,
                        failed_hosts) -> dict[str, int]:
    """Rebalance a live plan around failed hosts (the elastic control
    plane's planner reuse): every process owned by a host in
    ``failed_hosts`` is reassigned to a surviving host, preferring the
    nearest surviving *upstream* neighbour in dataflow order (which keeps
    the host graph acyclic and fans unsplit), falling back to the nearest
    downstream one, and — when no neighbour assignment validates — to the
    always-legal single-survivor plan (the whole network on one host, no
    cut at all).

    Returns a full assignment dict; feed it back through :func:`partition`
    so the new plan is validated and provable like any other."""
    net = plan.net
    failed = set(failed_hosts)
    survivors = [h for h in plan.hosts() if h not in failed]
    if not survivors:
        raise NetworkError(
            f"repartition_without: every host failed ({sorted(failed)}) — "
            "nothing left to rebalance onto")
    order = net.toposort()
    # dataflow position of each host = index of its first process
    first_pos = {h: min(order.index(p) for p in plan.procs_of(h))
                 for h in plan.hosts()}

    def _candidate(prefer_upstream: bool) -> dict[str, int]:
        assign = dict(plan.assignment)
        for h in sorted(failed, key=first_pos.get):
            ups = [s for s in survivors if first_pos[s] <= first_pos[h]]
            downs = [s for s in survivors if first_pos[s] > first_pos[h]]
            if prefer_upstream:
                target = max(ups, key=first_pos.get) if ups \
                    else min(downs, key=first_pos.get)
            else:
                target = min(downs, key=first_pos.get) if downs \
                    else max(ups, key=first_pos.get)
            for p in plan.procs_of(h):
                assign[p] = target
        return assign

    for prefer_upstream in (True, False):
        assign = _candidate(prefer_upstream)
        try:
            partition(net, assignment=assign)
            return assign
        except NetworkError:
            continue
    # always legal: everything on one survivor (no cut channels)
    lone = survivors[0]
    return {p: lone for p in net.procs}


def _has_cycle(nodes, edges) -> bool:
    succ: dict = {n: [] for n in nodes}
    for a, b in edges:
        succ[a].append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in nodes}

    def dfs(n):
        color[n] = GREY
        for m in succ[n]:
            if color[m] is GREY or (color[m] is WHITE and dfs(m)):
                return True
        color[n] = BLACK
        return False

    return any(color[n] is WHITE and dfs(n) for n in nodes)


# ==========================================================================
# CSP model of the partitioned network (paper §6.1.1 at deployment level)
# ==========================================================================

def abstract_partitioned_model(net: Network, plan: PartitionPlan,
                               name: str = "cut") -> Network:
    """The partitioned network as a CSP model: every cut channel becomes a
    transparent relay process (1-in/1-out MERGE reducer — the transport's
    FIFO pipe), everything else is unchanged.  Relays forward values and UT
    verbatim, so the model differs from the original only by the extra
    buffering stage — exactly what a ChannelTransport adds at runtime."""
    m = Network(f"{net.name}/{name}")
    for pname in net.procs:
        m.procs[pname] = net.procs[pname]
    cutset = {(c.src, c.dst) for c in plan.cut}
    for c in net.channels:
        if (c.src, c.dst) in cutset:
            relay = f"__relay__{c.src}__{c.dst}"
            m.procs[relay] = ProcessDef(
                name=relay, kind=Kind.REDUCER,
                distribution=Distribution.MERGE)
            m.channels.append(ChannelDef(c.src, relay, c.spec, c.capacity))
            m.channels.append(ChannelDef(relay, c.dst, c.spec, c.capacity))
        else:
            m.channels.append(c)
    return m


def check_refinement(net: Network, plan: PartitionPlan,
                     instances: int = 3, **kw) -> bool:
    """Both directions of the paper's ``[T=``: the partitioned model and the
    unpartitioned network are deadlock-free, terminating, and produce the
    identical (singleton) collected outcome on every interleaving."""
    part = abstract_partitioned_model(net, plan)
    return (csp.trace_equivalent(part, net, instances=instances, **kw)
            and csp.trace_equivalent(net, part, instances=instances, **kw))


def check_redeployment(net: Network, old_plan: PartitionPlan,
                       new_plan: PartitionPlan, instances: int = 3,
                       **kw) -> bool:
    """§6.1.1 lifted to *re*-deployment: when the control plane swaps plan
    epochs under a live network, the epoch-N+1 plan must be provably as
    good as the epoch-N one — not just "some valid plan".

    Three obligations, all mechanical:

    1. the new plan refines the original network in the outcome sense
       (:func:`check_refinement` — termination + identical singleton
       outcome on every interleaving);
    2. the new partitioned model's *observable trace set* is contained in
       the original network's (``net [T= model(new_plan)`` with the actual
       traces, not just outcomes — :func:`..core.csp.trace_refines`),
       so relay buffering introduces no collect-arrival ordering the
       unpartitioned network could not exhibit;
    3. the same containment against the *old* partitioned model, both
       directions — epoch N and epoch N+1 are observably the same
       deployment.

    Each of the three state spaces is explored exactly once (traces
    collected up front, containments compared on the sets): this check sits
    inside every live recovery, whose wall time the CI recovery rows gate.
    """
    old_m = abstract_partitioned_model(net, old_plan, name="epochN")
    new_m = abstract_partitioned_model(net, new_plan, name="epochN+1")
    results = {}
    for key, model in (("net", net), ("old", old_m), ("new", new_m)):
        r = csp.check(model, instances, collect_traces=True, **kw)
        if not (r.deadlock_free and r.all_paths_terminate):
            return False
        results[key] = r
    return (results["net"].outcomes == results["new"].outcomes
            and len(results["net"].outcomes) == 1
            and results["new"].traces <= results["net"].traces
            and results["new"].traces <= results["old"].traces
            and results["old"].traces <= results["new"].traces)
