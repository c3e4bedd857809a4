"""Network-log visualisation — the paper's §13 "Further Work", delivered.

The paper reports a prototype that visualises log output to locate
bottlenecks, limited to specific patterns; here the visualisation is derived
from the network itself (their stated goal: "deduced from the DSL
specification"): stage timeline bars scaled by wall time, annotated with
per-stage HLO cost, plus the network topology.
"""

from __future__ import annotations

from typing import Sequence

from .builder import CompiledNetwork, StageLog
from .dataflow import Network

__all__ = ["timeline", "topology", "report", "cluster_report"]

_BAR = "█"


def timeline(logs: Sequence[StageLog], width: int = 48) -> str:
    """ASCII Gantt of per-stage wall time (longest bar = bottleneck)."""
    if not logs:
        return "(no logged stages — run with logged=True)"
    if not any(l.wall_s for l in logs):
        # a run too fast for the clock: full-width bars would scream
        # "bottleneck everywhere" about nothing — say what happened instead
        lines = ["stage                     time      share  timeline"]
        lines.extend(f"{l.stage:<24} {0.0:8.2f}ms    -  (no measurable time)"
                     for l in logs)
        return "\n".join(lines)
    total = sum(l.wall_s for l in logs) or 1e-12
    peak = max(l.wall_s for l in logs) or 1e-12
    lines = ["stage                     time      share  timeline"]
    for l in logs:
        n = max(1, round(width * l.wall_s / peak))
        share = 100 * l.wall_s / total
        lines.append(f"{l.stage:<24} {l.wall_s*1e3:8.2f}ms {share:5.1f}%  "
                     f"{_BAR * n}")
    worst = max(logs, key=lambda l: l.wall_s)
    ai = ""
    if worst.flops and worst.bytes_accessed:
        ai = (f" (arithmetic intensity "
              f"{worst.flops / worst.bytes_accessed:.2f} flop/B)")
    lines.append(f"bottleneck: {worst.stage}{ai}")
    return "\n".join(lines)


def topology(net: Network) -> str:
    """One-line-per-process network rendering, deduced from the DSL spec."""
    lines = [f"network {net.name!r}:"]
    for name in net.toposort():
        p = net.procs[name]
        succs = net.successors(name)
        arrow = " -> " + ", ".join(succs) if succs else "  (sink)"
        kind = p.kind.value
        if p.distribution is not None:
            kind += f"/{p.distribution.value}"
        lines.append(f"  [{kind:<16}] {name}{arrow}")
    return "\n".join(lines)


def report(cn: CompiledNetwork) -> str:
    """Full §8-style report: topology + timeline of the last logged run."""
    return topology(cn.net) + "\n\n" + timeline(cn.logs)


def _fmt_rate(bps: float) -> str:
    for unit in ("B/s", "KB/s", "MB/s", "GB/s"):
        if abs(bps) < 1024.0 or unit == "GB/s":
            return f"{bps:.1f}{unit}"
        bps /= 1024.0
    return f"{bps:.1f}GB/s"


def cluster_report(plan, reports, events=None, depths=None,
                   durability=None) -> str:
    """Cross-host §8 report: per-host partition, streaming telemetry,
    per-channel bytes/s (when the hosts sampled transport byte counters),
    per-channel chunk counts by path on the shared-memory ring (``ring
    slot=N inline=M``, from the sender's ``metrics["ring"]``),
    captured failures (the paper's error-capture mechanism at cluster
    scale), and — when the elastic control plane has recovered the
    deployment — one ``recovery`` line per plan-epoch swap.

    ``plan`` is a :class:`..cluster.partition.PartitionPlan`; ``reports``
    a list of :class:`..cluster.runtime.HostReport`; ``events`` an
    optional list of :class:`..cluster.control.RecoveryEvent` (any event
    with a ``describe()`` renders in the same list);
    ``depths`` an optional live ``{"src->dst": queue depth}`` sample
    (:meth:`ChannelTransport.channel_depths`); ``durability`` an optional
    list of :class:`..cluster.durable.DurabilityEvent` (controller-meta
    snapshots, replay-from-snapshot restores, adopts), rendered in order
    with per-event host dicts sorted.  Pure formatting — no cluster
    imports, so the core stays dependency-free.

    The rendering is DETERMINISTIC in the report/event *content*: hosts are
    sorted, capacity merges walk reports in host order, and per-event dicts
    render sorted — so the fault-injection simulator can assert golden
    report snapshots regardless of which host thread reported first."""
    chosen: dict = {}  # "src->dst" -> FIFO depth actually deployed
    epoch = 1
    sent: dict = {}    # "src->dst" -> (bytes, wall_s) from the sender host
    ring: dict = {}    # "src->dst" -> (slot, inline) chunks, shm senders
    for r in sorted(reports, key=lambda r: r.host):
        chosen.update(getattr(r, "capacities", None) or {})
        epoch = max(epoch, getattr(r, "epoch", 1))
        m = getattr(r, "metrics", None) or {}
        for chan, nbytes in (m.get("sent_bytes") or {}).items():
            sent[chan] = (nbytes, m.get("wall_s") or 0.0)
        ring.update(m.get("ring") or {})
    lines = [f"== cluster: {plan.net.name} over {len(reports)} host(s), "
             f"plan epoch {epoch} =="]
    for c in plan.cut:
        key = f"{c.src}->{c.dst}"
        cap = c.capacity or chosen.get(key) or "default"
        extra = ""
        if key in sent:
            nbytes, wall = sent[key]
            extra += (f", {_fmt_rate(nbytes / wall)}" if wall
                      else f", {nbytes}B")
        if key in ring:
            extra += f", ring slot={ring[key][0]} inline={ring[key][1]}"
        if depths and key in depths and depths[key] >= 0:
            extra += f", depth={depths[key]}"
        lines.append(f"  channel {c.src} -> {c.dst}: host "
                     f"{plan.assignment[c.src]} -> {plan.assignment[c.dst]} "
                     f"(capacity={cap}{extra})")
    for r in sorted(reports, key=lambda r: r.host):
        state = "ok" if r.ok else (
            "STALLED" if getattr(r, "stalled", False) else "FAILED")
        lines.append(f"-- host {r.host} [{state}]: {', '.join(r.procs)}")
        if getattr(r, "stalled", False) and r.resume_ci is not None:
            lines.append(f"   stalled: fold state intact, resumes at "
                         f"chunk {r.resume_ci}")
        if r.stats_summary:
            lines.append(f"   {r.stats_summary}")
        if r.donation_summary:
            lines.append(f"   {r.donation_summary}")
        if r.error:
            lines.extend(f"   ! {ln}" for ln in r.error.strip().splitlines())
    if events:
        lines.append("-- recovery --")
        for ev in events:
            lines.append(f"   {ev.describe()}")
    if durability:
        lines.append("-- durability --")
        for ev in durability:
            lines.append(f"   {ev.describe()}")
    return "\n".join(lines)
