"""Unified runtime tracing + metrics plane (paper §8 logging, §13 future
work — and one step further).

The paper ships "error capture and a basic logging mechanism" (§8) and
names log-driven bottleneck visualisation as Further Work (§13);
:mod:`repro.core.netlog` renders that visualisation post-hoc from scattered
structs.  This module is the common event model underneath: a per-host,
lock-light ring buffer of typed events (:class:`TraceRecorder`) that every
runtime layer — the streaming executor, the cluster transports, the elastic
control plane, the serving engine — writes through one API.

* **Recording** is near-zero cost when disabled (one attribute check) and
  an O(1) bounded-deque append when enabled.  Timestamps come from an
  injectable ``clock`` — ``time.perf_counter`` in production, a virtual or
  counting clock under the deterministic simulator — so the same recorder
  serves wall-time profiling and byte-identical golden traces.
* **Cross-host collection**: worker hosts drain their rings into each
  result message; the controller aligns them by a per-host clock offset
  (plus the ``(epoch, chunk)`` stamps events carry) and merges
  (:func:`merge_events`).
* **Export**: :func:`export_chrome` writes Chrome trace-event / Perfetto
  JSON — open it at https://ui.perfetto.dev or ``chrome://tracing``.
* **Metrics**: :class:`MetricsSnapshot` is the polling API the autoscaler
  (ROADMAP item 1) consumes — queue depths, per-host throughput, stall
  rates, channel occupancy and bytes/s.
* **Conformance** (:func:`check_conformance`): the recorded event stream
  uses the same vocabulary as the CSP model, so a production trace can be
  *projected onto the model's alphabet* and checked to lie in its trace
  set (the Matlin/McCune/Lusk twist: observability doubles as online
  refinement checking).
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, NamedTuple, Optional

__all__ = [
    "TraceEvent",
    "TraceRecorder",
    "CountingClock",
    "current",
    "enable",
    "disable",
    "configure",
    "merge_events",
    "export_chrome",
    "MetricsSnapshot",
    "ConformanceResult",
    "check_conformance",
]


class TraceEvent(NamedTuple):
    """One merged, host-attributed trace record."""

    host: Any    # host label: int worker id, or "ctrl"
    kind: str    # "span" | "instant" | "counter"
    name: str
    cat: str
    ts: float    # clock units (seconds under the default wall clock)
    dur: float   # span duration; 0.0 for instants and counters
    args: dict


class CountingClock:
    """A deterministic clock: every read advances by one.  Per-recorder
    counting clocks make a single-threaded host's event stamps a pure
    function of its execution order — the basis of byte-identical golden
    traces under the simulator."""

    def __init__(self, start: int = 0):
        self.n = start

    def __call__(self) -> float:
        self.n += 1
        return float(self.n)


class _Span:
    """Context manager recording one complete ("X") span on exit."""

    __slots__ = ("_rec", "_name", "_cat", "_args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str, args: dict):
        self._rec, self._name, self._cat, self._args = rec, name, cat, args

    def __enter__(self):
        self._t0 = self._rec._clock()
        return self

    def set(self, **kw) -> "_Span":
        """Attach args discovered mid-span (e.g. bytes received)."""
        self._args.update(kw)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        rec._buf.append(("span", self._name, self._cat, self._t0,
                         rec._clock() - self._t0, self._args))
        return False


class _NullSpan:
    """Reusable no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def set(self, **kw) -> "_NullSpan":
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class TraceRecorder:
    """A per-host ring buffer of typed trace events.

    Lock-light by construction: the buffer is a bounded :class:`deque`
    (O(1) thread-safe appends under the GIL, oldest events dropped at
    capacity), and every recording call starts with one ``enabled`` check —
    a disabled recorder costs an attribute load and a branch.
    """

    def __init__(self, *, host: Any = 0, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True, virtual: bool = False):
        self.host = host
        self.capacity = capacity
        self.enabled = enabled
        # virtual clocks (sim ticks, counting clocks) must not be offset-
        # aligned against a controller wall clock at merge time
        self.virtual = virtual or isinstance(clock, CountingClock)
        self._clock = clock if clock is not None else time.perf_counter
        self._buf: deque = deque(maxlen=capacity)

    # -- recording (hot path) ---------------------------------------------
    def span(self, name: str, cat: str = "", **args):
        """Context manager: records one complete span at exit."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        if not self.enabled:
            return
        self._buf.append(("instant", name, cat, self._clock(), 0.0, args))

    def counter(self, name: str, value, cat: str = "", **args) -> None:
        if not self.enabled:
            return
        args["value"] = value
        self._buf.append(("counter", name, cat, self._clock(), 0.0, args))

    # -- collection --------------------------------------------------------
    def now(self) -> float:
        return self._clock()

    def events(self) -> list:
        """Snapshot as host-attributed :class:`TraceEvent` rows."""
        return [TraceEvent(self.host, *raw) for raw in self._buf]

    def drain(self) -> tuple:
        """Ship-and-clear: ``(raw_events, clock_now, virtual)`` — the
        payload a worker host sends back with each batch result (raw tuples
        stay picklable across the process transports)."""
        raw = list(self._buf)
        self._buf.clear()
        return raw, self._clock(), self.virtual

    def clear(self) -> None:
        self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)


# ==========================================================================
# The process-default recorder (executors/transports record through this
# unless handed their own — one per spawned host process)
# ==========================================================================

_DEFAULT_CLOCK: Any = None      # None -> time.perf_counter
_CURRENT = TraceRecorder(enabled=False)


def _make_clock():
    if _DEFAULT_CLOCK == "counting":
        return CountingClock()
    return _DEFAULT_CLOCK


def current() -> TraceRecorder:
    """The process-default recorder (disabled until :func:`enable`)."""
    return _CURRENT


def configure(*, clock: Any = None) -> None:
    """Set the module-default clock for recorders created from here on:
    ``None`` (wall ``time.perf_counter``), a shared callable (e.g. the
    sim's virtual clock), or ``"counting"`` (a fresh per-recorder
    :class:`CountingClock` — deterministic golden traces)."""
    global _DEFAULT_CLOCK
    _DEFAULT_CLOCK = clock


def new_recorder(*, host: Any = 0, capacity: int = 65536,
                 enabled: bool = True) -> TraceRecorder:
    """A recorder using the configured module-default clock."""
    clock = _make_clock()
    return TraceRecorder(host=host, capacity=capacity, clock=clock,
                         enabled=enabled,
                         virtual=_DEFAULT_CLOCK is not None)


def enable(*, host: Any = 0, capacity: int = 65536) -> TraceRecorder:
    """Turn the process-default recorder on (in place, so references
    captured by live executors see the flip)."""
    rec = _CURRENT
    rec.host = host
    rec.capacity = capacity
    rec._buf = deque(maxlen=capacity)
    rec._clock = _make_clock() or time.perf_counter
    rec.virtual = (_DEFAULT_CLOCK is not None
                   or isinstance(rec._clock, CountingClock))
    rec.enabled = True
    return rec


def disable() -> None:
    _CURRENT.enabled = False
    _CURRENT.clear()


# ==========================================================================
# Cross-host merge + Chrome trace-event export
# ==========================================================================

def merge_events(groups) -> list:
    """Merge per-host event streams onto one timeline.

    ``groups``: iterable of ``(host, offset, raw_events)`` — ``raw_events``
    as produced by :meth:`TraceRecorder.drain`, ``offset`` the clock shift
    aligning that host onto the controller's clock (0 for the controller
    itself and for virtual clocks).  The sort is stable per host (ties
    break on host label then per-host sequence), so each host's own
    monotonic order survives the merge.
    """
    keyed = []
    for host, offset, raw in groups:
        for seq, (kind, name, cat, ts, dur, args) in enumerate(raw):
            keyed.append((ts + offset, str(host), seq,
                          TraceEvent(host, kind, name, cat, ts + offset,
                                     dur, args)))
    keyed.sort(key=lambda t: t[:3])
    return [e for _, _, _, e in keyed]


def _us(t: float) -> float:
    """Clock units -> microseconds, rounded so exports are deterministic."""
    return round(t * 1e6, 3)


def export_chrome(events, path: Optional[str] = None) -> str:
    """Render merged :class:`TraceEvent` rows as Chrome trace-event JSON
    (the Perfetto-compatible ``traceEvents`` array form).  Deterministic:
    pids are assigned by sorted host label, keys are sorted, floats are
    rounded — identical event streams export byte-identically.  Returns the
    JSON string; also writes it to ``path`` when given."""
    hosts = sorted({str(e.host) for e in events})
    pid = {h: i for i, h in enumerate(hosts)}
    out = [{"ph": "M", "name": "process_name", "pid": pid[h], "tid": 0,
            "args": {"name": f"host {h}"}} for h in hosts]
    for e in events:
        base = {"name": e.name, "cat": e.cat or "gpp", "pid": pid[str(e.host)],
                "tid": 0, "ts": _us(e.ts)}
        if e.kind == "span":
            base["ph"] = "X"
            base["dur"] = _us(e.dur)
            base["args"] = e.args
        elif e.kind == "counter":
            base["ph"] = "C"
            base["args"] = {"value": e.args.get("value", 0)}
        else:
            base["ph"] = "i"
            base["s"] = "t"
            base["args"] = e.args
        out.append(base)
    blob = json.dumps({"traceEvents": out, "displayTimeUnit": "ms"},
                      sort_keys=True, separators=(",", ":"))
    if path is not None:
        with open(path, "w") as f:
            f.write(blob)
    return blob


# ==========================================================================
# MetricsSnapshot — the autoscaler's polling API (ROADMAP item 1 feed)
# ==========================================================================

@dataclasses.dataclass
class MetricsSnapshot:
    """A point-in-time read of a live deployment's health: everything a
    scaling policy needs to decide add/remove/migrate (ROADMAP item 1)."""

    epoch: int = 0
    # "src->dst" -> records waiting in the cut-channel FIFO right now
    queue_depths: dict = dataclasses.field(default_factory=dict)
    # "src->dst" -> depth / capacity, clamped to <= 1.0 (1.0 = the FIFO is
    # exerting backpressure; persistent occupancy marks the bottleneck
    # cut).  None = the channel is live but its capacity is unknown — a
    # policy should treat that as suspect, not invisible (the raw depth
    # is still in queue_depths)
    occupancy: dict = dataclasses.field(default_factory=dict)
    # host -> items/s over its last completed batch
    throughput: dict = dataclasses.field(default_factory=dict)
    # host -> dispatcher stalls per chunk over its last batch (backpressure
    # pressure seen from inside the host)
    stall_rate: dict = dataclasses.field(default_factory=dict)
    # "src->dst" -> sender-side bytes/s over the sender's last batch
    bytes_per_s: dict = dataclasses.field(default_factory=dict)
    # host -> wall seconds its last batch took end to end: the latency
    # signal a service-level scaling policy compares against its target
    # (between batches occupancy drains to 0, so batch wall is the one
    # load signal that survives the poll boundary)
    batch_wall_s: dict = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        """Deterministic one-line-per-section rendering."""
        lines = [f"metrics @ epoch {self.epoch}"]
        if self.queue_depths:
            lines.append("  depth: " + ", ".join(
                f"{c}={d}" for c, d in sorted(self.queue_depths.items())))
        if self.occupancy:
            lines.append("  occupancy: " + ", ".join(
                f"{c}=?" if o is None else f"{c}={o:.2f}"
                for c, o in sorted(self.occupancy.items(),
                                   key=lambda kv: kv[0])))
        if self.throughput:
            lines.append("  throughput: " + ", ".join(
                f"host {h}={v:.1f} items/s"
                for h, v in sorted(self.throughput.items())))
        if self.stall_rate:
            lines.append("  stall rate: " + ", ".join(
                f"host {h}={v:.2f}/chunk"
                for h, v in sorted(self.stall_rate.items())))
        if self.bytes_per_s:
            lines.append("  bytes/s: " + ", ".join(
                f"{c}={_fmt_bytes(v)}/s"
                for c, v in sorted(self.bytes_per_s.items())))
        if self.batch_wall_s:
            lines.append("  batch wall: " + ", ".join(
                f"host {h}={v:.3f}s"
                for h, v in sorted(self.batch_wall_s.items())))
        return "\n".join(lines)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GiB"


# ==========================================================================
# Online conformance: the merged trace lies in the CSP model's trace set
# ==========================================================================

@dataclasses.dataclass
class ConformanceResult:
    """Outcome of projecting a recorded run onto the CSP alphabet."""

    ok: bool
    coverage: float       # fraction of chunks with a recorded collect fold
    n_chunks: int
    observed: tuple       # the projected observable trace
    detail: str = ""

    def __bool__(self) -> bool:
        return self.ok


def check_conformance(net, events, *, instances: Optional[int] = None,
                      max_states: int = 500_000) -> ConformanceResult:
    """Project a recorded (merged) event stream onto the CSP event alphabet
    and assert it lies in ``net``'s model's observable trace set.

    The executor records, per chunk, an ``instant("stage", stage=.., ci=..)``
    for every functional stage that transformed it and an
    ``instant("collect", collect=.., ci=..)`` when the chunk folds at a
    Collect.  The projection rebuilds each chunk's symbolic value — the
    nested tag term the CSP model assigns (items are ``('i', ci)``, a stage
    tagged ``f`` maps ``v -> ('f', v)``) — and the fold order per Collect
    (each chunk folds exactly once in the model; recovery replays can
    record it more than once, so membership is checked up to the choice of
    one recorded fold per chunk — see below), appends the model's
    end-of-stream ``UT`` events, and checks membership in
    ``csp.check(net, collect_traces=True).traces`` — the same trace sets
    :func:`repro.core.csp.trace_refines` compares (a single observed trace
    contained in the spec's set IS trace refinement of that run).

    Networks with a COMBINE reducer are rejected (their collect sees one
    folded value, not per-chunk arrivals — no per-chunk projection exists).
    """
    from .csp import UT, check
    from .dataflow import Distribution, Kind

    for p in net.procs.values():
        if (p.kind is Kind.REDUCER
                and p.distribution is Distribution.COMBINE):
            return ConformanceResult(
                False, 0.0, 0, (), f"net {net.name!r} has COMBINE reducer "
                f"{p.name!r}: per-chunk projection undefined")

    stages_by_ci: dict = {}
    folds: dict = {}  # collect name -> ordered {ci: None} (last fold wins)
    max_ci = -1
    for e in events:
        if e.kind != "instant":
            continue
        if e.name == "stage":
            ci = e.args.get("ci")
            for member in str(e.args.get("stage", "")).split("+"):
                stages_by_ci.setdefault(ci, set()).add(member)
            max_ci = max(max_ci, ci if isinstance(ci, int) else -1)
        elif e.name == "collect":
            ci = e.args.get("ci")
            seq = folds.setdefault(e.args.get("collect"), {})
            seq.pop(ci, None)  # a replayed delivery supersedes the stale one
            seq[ci] = None
            max_ci = max(max_ci, ci if isinstance(ci, int) else -1)

    n = instances if instances is not None else max_ci + 1
    if not folds:
        return ConformanceResult(False, 0.0, n, (),
                                 "no collect events recorded")
    if len(folds) != 1:
        return ConformanceResult(
            False, 0.0, n, (), f"expected one Collect in the trace, got "
            f"{sorted(folds)}")
    (collect_name,) = folds
    order = list(folds[collect_name])
    coverage = len(set(order)) / n if n else 1.0
    if coverage < 1.0:
        missing = sorted(set(range(n)) - set(order))
        return ConformanceResult(False, coverage, n, (),
                                 f"chunks never folded: {missing}")

    topo = {name: i for i, name in enumerate(net.toposort())}
    unknown = {s for members in stages_by_ci.values() for s in members
               if s not in topo}
    if unknown:
        return ConformanceResult(False, coverage, n, (),
                                 f"stage events name unknown processes: "
                                 f"{sorted(unknown)}")

    def term(ci):
        v: Any = ("i", ci)
        for s in sorted(stages_by_ci.get(ci, ()), key=topo.__getitem__):
            tag = net.procs[s].tag
            if isinstance(tag, tuple):
                for t in tag:
                    v = (t, v)
            else:
                v = (tag if tag is not None else s, v)
        return v

    observed = tuple((collect_name, term(ci)) for ci in order)
    n_in = sum(1 for c in net.channels if c.dst == collect_name)
    observed += ((collect_name, UT),) * n_in

    res = check(net, instances=n, collect_traces=True, max_states=max_states)
    ok = observed in res.traces
    if not ok:
        # Replay re-deliveries record a chunk's fold more than once: a
        # recovery attempt that dies mid-fold is re-run, and a restarted
        # host's virtual clock restarts from zero so its incarnations
        # interleave in the merge.  The "last delivery wins" order above is
        # then an artifact of clock interleaving, not of the logical fold.
        # Quotient honestly: each physical record is a candidate witness
        # for the chunk's one logical fold, and conformance holds iff SOME
        # choice of one record per chunk forms a spec trace (greedy
        # subsequence match per spec trace).  With no duplicate records
        # every candidate list is a singleton and this degenerates to the
        # exact membership test above.
        positions: dict = {}
        pos = 0
        for e in events:
            if e.kind == "instant" and e.name == "collect":
                positions.setdefault(e.args.get("ci"), []).append(pos)
                pos += 1
        term_ci = {term(ci): ci for ci in order}
        ut_tail = ((collect_name, UT),) * n_in
        fold_len = len(order)
        for spec in res.traces:
            if (len(spec) != fold_len + n_in
                    or spec[fold_len:] != ut_tail):
                continue  # a prefix trace, not a complete run
            last = -1
            for name, t in spec[:fold_len]:
                cand = positions.get(term_ci.get(t), ())
                nxt = next((p for p in cand if p > last), None)
                if name != collect_name or nxt is None:
                    break
                last = nxt
            else:
                ok = True
                break
    detail = "" if ok else (f"projected trace not in the model's trace set "
                            f"({len(res.traces)} spec traces)")
    return ConformanceResult(ok, coverage, n, observed, detail)
