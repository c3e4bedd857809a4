"""Load-driven autoscaling: resize a live plan from its own telemetry.

The paper's capstone (§7) is a process network that fits itself to the
machines it runs on; Kerridge's Cluster Builder DSL (PAPERS.md) pushes
that further — declare the deployment, let the runtime size it.  The
control plane already reacts to *death* (``recover()``); this module makes
it react to *load*:

* :class:`AutoscalePolicy` turns a stream of
  :class:`~..core.trace.MetricsSnapshot`\\ s into decisions, with the
  hysteresis a production policy needs: a signal must *sustain* for N
  consecutive polls before anything fires, every action starts a
  *cooldown* during which the policy holds, and host counts are clamped
  to ``[min_hosts, max_hosts]``.  Three signals, each an independent
  threshold:

  - **pressure** (scale up): sustained cut-channel occupancy at/above
    ``high_occupancy`` (a channel whose capacity is unknown —
    ``occupancy=None`` — counts as saturated: suspect, not invisible),
    per-host stall rate at/above ``high_stall_rate``, or — when a
    latency target ``high_batch_wall_s`` is configured — any host's
    batch wall at/above it;
  - **imbalance** (migrate): the fastest host's items/s at least
    ``imbalance_ratio`` times a slower host's — a straggler; the remedy
    is evacuating the slow host's processes onto the survivors, not
    buying a new host.  Two refinements a bounded-channel network
    forces: the signal only counts when the batch actually took
    ``min_batch_wall_s`` (rates measured over a sub-millisecond batch
    are noise), and the victim is the most *upstream* host of the slow
    set — backpressure makes every host downstream of a straggler look
    exactly as slow, so the slowest row is usually the innocent tail;
  - **headroom** (scale down): *only* when a latency budget
    ``low_batch_wall_s`` is configured and every host finishes its
    batches inside it with occupancy at/below ``low_occupancy``.
    Without a budget the policy never shrinks: between batches the
    queues always drain, so "no pressure right now" alone is what an
    idle deployment looks like, not evidence of over-provisioning.

* :class:`Autoscaler` polls :meth:`ClusterController.metrics` between
  batches and executes decisions through the existing machinery —
  :meth:`~.control.ClusterController.reconfigure` with ``hosts=n±1`` to
  add/remove a host, or a :func:`~.partition.repartition_without`-style
  migration plan that evacuates the bottleneck host (reusing
  :func:`~.partition.cost_assignment` when a
  :class:`~.costs.CostProfile` is available, priced for the deployment's
  transport: ``"device"`` where the JAX package reads ``"jaxmesh"``).
  Every action is an ordinary epoch bump: drained transports,
  ``check_redeployment`` re-proof of the §6.1.1 refinement, lost-chunk
  replay semantics — never a restart.  A decision the deployment cannot
  execute (a one-host plan cannot evacuate anybody; a replan that does
  not validate) is recorded as *vetoed*, and the cooldown still applies,
  so impossible decisions cannot flap either.  Unlike the JAX package's
  ``jaxmesh``, whose device submeshes are fixed at start, the port's
  ``device`` transport places host *h* on ``cuda:(h % device_count)``
  when it joins, so a ``device`` deployment grows as the queue
  transports do.

Wire-up: ``ClusterDeployment(..., autoscale=policy)`` polls after every
completed batch; the cluster launcher exposes ``--autoscale`` /
``--min-hosts`` / ``--max-hosts``.  ``cluster/sim.py --workload`` drives
seeded traffic spikes, stragglers and slow-start hosts through this module
and asserts the §6.1.1 invariants plus convergence (a bounded number of
scaling actions per schedule).  The serving side — a decode farm that
grows and shrinks under open-loop traffic (``ClusterDecodeBackend(...,
autoscale=)``) — comes with the port's cluster step 9.8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.dataflow import NetworkError
from .partition import cost_assignment, partition, repartition_without

__all__ = ["AutoscalePolicy", "AutoscaleEvent", "Autoscaler",
           "host_depths"]


def host_depths(plan) -> dict:
    """Topological depth of each host in ``plan``'s cut-channel DAG —
    the longest cut-hop path from any host with no inbound cut.  Used
    by :meth:`AutoscalePolicy.decide` to blame the most upstream host
    of a slow set (bounded channels make a straggler's whole downstream
    run at its pace, so depth — not raw items/s — separates the culprit
    from the throttled)."""
    hosts = plan.hosts()
    preds: dict = {h: set() for h in hosts}
    for c in plan.cut:
        src, dst = plan.assignment[c.src], plan.assignment[c.dst]
        if src != dst:
            preds[dst].add(src)
    depth = {h: 0 for h in hosts}
    for _ in range(len(hosts)):  # bounded relaxation: cycles cannot spin
        changed = False
        for h in hosts:
            d = max((depth[p] + 1 for p in preds[h]), default=0)
            if d > depth[h]:
                depth[h] = d
                changed = True
        if not changed:
            break
    return depth


@dataclasses.dataclass
class AutoscalePolicy:
    """Hysteresis thresholds over :class:`MetricsSnapshot` streams.

    Purely functional over its own counters: feed :meth:`decide` one
    snapshot per poll and it returns ``None`` (hold) or an
    ``(action, host, reason)`` decision — ``action`` one of
    ``"add_host"`` / ``"remove_host"`` / ``"migrate"``, ``host`` the
    migration victim (``None`` otherwise).  Returning a decision starts
    the cooldown immediately, whether or not the autoscaler manages to
    execute it — an impossible decision must not be re-issued every
    poll."""

    high_occupancy: float = 0.85   # cut-channel occupancy => pressure
    low_occupancy: float = 0.25    # occupancy ceiling for scale-down
    high_stall_rate: float = 1.0   # dispatcher stalls/chunk => pressure
    imbalance_ratio: float = 3.0   # fastest/slowest items/s => straggler
    min_batch_wall_s: float = 0.0  # imbalance ignored on shorter batches
    # (per-host rates over a near-instant batch are measurement noise)
    high_batch_wall_s: Optional[float] = None  # latency SLO => pressure
    low_batch_wall_s: Optional[float] = None   # latency budget =>
    # headroom; scale-down is DISABLED while this is None (see module
    # docstring: drained queues alone are not over-provisioning)
    sustain: int = 2               # consecutive polls before acting
    cooldown: int = 2              # polls to hold after any decision
    min_hosts: int = 1
    max_hosts: int = 8

    # hysteresis state, not configuration
    _hot: int = dataclasses.field(default=0, init=False, repr=False)
    _cold: int = dataclasses.field(default=0, init=False, repr=False)
    _skew: int = dataclasses.field(default=0, init=False, repr=False)
    _cooldown_left: int = dataclasses.field(default=0, init=False,
                                            repr=False)

    def reset(self) -> None:
        self._hot = self._cold = self._skew = 0
        self._cooldown_left = 0

    def decide(self, snap, n_hosts: int, host_depth=None):
        """One poll: classify ``snap``, advance the streaks, and fire a
        decision once a signal has sustained (and the bounds allow it).

        ``host_depth`` (host -> topological depth in the plan's
        cut-channel DAG, see :func:`host_depths`) picks the migration
        victim: the most upstream host of the slow set.  Everything
        downstream of a straggler is throttled to the straggler's pace
        by bounded channels, so the raw items/s minimum is usually the
        innocent tail, not the culprit.  Without depths the slowest
        host is blamed."""
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return None
        occ = [1.0 if v is None else v for v in snap.occupancy.values()]
        max_occ = max(occ, default=0.0)
        stall = max(snap.stall_rate.values(), default=0.0)
        walls = getattr(snap, "batch_wall_s", {}) or {}
        max_wall = max(walls.values(), default=0.0)
        tps = {h: v for h, v in snap.throughput.items() if v > 0.0}

        hot = (max_occ >= self.high_occupancy
               or stall >= self.high_stall_rate
               or (self.high_batch_wall_s is not None
                   and max_wall >= self.high_batch_wall_s))
        skew, slow, fast = False, None, 0.0
        if len(tps) >= 2 and max_wall >= self.min_batch_wall_s:
            fast = max(tps.values())
            slow_set = sorted(h for h in tps
                              if fast >= self.imbalance_ratio * tps[h])
            if slow_set:
                skew = True
                depth = host_depth or {}
                slow = min(slow_set,
                           key=lambda h: (depth.get(h, 0), tps[h], h))
        cold = (not hot and not skew and bool(walls)
                and self.low_batch_wall_s is not None
                and max_wall <= self.low_batch_wall_s
                and max_occ <= self.low_occupancy)

        self._hot = self._hot + 1 if hot else 0
        self._skew = self._skew + 1 if skew and not hot else 0
        self._cold = self._cold + 1 if cold else 0

        if self._hot >= self.sustain and n_hosts < self.max_hosts:
            why = []
            if max_occ >= self.high_occupancy:
                why.append(f"occupancy {max_occ:.2f}")
            if stall >= self.high_stall_rate:
                why.append(f"stalls {stall:.2f}/chunk")
            if (self.high_batch_wall_s is not None
                    and max_wall >= self.high_batch_wall_s):
                why.append(f"batch wall {max_wall:.3f}s >= "
                           f"{self.high_batch_wall_s:.3f}s")
            return self._fire("add_host", None,
                              f"{' + '.join(why)} sustained "
                              f"{self._hot} poll(s)")
        if self._skew >= self.sustain and n_hosts > self.min_hosts:
            return self._fire(
                "migrate", slow,
                f"host {slow} (most upstream of the slow set) at "
                f"{tps[slow]:.1f} items/s vs peak {fast:.1f} "
                f"(x{fast / tps[slow]:.1f}) sustained "
                f"{self._skew} poll(s)")
        if self._cold >= self.sustain and n_hosts > self.min_hosts:
            return self._fire(
                "remove_host", None,
                f"batch wall {max_wall:.3f}s <= budget "
                f"{self.low_batch_wall_s:.3f}s and occupancy "
                f"{max_occ:.2f} sustained {self._cold} poll(s)")
        return None

    def _fire(self, action: str, host, reason: str):
        self.reset()
        self._cooldown_left = self.cooldown
        return action, host, reason


@dataclasses.dataclass
class AutoscaleEvent:
    """One autoscale decision — executed or vetoed — for the report."""

    epoch_from: int
    action: str               # "add_host" | "remove_host" | "migrate"
    reason: str
    hosts_from: int
    hosts_to: int
    executed: bool = False
    vetoed: Optional[str] = None  # why an intended action did NOT run
    event: Optional[object] = None  # the executed replan's RecoveryEvent

    def describe(self) -> str:
        """One deterministic line, ``netlog.cluster_report``-renderable
        next to :class:`RecoveryEvent` lines."""
        line = (f"autoscale {self.action} "
                f"[{self.hosts_from} -> {self.hosts_to} hosts] "
                f"@ epoch {self.epoch_from}: {self.reason}")
        if self.vetoed:
            return line + f" — vetoed: {self.vetoed}"
        if self.event is not None:
            line += f" (refined={getattr(self.event, 'refined', None)})"
        return line


class Autoscaler:
    """Drives an :class:`AutoscalePolicy` against a live deployment.

    ``controller`` is a :class:`~.control.ClusterController`
    or anything exposing one as ``.controller`` (a
    :class:`~.deploy.ClusterDeployment`).  Call
    :meth:`poll` between batches; every executed action is an epoch
    bump through :meth:`ClusterController.reconfigure` — drained
    transports, ``check_redeployment`` re-proof, never a restart — and
    its :class:`RecoveryEvent` is annotated (``auto_mode``) so
    ``netlog.cluster_report`` renders the decision next to recoveries.

    ``profile`` (default: the controller's ``cfg.profile``) prices the
    migration replan through :func:`cost_assignment`; without one the
    evacuation falls back to :func:`repartition_without` — the same
    neighbour-preserving planner recovery uses."""

    def __init__(self, controller, policy: Optional[AutoscalePolicy] = None,
                 *, profile=None):
        self.controller = getattr(controller, "controller", controller)
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.profile = (profile if profile is not None
                        else getattr(self.controller.cfg, "profile", None))
        self.events: list = []

    @property
    def actions(self) -> list:
        """Executed decisions only (the flapping-bound subject)."""
        return [e for e in self.events if e.executed]

    def poll(self) -> Optional[AutoscaleEvent]:
        """One policy step: snapshot, decide, execute.  Returns the
        :class:`AutoscaleEvent` when the policy decided anything (even a
        vetoed decision), ``None`` on hold."""
        ctrl = self.controller
        snap = ctrl.metrics()
        n = len(ctrl.plan.hosts())
        decision = self.policy.decide(snap, n,
                                      host_depth=host_depths(ctrl.plan))
        if decision is None:
            return None
        action, victim, reason = decision
        ev = AutoscaleEvent(epoch_from=ctrl.epoch, action=action,
                            reason=reason, hosts_from=n, hosts_to=n)
        try:
            if action == "add_host":
                ev.hosts_to = n + 1
                ev.event = ctrl.reconfigure(hosts=n + 1)
            elif action == "remove_host":
                ev.hosts_to = n - 1
                ev.event = ctrl.reconfigure(hosts=n - 1)
            else:
                plan = self._migration_plan(ctrl, victim)
                ev.hosts_to = len(plan.hosts())
                ev.event = ctrl.reconfigure(plan=plan)
            ev.executed = True
            ev.event.auto_mode = f"autoscale {action}: {reason}"
        except NetworkError as e:
            # e.g. no survivor to evacuate onto, or the replan would not
            # validate: record the veto; the policy's cooldown already
            # started, so this cannot re-fire every poll
            ev.vetoed = str(e).splitlines()[0]
        self.events.append(ev)
        return ev

    def _migration_plan(self, ctrl, victim):
        """A validated plan with ``victim`` evacuated: measured-cost cut
        over the survivors when a profile is available (its host indices
        remapped onto the surviving ids, so untouched hosts keep their
        names, warm executors and compiled jits), else the recovery
        planner's neighbour-preserving evacuation."""
        old = ctrl.plan
        survivors = [h for h in old.hosts() if h != victim]
        if not survivors:
            raise NetworkError(
                f"autoscale migrate: no host left after evacuating "
                f"{victim}")
        if self.profile is not None:
            raw = cost_assignment(ctrl.net, len(survivors), self.profile,
                                  transport=getattr(ctrl.transport,
                                                    "name", None))
            used = sorted(set(raw.values()))
            remap = {o: survivors[i] for i, o in enumerate(used)}
            assign = {p: remap[h] for p, h in raw.items()}
        else:
            assign = repartition_without(old, [victim])
        return partition(ctrl.net, assignment=assign)
