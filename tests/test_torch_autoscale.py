"""The port's autoscaler against the JAX package's, on the CPU.

All 21 cases of the reference's ``tests/test_autoscale.py`` on the port —
the policy's hysteresis, the telemetry regressions the policy's signals
exposed (ghost host rows, capacity-0 channels, per-batch samples diluted
by plan totals, dangling channel keys after a replan: fault 12), the
autoscaler driving a live deployment through epoch-bumped reconfigures, and
one workload scenario of each kind — every deployment on ``device="cpu"``.
Then the two packages side by side: one seeded stream of metrics through
both policies gives the same decisions, and ``WorkloadSchedule.random``
draws the same schedule for the same seed and plan.
"""

import random
import types

import numpy as np
import pytest
import torch

import repro.cluster.autoscale as jautoscale
import repro.cluster.sim as jsim
from repro.cluster import partition as jpartition
from repro.cluster.costs import CostProfile as JCostProfile
from repro.core import trace as jtrace
from repro_torch.cluster import (AutoscalePolicy, Autoscaler,
                                 ClusterDeployment, partition)
from repro_torch.cluster import sim
from repro_torch.cluster.autoscale import host_depths
from repro_torch.core import OnePipelineCollect, run_sequential
from repro_torch.core import trace as _trace
from repro_torch.core.dataflow import NetworkError

CPU = "cpu"


def _pipeline_factory():
    return OnePipelineCollect(
        create=lambda i: torch.tensor(float(i)),
        stage_ops=[lambda x: x * x, lambda x: x + 1.0,
                   lambda x: x * 2.0, lambda x: x - 3.0],
        collector=lambda a, x: a + x, init=torch.tensor(0.0),
        jit_combine=True)


def _snap(*, occ=None, stall=None, tps=None, walls=None, epoch=1,
          trace=_trace):
    s = trace.MetricsSnapshot(epoch=epoch)
    s.occupancy.update(occ or {})
    s.stall_rate.update(stall or {})
    s.throughput.update(tps or {})
    s.batch_wall_s.update(walls or {})
    return s


# ==========================================================================
# Policy hysteresis (pure unit: snapshots in, decisions out)
# ==========================================================================

class TestPolicyHysteresis:
    def test_pressure_must_sustain_before_firing(self):
        pol = AutoscalePolicy(high_occupancy=0.8, sustain=3, cooldown=0,
                              max_hosts=4)
        hot = _snap(occ={"a->b": 0.9})
        assert pol.decide(hot, 2) is None
        assert pol.decide(hot, 2) is None
        action, victim, reason = pol.decide(hot, 2)
        assert action == "add_host" and victim is None
        assert "occupancy" in reason

    def test_transient_resets_the_streak(self):
        pol = AutoscalePolicy(high_occupancy=0.8, sustain=2, cooldown=0)
        hot, cool = _snap(occ={"a->b": 0.9}), _snap(occ={"a->b": 0.1})
        assert pol.decide(hot, 2) is None
        assert pol.decide(cool, 2) is None  # streak broken
        assert pol.decide(hot, 2) is None   # back to 1, not 2
        assert pol.decide(hot, 2) is not None

    def test_cooldown_holds_even_under_pressure(self):
        pol = AutoscalePolicy(high_occupancy=0.8, sustain=1, cooldown=3,
                              max_hosts=8)
        hot = _snap(occ={"a->b": 0.95})
        assert pol.decide(hot, 2) is not None
        for _ in range(3):
            assert pol.decide(hot, 2) is None  # cooling down
        assert pol.decide(hot, 2) is not None

    def test_bounds_veto_at_decision_time(self):
        pol = AutoscalePolicy(high_occupancy=0.8, sustain=1, cooldown=0,
                              min_hosts=2, max_hosts=2)
        assert pol.decide(_snap(occ={"a->b": 0.95}), 2) is None
        pol2 = AutoscalePolicy(imbalance_ratio=2.0, sustain=1, cooldown=0,
                               min_hosts=2)
        skewed = _snap(tps={0: 100.0, 1: 10.0})
        assert pol2.decide(skewed, 2) is None  # n == min_hosts

    def test_unknown_capacity_counts_as_saturated(self):
        """occupancy=None (capacity-0 channel) is suspect, not invisible:
        it must count as full pressure, not be skipped."""
        pol = AutoscalePolicy(high_occupancy=0.9, sustain=1, cooldown=0)
        decision = pol.decide(_snap(occ={"a->b": None}), 2)
        assert decision is not None and decision[0] == "add_host"

    def test_wall_target_fires_pressure(self):
        pol = AutoscalePolicy(high_occupancy=2.0, high_stall_rate=1e9,
                              high_batch_wall_s=0.5, sustain=1, cooldown=0)
        decision = pol.decide(_snap(walls={0: 0.7}), 2)
        assert decision is not None and decision[0] == "add_host"
        assert "batch wall" in decision[2]

    def test_scale_down_disabled_without_latency_budget(self):
        """Drained queues alone are what idle looks like — without
        low_batch_wall_s the policy must never shrink."""
        pol = AutoscalePolicy(sustain=1, cooldown=0, min_hosts=1)
        idle = _snap(occ={"a->b": 0.0}, walls={0: 0.001, 1: 0.001})
        for _ in range(5):
            assert pol.decide(idle, 3) is None
        pol2 = AutoscalePolicy(sustain=1, cooldown=0, min_hosts=1,
                               low_batch_wall_s=0.01)
        decision = pol2.decide(idle, 3)
        assert decision is not None and decision[0] == "remove_host"

    def test_imbalance_gated_by_min_batch_wall(self):
        """Per-host rates over a near-instant batch are noise: the skew
        signal must not fire below min_batch_wall_s."""
        pol = AutoscalePolicy(imbalance_ratio=2.0, min_batch_wall_s=0.05,
                              sustain=1, cooldown=0, min_hosts=1)
        noise = _snap(tps={0: 100.0, 1: 10.0}, walls={0: 0.001, 1: 0.001})
        assert pol.decide(noise, 3) is None
        real = _snap(tps={0: 100.0, 1: 10.0}, walls={0: 0.1, 1: 0.1})
        decision = pol.decide(real, 3)
        assert decision is not None and decision[0] == "migrate"

    def test_victim_is_most_upstream_of_slow_set(self):
        """Bounded channels throttle everything downstream of a straggler
        to its pace, so the raw items/s minimum is the innocent tail —
        the victim must be the most upstream slow host."""
        pol = AutoscalePolicy(imbalance_ratio=1.5, sustain=1, cooldown=0,
                              min_hosts=1)
        snap = _snap(tps={0: 100.0, 1: 40.0, 2: 35.0},
                     walls={0: 0.1, 1: 0.2, 2: 0.21})
        action, victim, _ = pol.decide(snap, 3,
                                       host_depth={0: 0, 1: 1, 2: 2})
        assert action == "migrate"
        assert victim == 1  # not host 2, the throttled tail

    def test_host_depths_from_plan(self):
        plan = partition(_pipeline_factory(), hosts=3)
        depths = host_depths(plan)
        emit_host = plan.assignment["emit"]
        collect_host = plan.assignment["collect"]
        assert depths[emit_host] == 0
        assert depths[collect_host] == max(depths.values())


# ==========================================================================
# The telemetry bugs the policy exposed
# ==========================================================================

class TestMetricsRegressions:
    def test_replan_prunes_ghost_host_rows(self):
        """Scale 3 -> 2: the dropped host's _last_reports row must leave
        metrics() with the epoch bump — a policy polling throughput must
        never average in a host the plan no longer has."""
        net = _pipeline_factory()
        with ClusterDeployment(net, hosts=3, transport="inprocess",
                               microbatch_size=2, device=CPU) as dep:
            dep.run(instances=8)
            assert set(dep.metrics().throughput) == {0, 1, 2}
            dep.reconfigure(hosts=2)
            ghost = set(dep.metrics().throughput) - set(
                dep.controller.plan.hosts())
            assert not ghost, f"ghost host rows: {ghost}"

    def test_zero_capacity_channel_surfaces_as_none(self):
        """A channel whose capacity reads 0 is exactly the one a scaling
        policy must see: occupancy=None (unknown), raw depth still in
        queue_depths — not silently dropped."""
        net = _pipeline_factory()
        with ClusterDeployment(net, hosts=2, transport="inprocess",
                               microbatch_size=2, device=CPU) as dep:
            dep.run(instances=8)
            ctrl = dep.controller
            (chan,) = ctrl.transport.channel_depths().keys()
            key = f"{chan[0]}->{chan[1]}"
            ctrl.transport.channel_capacities = lambda: {chan: 0}
            snap = dep.metrics()
            assert key in snap.occupancy and snap.occupancy[key] is None
            assert key in snap.queue_depths
            # and a transient depth > capacity clamps to 1.0
            ctrl.transport.channel_capacities = lambda: {chan: 2}
            ctrl.transport.channel_depths = lambda: {chan: 5}
            snap = dep.metrics()
            assert snap.occupancy[key] == 1.0
            assert snap.queue_depths[key] == 5  # raw depth, unclamped

    def test_metrics_sample_reports_progress_not_plan(self):
        """StreamStats presets n_items/n_chunks to the PLAN totals when a
        run starts, so sampling them reports full throughput for work a
        stalled host never finished.  The sample must come from the
        retired-progress counters, rebased at each serve call.  (The
        port's sample also reads the endpoint's ring counts: the fake's
        endpoint has none.)"""
        from repro_torch.cluster.runtime import PartitionExecutor
        stats = types.SimpleNamespace(n_items=100, n_chunks=50,
                                      chunks_done=10, items_done=20,
                                      stalls=4)
        fake = types.SimpleNamespace(
            stats=stats, _sample_base=(0, 0, 0), sent_bytes={},
            recv_bytes={}, _ring_base={},
            ep=types.SimpleNamespace(ring_counts=lambda: {}))
        m = PartitionExecutor.metrics_sample(fake, 2.0)
        assert m["items_per_s"] == pytest.approx(10.0)  # 20/2s, not 100/2s
        assert m["stalls_per_chunk"] == pytest.approx(0.4)
        # a resume rebases: only the tail since the stall is billed
        fake._sample_base = (10, 20, 4)
        stats.chunks_done, stats.items_done, stats.stalls = 50, 100, 5
        m = PartitionExecutor.metrics_sample(fake, 1.0)
        assert m["items_per_s"] == pytest.approx(80.0)
        assert m["stalls_per_chunk"] == pytest.approx(1 / 40)

    def test_warm_batches_report_live_throughput(self):
        """Regression for the delta-of-presets bug: warm batches (same
        plan, fresh stats) must report this batch's real rate, not 0."""
        net = _pipeline_factory()
        with ClusterDeployment(net, hosts=2, transport="inprocess",
                               microbatch_size=2, device=CPU) as dep:
            for _ in range(3):
                dep.run(instances=8)
                snap = dep.metrics()
                assert snap.throughput and all(
                    v > 0 for v in snap.throughput.values()), snap.describe()
                assert all(v > 0 for v in snap.batch_wall_s.values())

    def test_reconfigure_prunes_dangling_channel_keys(self):
        """A _cum_chan key whose endpoint processes the net no longer has
        must not leak into bytes_per_s forever; a channel a replan merely
        stopped cutting keeps its lifetime history (it can be re-cut).
        Fault 12: the port's replan pruned only the host rows."""
        net = _pipeline_factory()
        with ClusterDeployment(net, hosts=2, transport="inprocess",
                               microbatch_size=2, device=CPU) as dep:
            dep.run(instances=8)
            ctrl = dep.controller
            live_keys = set(ctrl._cum_chan)
            assert live_keys
            ctrl._cum_chan["ghost->nowhere"] = (4096, 1.0)
            dep.reconfigure(hosts=3)
            snap = dep.metrics()
            assert "ghost->nowhere" not in snap.bytes_per_s
            for k in live_keys:  # real channels keep their lifetime rate
                assert snap.bytes_per_s.get(k, 0) > 0


# ==========================================================================
# The Autoscaler driving a live deployment
# ==========================================================================

class TestAutoscalerIntegration:
    def test_add_host_is_epoch_bumped_reconfigure(self):
        """A fired decision lands as an ordinary reconfigure: epoch bump,
        check_redeployment re-proof, auto_mode annotation — and the next
        batch is still bit-identical to the sequential oracle."""
        net = _pipeline_factory()
        seq = float(run_sequential(net, 8, device=CPU)["collect"])
        policy = AutoscalePolicy(high_occupancy=2.0, high_stall_rate=1e9,
                                 high_batch_wall_s=1e-9,  # any batch trips
                                 sustain=1, cooldown=2,
                                 min_hosts=2, max_hosts=3)
        with ClusterDeployment(net, hosts=2, transport="inprocess",
                               microbatch_size=2, autoscale=policy,
                               device=CPU) as dep:
            out0 = dep.run(instances=8)  # poll fires after this batch
            assert float(out0["collect"]) == seq
            events = dep.autoscale_events
            assert len(events) == 1 and events[0].executed
            ev = events[0]
            assert ev.action == "add_host"
            assert ev.hosts_from == 2 and ev.hosts_to == 3
            assert ev.event.refined is True
            assert ev.event.auto_mode.startswith("autoscale add_host")
            assert dep.epoch == 2
            assert len(dep.controller.plan.hosts()) == 3
            out1 = dep.run(instances=8)
            assert float(out1["collect"]) == seq
            assert "autoscale add_host" in ev.describe()

    def test_veto_is_recorded_and_cooldown_prevents_refire(self):
        """A decision the deployment cannot execute is recorded as vetoed
        — and the policy's cooldown already started, so the impossible
        decision does not re-fire every poll."""
        net = _pipeline_factory()
        policy = AutoscalePolicy(high_occupancy=2.0, high_stall_rate=1e9,
                                 high_batch_wall_s=1e-9, sustain=1,
                                 cooldown=2, min_hosts=2, max_hosts=3)
        with ClusterDeployment(net, hosts=2, transport="inprocess",
                               microbatch_size=2, device=CPU) as dep:
            scaler = Autoscaler(dep, policy)

            def refuse(**kw):
                raise NetworkError("scale-up refused for the test")

            dep.controller.reconfigure = refuse
            dep.run(instances=8)
            ev = scaler.poll()
            assert ev is not None and not ev.executed
            assert "refused" in ev.vetoed
            assert "vetoed" in ev.describe()
            assert scaler.actions == []
            assert scaler.poll() is None  # cooling down, no re-fire
            assert dep.epoch == 1  # nothing executed

    def test_migration_evacuates_victim(self):
        """A forced migrate decision replans the victim's processes onto
        the survivors through reconfigure(plan=...) — same epoch-bump
        contract, victim gone from the new plan."""
        net = _pipeline_factory()
        seq = float(run_sequential(net, 8, device=CPU)["collect"])
        with ClusterDeployment(net, hosts=3, transport="inprocess",
                               microbatch_size=2, device=CPU) as dep:
            dep.run(instances=8)
            scaler = Autoscaler(dep)
            victim = 1
            forced = ("migrate", victim, "forced for the test")
            scaler.policy.decide = lambda *a, **k: forced
            ev = scaler.poll()
            assert ev.executed and ev.event.refined is True
            hosts = dep.controller.plan.hosts()
            assert victim not in hosts and len(hosts) == 2
            out = dep.run(instances=8)
            assert float(out["collect"]) == seq


# ==========================================================================
# Workload schedules end to end (one seed per kind; the CI's autoscale lane
# sweeps more via `python -m repro_torch.cluster.sim --workload N`)
# ==========================================================================

class TestWorkloadScenarios:
    @pytest.mark.parametrize("kind", ["spike", "straggler", "slow-start"])
    def test_workload_kind(self, kind):
        r = sim.run_workload_scenario(0, kind=kind, device=CPU)
        assert r.ok, "\n".join(r.failures)


# ==========================================================================
# The port beside the JAX package
# ==========================================================================

class TestAgainstJax:
    def test_growth_over_the_device_transport_executes(self):
        """The JAX package vetoes growth over ``jaxmesh`` (its device
        submeshes are fixed at start); the port's ``device`` transport
        places a joining host on ``cuda:(h % device_count)``, so the same
        decision executes, refined, and the next batch equals the
        oracle."""
        net = _pipeline_factory()
        seq = float(run_sequential(net, 8, device=CPU)["collect"])
        policy = AutoscalePolicy(high_occupancy=2.0, high_stall_rate=1e9,
                                 high_batch_wall_s=1e-9, sustain=1,
                                 cooldown=2, min_hosts=2, max_hosts=3)
        with ClusterDeployment(net, hosts=2, transport="device",
                               microbatch_size=2, autoscale=policy,
                               device=CPU) as dep:
            dep.run(instances=8)
            (ev,) = dep.autoscale_events
            assert ev.executed and ev.vetoed is None
            assert ev.event.refined is True
            assert len(dep.plan.hosts()) == 3
            assert float(dep.run(instances=8)["collect"]) == seq

    def test_migration_prices_with_the_profile(self):
        """With a profile, the evacuation replans through cost_assignment
        over the survivors, remapped onto their ids (untouched hosts keep
        their names); the JAX package's planner gives the same plan."""
        from repro_torch.cluster import CostProfile
        costs = {n: {"name": n, "shape": [], "dtype": "float32",
                     "wall_s": 1e-3 if n in ("stage1", "stage2") else 1e-6,
                     "out_bytes": 4, "flops": 0.0, "bytes_accessed": 0.0,
                     "source": "measured"}
                 for n in ("emit", "stage0", "stage1", "stage2", "stage3",
                           "collect")}
        d = {"costs": costs, "bandwidths": {"inprocess": 1e9}}
        net = _pipeline_factory()
        with ClusterDeployment(net, hosts=3, transport="inprocess",
                               microbatch_size=2, device=CPU) as dep:
            dep.run(instances=8)
            scaler = Autoscaler(dep, profile=CostProfile.from_json(d))
            plan = scaler._migration_plan(dep.controller, 1)
            jnet = jsim.sim_workload_pipeline(8)
            jctrl = types.SimpleNamespace(
                plan=jpartition(jnet, assignment=dep.plan.assignment),
                net=jnet, transport=types.SimpleNamespace(name="inprocess"))
            jscaler = jautoscale.Autoscaler(
                jctrl, profile=JCostProfile.from_json(d))
            jplan = jscaler._migration_plan(jctrl, 1)
        assert 1 not in plan.hosts()
        assert plan.assignment == jplan.assignment

    @pytest.mark.parametrize("seed", range(10))
    def test_decision_sequences_equal_jax(self, seed):
        """One seeded stream of snapshot field values through both
        packages' policies, same thresholds: the same decisions (action,
        victim, reason) poll by poll."""
        rng = np.random.default_rng(seed)
        kw = dict(high_occupancy=0.8, low_occupancy=0.3,
                  high_stall_rate=1.5, imbalance_ratio=2.0,
                  min_batch_wall_s=0.02, high_batch_wall_s=0.4,
                  low_batch_wall_s=0.05, sustain=int(rng.integers(1, 4)),
                  cooldown=int(rng.integers(0, 3)), min_hosts=1,
                  max_hosts=5)
        ours, theirs = AutoscalePolicy(**kw), jautoscale.AutoscalePolicy(**kw)
        got, want = [], []
        for _ in range(60):
            hosts = list(range(int(rng.integers(1, 5))))
            fields = dict(
                occ={f"s{h}->d{h}": (None if rng.random() < 0.05
                                     else float(rng.random() * 1.1))
                     for h in hosts[:-1]},
                stall={h: float(rng.random() * 2) for h in hosts},
                tps={h: float(rng.choice([0.0, rng.random() * 100]))
                     for h in hosts},
                walls={h: float(rng.random() * 0.5) for h in hosts})
            depth = {h: int(rng.integers(0, 3)) for h in hosts}
            n = len(hosts) + int(rng.integers(0, 2))
            got.append(ours.decide(_snap(**fields), n, host_depth=depth))
            want.append(theirs.decide(_snap(**fields, trace=jtrace), n,
                                      host_depth=depth))
        assert got == want
        assert any(d is not None for d in got)

    @pytest.mark.parametrize("seed", range(12))
    def test_workload_schedule_draw_equals_jax(self, seed):
        """``WorkloadSchedule.random`` over the same plan and seed draws
        the same schedule as the JAX package, both with the kind pinned
        as ``run_workload_scenario`` pins it and drawn by the rng."""
        kinds = ("spike", "straggler", "slow-start")
        for kind in (kinds[seed % 3], None):
            hosts = 2 if kind == "spike" else 3
            plan = partition(sim.sim_workload_pipeline(8), hosts=hosts)
            jplan = jpartition(jsim.sim_workload_pipeline(8), hosts=hosts)
            ours = sim.WorkloadSchedule.random(random.Random(seed), plan,
                                               kind)
            theirs = jsim.WorkloadSchedule.random(random.Random(seed),
                                                  jplan, kind)
            assert ours.describe() == theirs.describe()
            assert (ours.kind, ours.victim) == (theirs.kind, theirs.victim)
            assert [(p.batch, p.instances, p.host_cost)
                    for p in ours.phases] == [
                (p.batch, p.instances, p.host_cost) for p in theirs.phases]
            for b in range(6):
                assert ours.phase_for(b).instances == \
                    theirs.phase_for(b).instances
