"""The port's fault-injection simulator against the JAX package's, on the CPU.

The reference's ``tests/test_sim.py`` cases on the port: the simulator's
machinery (fake processes, the virtual clock, bricking FIFOs, the
schedule's counters), the seeded draw — the same ``random.Random(seed)``
gives the same topology, host count, fault schedule, recovery mode and
brick rebuildability in both packages for seeds 0-49 — and fixed-seed
scenarios that run the real controller over simulated hosts in both
packages, each green, on oracles equal as numbers.  The 50-seed sweep and
the real-pipe brick carry ``slow`` as the reference's do.  Every scenario
runs its hosts and oracle on ``device="cpu"``.
"""

import random
import threading
import time

import jax.numpy as jnp
import pytest
import torch

import repro.cluster.sim as jsim
import repro.core as jcore
from repro.cluster import partition as jpartition
from repro_torch.cluster import ClusterController, ExecConfig, partition
from repro_torch.cluster.runtime import ClusterError
from repro_torch.cluster.sim import (FakeProcess, FaultEvent, FaultSchedule,
                                     SimClock, SimContext, SimLivelock,
                                     SimTransport, _draw,
                                     run_pipe_brick_scenario, run_scenario,
                                     sim_farm, sim_pipeline)
from repro_torch.core import run_sequential
from repro_torch.core.dataflow import NetworkError

CPU = "cpu"
FAST_SEEDS = (1, 2, 3, 4, 8)  # the reference's fast-lane seeds


def _jdraw(seed: int):
    """The reference's ``run_scenario`` draw, step by step (it has no
    helper): topology, factory, plan, schedule, mode, rebuildability."""
    rng = random.Random(seed)
    topology = rng.choice(("farm", "pipeline"))
    if topology == "farm":
        factory = (jsim.sim_farm, (8, rng.choice((2, 3))))
    else:
        factory = (jsim.sim_pipeline, (8,))
    net = factory[0](*factory[1])
    plan = jpartition(net, hosts=rng.choice((2, 3)))
    schedule = jsim.FaultSchedule.random(rng, plan)
    mode = rng.choice(("restart", "rebalance"))
    rebuildable = rng.random() < 0.7
    return topology, factory, net, plan, schedule, mode, rebuildable


class TestSimMachinery:
    def test_fake_process_lifecycle(self):
        ran = threading.Event()
        p = FakeProcess(target=ran.set, name="t")
        p.start()
        p.join(timeout=5)
        assert ran.is_set() and not p.is_alive() and p.exitcode == 0

    def test_fake_process_kill_mid_park_is_silent(self):
        """A killed host parked on its work queue dies with exitcode -9 and
        reports nothing — SIGKILL semantics, not exception capture."""
        q = SimContext.Queue()
        outcomes = []

        def park():
            outcomes.append(q.get())  # blocks forever; kill must unwind

        p = FakeProcess(target=park)
        p.start()
        time.sleep(0.05)
        p.kill()
        p.join(timeout=5)
        assert not p.is_alive() and p.exitcode == -9 and outcomes == []

    def test_fake_process_error_exits_one(self):
        def boom():
            raise RuntimeError("host failure")

        p = FakeProcess(target=boom)
        p.start()
        p.join(timeout=5)
        assert p.exitcode == 1

    def test_clock_budget_is_livelock_check(self):
        clock = SimClock(budget=10)
        with pytest.raises(SimLivelock):
            for _ in range(20):
                clock.tick()

    def test_kill_mid_recv_bricks_channel_and_rebuild_clears(self):
        """A host killed while blocked in recv leaves the channel bricked
        (reads time out empty); rebuild_channel replaces the FIFO and
        clears the brick."""
        sched = FaultSchedule([FaultEvent(host=0, op="recv", at=0,
                                          action="kill", brick=True)])
        sched.arm()
        t = SimTransport(sched, SimClock())
        t.setup([("a", "b")], {("a", "b"): 2})
        ep = t.endpoint(0)
        t.send(("a", "b"), 0, "payload")  # parent sends: no host faults

        p = FakeProcess(target=lambda: ep.recv(("a", "b"), 0))
        p.start()
        p.join(timeout=5)
        assert p.exitcode == -9
        assert t.bricked_channels([("a", "b")]) == {("a", "b")}
        assert t.rebuild_channel(("a", "b"))
        assert t.bricked_channels([("a", "b")]) == set()

    def test_unrebuildable_brick_reported(self):
        sched = FaultSchedule([FaultEvent(host=0, op="recv", at=0,
                                          action="kill", brick=True)])
        sched.arm()
        t = SimTransport(sched, SimClock(), rebuildable=False)
        t.setup([("a", "b")], {("a", "b"): 2})
        ep = t.endpoint(0)
        p = FakeProcess(target=lambda: ep.recv(("a", "b"), 0))
        p.start()
        p.join(timeout=5)
        assert t.bricked_channels() == {("a", "b")}
        assert not t.rebuild_channel(("a", "b"))

    def test_endpoint_snapshots_queue_map(self):
        """Endpoints copy the queue map at creation like a spawned process
        pickling its args — a rebuilt channel is invisible to them (that is
        why the controller force-restarts live endpoint holders)."""
        t = SimTransport()
        t.setup([("a", "b")], {("a", "b"): 2})
        ep = t.endpoint(0)
        old = ep._queues[("a", "b")]
        assert t.rebuild_channel(("a", "b"))
        assert ep._queues[("a", "b")] is old
        assert t._queues[("a", "b")] is not old

    def test_schedule_fires_once_at_exact_step(self):
        sched = FaultSchedule([FaultEvent(host=1, op="send", at=2,
                                          action="kill")])
        sched.arm()
        assert sched.fire(1, "send", 1) is None      # send#0
        assert sched.fire(1, "recv", 1) is None      # other op: no count
        assert sched.fire(0, "send", 1) is None      # other host
        assert sched.fire(1, "send", 1) is None      # send#1
        ev = sched.fire(1, "send", 1)                # send#2 -> fires
        assert ev is not None and ev.action == "kill"
        assert sched.fire(1, "send", 1) is None      # never twice

    def test_schedule_min_epoch_gates_firing(self):
        sched = FaultSchedule([FaultEvent(host=0, op="recv", at=0,
                                          action="kill", min_epoch=2)])
        sched.arm()
        assert sched.fire(0, "recv", 1) is None  # epoch 1: held back
        sched2 = FaultSchedule([FaultEvent(host=0, op="recv", at=0,
                                           action="kill", min_epoch=2)])
        sched2.arm()
        assert sched2.fire(0, "recv", 2) is not None

    def test_disarmed_schedule_never_fires(self):
        sched = FaultSchedule([FaultEvent(host=0, op="recv", at=0,
                                          action="kill")])
        assert sched.fire(0, "recv", 1) is None

    def test_ctrl_step_kills_the_tracked_victim(self):
        """A controller-step fault raises its victim's kill flag while the
        controller drains — the victim is found through track_hosts."""
        sched = FaultSchedule([FaultEvent(host=1, op="drain", at=0,
                                          action="kill")])
        sched.arm()
        t = SimTransport(sched, SimClock())
        t.setup([("a", "b")], {("a", "b"): 2})
        victim = FakeProcess(target=lambda: SimContext.Queue().get())
        victim.start()
        t.track_hosts({1: victim})
        t.drain()
        victim.join(timeout=5)
        assert victim.exitcode == -9 and sched.events[0].fired

    def test_sim_transport_epoch_protocol_is_production_code(self):
        """The sim channels run the unmodified _QueueTransport protocol:
        stale epochs and replayed duplicates drop."""
        t = SimTransport()
        t.setup([("a", "b")], {("a", "b"): 8})
        t.send(("a", "b"), 0, "old")
        t.set_epoch(2)
        t.send(("a", "b"), 0, "dup")
        t.send(("a", "b"), 1, "current")
        assert t.recv(("a", "b"), 1) == "current"

    def test_sim_queues_name_no_semaphore(self):
        """A durable deployment records the named semaphores of its
        process transport for an adopter to reclaim; the simulator's
        queues have none."""
        from repro_torch.cluster.transport import queue_semaphores
        t = SimTransport()
        t.setup([("a", "b")], {("a", "b"): 2})
        assert t.named_resources() == ([], [])
        assert queue_semaphores([*t._queues.values(),
                                 SimContext.Queue()]) == []


class TestSeededDraw:
    @pytest.mark.parametrize("seed", range(50))
    def test_draw_matches_the_reference(self, seed):
        """Pure draw, no run: the same seed gives the same topology, host
        count, fault kind and events (``describe()``), recovery mode and
        brick rebuildability in both packages."""
        topo, factory, _, plan, sched, mode, rebuild = _draw(seed)
        jtopo, jfactory, _, jplan, jsched, jmode, jrebuild = _jdraw(seed)
        assert (topo, factory[1], plan.hosts(), sched.kind,
                sched.describe(), mode, rebuild) == (
            jtopo, jfactory[1], jplan.hosts(), jsched.kind,
            jsched.describe(), jmode, jrebuild)
        assert plan.assignment == jplan.assignment
        assert [_event_fields(e) for e in sched.events] == [
            _event_fields(e) for e in jsched.events]


def _event_fields(ev) -> tuple:
    return (ev.host, ev.op, ev.at, ev.action, ev.min_epoch, ev.brick,
            ev.stall_s)


def _oracle(factory, lib) -> float:
    net = factory[0](*factory[1])
    if lib == "jax":
        return float(jcore.run_sequential(net, 8)["collect"])
    return float(run_sequential(net, 8, device=CPU)["collect"])


class TestSimScenarios:
    """Fixed seeds covering every fault kind: cheap representatives of
    the 50-seed sweep, run in both packages."""

    @pytest.mark.parametrize("seed", FAST_SEEDS)
    def test_fixed_seed_scenarios_green_in_both_packages(self, seed):
        r = run_scenario(seed, device=CPU)
        j = jsim.run_scenario(seed)
        assert r.ok, "\n".join(r.failures)
        assert j.ok, "\n".join(j.failures)
        assert (r.kind, r.topology, r.hosts, r.schedule) == (
            j.kind, j.topology, j.hosts, j.schedule)
        _, factory, *_ = _draw(seed)
        _, jfactory, *_ = _jdraw(seed)
        assert _oracle(factory, "torch") == _oracle(jfactory, "jax")

    def test_fixed_seeds_cover_every_fault_kind(self):
        """The five fast-lane seeds hit all five scenario kinds; pinned so
        a generator change can't silently shrink coverage."""
        kinds = {_draw(seed)[4].kind for seed in FAST_SEEDS}
        assert kinds == {"kill", "stall", "double-kill",
                         "kill-during-recovery", "ctrl-step-kill"}

    def test_double_kill_replay_never_resurrects_stale_results(self):
        """A replay participant killed again mid-replay must NOT be
        backfilled from the failed batch's cached results (produced under
        the OLD partition) — seed 2 is that double-kill interleaving."""
        r = run_scenario(2, device=CPU)
        assert r.ok, "\n".join(r.failures)
        assert r.recoveries >= 1

    def test_networks_equal_the_reference(self):
        """The scenario networks in tensors (the reference's emit JAX
        arrays) fold to the reference's sums, exactly."""
        out = run_sequential(sim_farm(4, 2), 4, device=CPU)["collect"]
        assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
        assert float(out) == float(jnp.sum(jnp.arange(4.0) ** 2 + 1.0))
        for n, w in ((8, 2), (8, 3)):
            assert float(run_sequential(sim_farm(n, w), n,
                                        device=CPU)["collect"]) == float(
                jcore.run_sequential(jsim.sim_farm(n, w), n)["collect"])
        assert float(run_sequential(sim_pipeline(8), 8,
                                    device=CPU)["collect"]) == float(
            jcore.run_sequential(jsim.sim_pipeline(8), 8)["collect"])

    @pytest.mark.slow
    def test_seeded_sweep(self):
        """The full 50-seed sweep, in-suite for the slow lane."""
        bad = []
        for seed in range(50):
            r = run_scenario(seed, device=CPU)
            if not r.ok:
                bad.append(r.describe())
        assert not bad, "\n".join(bad)


class TestRouteAroundUnrebuildableBrick:
    def test_rebalance_fallback_forgets_bricked_fifo(self):
        """An unrebuildable bricked FIFO with survivors: the auto-fallback
        rebalance must FORGET the dead queue (reconfigure would otherwise
        reuse it for an unchanged (src, dst) key and wedge the relocated
        consumer) and recover bit-identically."""
        instances = 8
        factory = (sim_farm, (instances, 2))
        net = factory[0](*factory[1])
        plan = partition(net, hosts=2)
        consumer = plan.assignment["collect"]
        (c,) = plan.cut
        chan = (c.src, c.dst)
        sched = FaultSchedule([FaultEvent(host=consumer, op="recv", at=0,
                                          action="kill", brick=True)])
        t = SimTransport(sched, SimClock(), rebuildable=False)
        t.recv_timeout_s = 2.0  # the wedged producer errs fast
        oracle = float(run_sequential(net, instances, device=CPU)["collect"])
        ctrl = ClusterController(net, plan, ExecConfig(microbatch_size=2,
                                                       device=CPU),
                                 t, factory, 30.0)
        ctrl.poll_s = 0.05
        try:
            ctrl.start()
            t.track_hosts(ctrl._procs)
            old_q = t._queues[chan]
            sched.arm()
            with pytest.raises(ClusterError):
                ctrl.run_batch(instances)
            rec = ctrl.recover(mode="restart")  # auto-falls-back
            assert float(rec["collect"]) == oracle
            (ev,) = ctrl.events
            assert ev.auto_mode and "rebalance" in ev.auto_mode
            assert ev.bricked == [f"{chan[0]}->{chan[1]}"]
            # the dead FIFO was forgotten, not reused, wherever the
            # channel survived the rebalance
            assert t._queues.get(chan) is not old_q
            assert t.bricked_channels() == set()
        finally:
            ctrl.close()


class TestTimeoutPropagation:
    def test_recv_timeout_override_reaches_endpoints(self):
        """An instance-level recv_timeout_s override must ship with the
        endpoints spawned workers receive, or shrinking the knob only
        shrinks controller-side waits."""
        from repro_torch.cluster.transport import (MultiProcessPipe,
                                                   SharedMemoryRing)
        for t in (MultiProcessPipe(), SharedMemoryRing(), SimTransport()):
            try:
                t.recv_timeout_s = 7.5
                assert t.endpoint(0).recv_timeout_s == 7.5
            finally:
                t.close()


class TestUnrecoverableRefusal:
    def test_all_dead_unrebuildable_brick_refuses_cleanly(self):
        """Every host dead + a bricked FIFO the transport cannot rebuild:
        recovery is impossible by construction, and the controller must say
        so in bounded time instead of looping through rebalances."""
        instances = 8
        factory = (sim_farm, (instances, 2))
        net = factory[0](*factory[1])
        plan = partition(net, hosts=2)
        consumer = plan.assignment["collect"]
        others = [h for h in plan.hosts() if h != consumer]
        sched = FaultSchedule(
            [FaultEvent(host=consumer, op="recv", at=0, action="kill",
                        brick=True)]
            + [FaultEvent(host=h, op="park", at=0, action="kill")
               for h in others])
        t = SimTransport(sched, SimClock(), rebuildable=False)
        ctrl = ClusterController(net, plan, ExecConfig(microbatch_size=2,
                                                       device=CPU),
                                 t, factory, 30.0)
        ctrl.poll_s = 0.05
        try:
            ctrl.start()
            t.track_hosts(ctrl._procs)
            sched.arm()
            with pytest.raises(ClusterError):
                ctrl.run_batch(instances)
            with pytest.raises(NetworkError, match="cannot be recovered"):
                ctrl.recover()
        finally:
            ctrl.close()


@pytest.mark.slow
class TestRealPipeBrick:
    def test_pipe_brick_scenario_recovers_bit_identically(self):
        """SIGKILL mid-recv on the real pipe transport leaves a corpse
        holding the mp queue's reader lock; recover() must detect it,
        rebuild the FIFO, force-restart the live producer, and replay
        bit-identically."""
        r = run_pipe_brick_scenario(timeout_s=20.0, device=CPU)
        assert r.ok, "\n".join(r.failures)

