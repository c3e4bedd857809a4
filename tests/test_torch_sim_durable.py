"""The port's simulator over durability, races and coalescing, on the CPU.

The reference's controller-crash cases (``tests/test_durable.py``
``TestControllerCrashScenarios``): each of the five variants — the
controller dying idle with its hosts salvaged or lost, mid-batch, with
every host, or with a host dying mid-snapshot-write — and the stall race,
in both packages on the same seeded schedule, each green.  Two
kill-during-coalesced-send seeds, likewise.  The reference's golden sim
trace (``tests/test_trace.py`` ``TestSimGoldenTrace``): two runs' Chrome
exports byte-identical, with three pids.  The scenario families that wait
for later steps of the port refuse, naming their step, and every entry
point refuses to run without a GPU unless it is given the CPU.
"""

import json
import random

import pytest
import torch

import repro.cluster.sim as jsim
import repro.core as jcore
from repro_torch.cluster import ClusterDeployment
from repro_torch.cluster import sim
from repro_torch.cluster.sim import _topology_draw
from repro_torch.core import DataParallelCollect, run_sequential, trace

CPU = "cpu"


def _same_outcome(r, j) -> None:
    assert r.ok, r.failures
    assert j.ok, j.failures
    assert (r.kind, r.topology, r.hosts, r.schedule, r.fired) == (
        j.kind, j.topology, j.hosts, j.schedule, j.fired)


def _same_oracle(factory, instances) -> None:
    """The scenario's network folds to the same number in both packages:
    each scenario holds its results to its own package's oracle, so this
    ties the two scenarios' results to each other."""
    fn, args = factory
    got = run_sequential(fn(*args), instances, device=CPU)["collect"]
    want = jcore.run_sequential(getattr(jsim, fn.__name__)(*args),
                                instances)["collect"]
    assert float(got) == float(want)


def _kill_controller_factory(seed):
    # the scenario's first draw: the farm's width over 12 items
    return (sim.sim_farm, (12, random.Random(seed).choice((2, 3))))


def _topology_factory(seed):
    _, instances, factory, _, _ = _topology_draw(random.Random(seed))
    return factory, instances


class TestControllerCrashScenarios:
    """The seeded variants, one fixed seed each, as the reference pins
    them; the sweep is ``python -m repro_torch.cluster.sim
    --kill-controller N``."""

    @pytest.mark.parametrize("variant", ["idle-salvage", "idle-fresh",
                                         "midbatch", "kill-all-hosts",
                                         "snap-kill"])
    def test_variant_green(self, variant):
        res = sim.run_kill_controller_scenario(7, variant=variant,
                                               device=CPU)
        ref = jsim.run_kill_controller_scenario(7, variant=variant)
        _same_outcome(res, ref)
        _same_oracle(_kill_controller_factory(7), 12)
        assert res.recoveries >= 1

    def test_stall_race_green(self):
        res = sim.run_stall_race_scenario(0, device=CPU)
        ref = jsim.run_stall_race_scenario(0)
        _same_outcome(res, ref)
        _same_oracle(*_topology_factory(0))
        assert res.recoveries >= 1

    def test_no_host_thread_outlives_a_variant(self):
        """The dead controller's hosts that the adopter did not take over
        are ended with the scenario."""
        import threading
        before = set(threading.enumerate())
        res = sim.run_kill_controller_scenario(4, variant="snap-kill",
                                               device=CPU)
        assert res.ok, res.failures
        left = [t.name for t in set(threading.enumerate()) - before
                if t.name.startswith("gpp-host-")]
        assert not left, left


class TestCoalesceKill:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_coalesce_kill_green(self, seed):
        res = sim.run_coalesce_kill_scenario(seed, device=CPU)
        ref = jsim.run_coalesce_kill_scenario(seed)
        _same_outcome(res, ref)
        _same_oracle(*_topology_factory(seed))
        assert res.fired == 1 and res.recoveries >= 1


def _farm_factory(workers):
    return DataParallelCollect(
        create=lambda i: torch.tensor(float(i)),
        function=lambda x: x * x,
        collector=lambda a, x: a + x, init=torch.tensor(0.0),
        workers=workers, jit_combine=True)


class TestSimGoldenTrace:
    def _one(self):
        """One no-fault sim deployment under per-host counting clocks."""
        trace.configure(clock="counting")
        try:
            net = _farm_factory(2)
            with ClusterDeployment(net, hosts=2,
                                   transport=sim.SimTransport(),
                                   microbatch_size=2, trace=True,
                                   factory=(_farm_factory, (2,)),
                                   device=CPU) as dep:
                dep.run(instances=8)
                return dep.export_trace()
        finally:
            trace.configure(clock=None)

    def test_sim_export_byte_identical(self):
        """Virtual clocks + sorted merge + sorted JSON keys make the sim's
        exported Chrome trace a pure function of the scenario."""
        a, b = self._one(), self._one()
        assert a == b
        doc = json.loads(a)
        assert len({e["pid"] for e in doc["traceEvents"]}) == 3


class TestLaterSteps:
    def test_workload_scenario_names_step_9_6(self):
        with pytest.raises(NotImplementedError, match=r"step 9\.6"):
            sim.run_workload_scenario(0, device=CPU)

    def test_serve_kill_scenario_names_step_9_8(self):
        with pytest.raises(NotImplementedError, match=r"step 9\.8"):
            sim.run_serve_kill_scenario(0, device=CPU)

    @pytest.mark.parametrize("flag,step", [("--workload", r"9\.6"),
                                           ("--serve-kill", r"9\.8")])
    def test_cli_flags_name_their_step(self, flag, step):
        with pytest.raises(NotImplementedError, match=f"step {step}"):
            sim.main([flag, "2", "--device", CPU])


class TestDevice:
    @pytest.mark.parametrize("run", [
        lambda: sim.run_scenario(1),
        lambda: sim.run_kill_controller_scenario(0),
        lambda: sim.run_stall_race_scenario(0),
        lambda: sim.run_coalesce_kill_scenario(0),
        lambda: sim.run_pipe_brick_scenario(),
        lambda: sim.main(["--seeds", "1"]),
    ], ids=["scenario", "kill-controller", "stall-race", "coalesce-kill",
            "pipe-brick", "main"])
    def test_card_by_default_refuses_without_gpu(self, run, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()

    def test_cli_on_the_cpu(self, capsys):
        assert sim.main(["--device", CPU, "--kill-controller", "2"]) == 0
        out = capsys.readouterr().out
        assert "2 scenario(s)" in out and "0 failed" in out
