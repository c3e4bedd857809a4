"""The port's cost model against the JAX package's, on the CPU.

The reference's ``tests/test_cluster.py::TestCostPartitioning`` and
``test_derived_capacities_floor_under_coalescing`` on the port, every
deployment on ``device="cpu"``; then the two packages side by side: a
:class:`CostProfile` saved by either loads in the other, ``cost_assignment``
cuts the same network the same way on the same profile, ``calibrate``
measures the same stages with the same output bytes, and the port's counted
flops prior is positive wherever the JAX package's ``cost_analysis`` is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster as jcl
import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.cluster import (ClusterDeployment, CostProfile, ExecConfig,
                                 ProcessCost, calibrate, calibrate_bandwidth,
                                 check_redeployment, check_refinement,
                                 cost_assignment, derive_cut_capacities,
                                 partition)
from repro_torch.cluster.costs import _count_prior, _leaf_signature
from repro_torch.core import run_sequential

CPU = "cpu"


def _sq(x):
    return x * x


def _inc(x):
    return x + 1.0


def _add(a, x):
    return a + x


def _item(lib):
    if lib == "jax":
        return lambda i: jnp.asarray(float(i))
    return lambda i: torch.tensor(float(i))


def _zero(lib):
    return jnp.asarray(0.0) if lib == "jax" else torch.tensor(0.0)


def _core(lib):
    return jcore if lib == "jax" else tcore


def _farm(lib="torch", workers=3):
    return _core(lib).DataParallelCollect(
        create=_item(lib), function=_sq, collector=_add, init=_zero(lib),
        workers=workers, jit_combine=True)


def _pipeline(lib="torch"):
    return _core(lib).OnePipelineCollect(
        create=_item(lib), stage_ops=[_sq, _inc], collector=_add,
        init=_zero(lib), jit_combine=True)


def _skewed_net(lib="torch"):
    # four stages, uniform COUNT, skewed COST (stage0/stage1 heavy)
    return _core(lib).OnePipelineCollect(
        create=_item(lib), stage_ops=[_sq, _sq, _inc, _inc], collector=_add,
        init=_zero(lib), jit_combine=True)


def _skewed_costs(heavy=("stage0", "stage1")) -> dict:
    return {"costs": {name: {"name": name, "shape": [], "dtype": "float32",
                             "wall_s": 1e-3 if name in heavy else 1e-6,
                             "out_bytes": 8, "flops": 0.0,
                             "bytes_accessed": 0.0, "source": "measured"}
                      for name in ("emit", "stage0", "stage1", "stage2",
                                   "stage3", "collect")},
            "bandwidths": {"inprocess": 1e9}, "microbatch_size": 8,
            "seed": 0, "default_wall_s": 1e-6, "flops_per_s": 0.0}


def _skewed_profile(heavy=("stage0", "stage1")) -> CostProfile:
    return CostProfile.from_json(_skewed_costs(heavy))


def test_derived_capacities_floor_under_coalescing():
    """With coalescing on but a cut whose records exceed the budget, the
    derived FIFO must match what the per-record path would get."""
    plan = partition(_farm(), hosts=2)
    (c,) = plan.cut
    profile = CostProfile(costs={c.src: ProcessCost(
        name=c.src, out_bytes=1 << 20)})  # 1 MiB records
    cfg = ExecConfig(max_in_flight=1, lanes=1,
                     coalesce_bytes=1 << 10,  # far below one record
                     profile=profile)
    plain = derive_cut_capacities(plan, ExecConfig(max_in_flight=1, lanes=1))
    assert derive_cut_capacities(plan, cfg, profile=profile) == plain


class TestCostPartitioning:
    """Measured-cost planning: calibrate once, cut by TIME not by count,
    emit an ordinary PartitionPlan that faces the same §6.1.1 proof
    obligations (and hot-swaps through reconfigure)."""

    def test_cost_cut_differs_from_count_cut_and_refines(self):
        net = _skewed_net()
        profile = _skewed_profile()
        count_plan = partition(net, hosts=2)
        cost_plan = partition(net, assignment=cost_assignment(
            net, 2, profile, transport="inprocess"))
        a = count_plan.assignment
        assert a["stage0"] == a["stage1"]  # count piles the heavies up
        assert (cost_plan.assignment["stage0"]
                != cost_plan.assignment["stage1"])  # cost splits them 1/1
        for plan in (count_plan, cost_plan):
            assert check_refinement(net, plan)
        assert check_redeployment(net, count_plan, cost_plan)

    def test_cost_assignment_may_use_fewer_hosts(self):
        # transfer dwarfs compute: every cut costs ~1000 s, so the cheapest
        # legal plan is all-on-one-host even when three are offered
        net = _pipeline()
        costs = {n: ProcessCost(name=n, shape=(), dtype="float32",
                                wall_s=1e-7, out_bytes=1 << 20)
                 for n in ("emit", "stage0", "stage1", "collect")}
        profile = CostProfile(costs=costs, bandwidths={"inprocess": 1e3})
        a = cost_assignment(net, 3, profile, transport="inprocess")
        assert len(set(a.values())) == 1
        assert check_refinement(net, partition(net, assignment=a))

    def test_calibrate_measures_every_stage(self):
        net = _pipeline()
        profile = calibrate(net, instances=4, microbatch_size=2,
                            transports=("inprocess",), device=CPU)
        for name in ("stage0", "stage1", "collect"):
            c = profile.costs[name]
            assert c.source == "measured"
            assert c.wall_s > 0
        assert profile.bandwidths.get("inprocess", 0) > 0
        # the json round trip plans identically to the live profile
        rt = CostProfile.from_json(profile.to_json())
        assert (cost_assignment(net, 2, profile, transport="inprocess")
                == cost_assignment(net, 2, rt, transport="inprocess"))

    def test_hot_swap_to_cost_plan_via_reconfigure(self):
        net = _skewed_net()
        n = 8
        seq = run_sequential(net, n, device=CPU)
        cost_plan = partition(net, assignment=cost_assignment(
            net, 2, _skewed_profile(), transport="inprocess"))
        with ClusterDeployment(net, hosts=2, transport="inprocess",
                               microbatch_size=2, device=CPU) as dep:
            out = dep.run(instances=n)
            assert bool(out["collect"] == seq["collect"])
            ev = dep.reconfigure(plan=cost_plan)
            assert ev.mode == "reconfigure" and ev.refined is True
            assert dep.plan.assignment == cost_plan.assignment
            out2 = dep.run(instances=n)
            assert bool(out2["collect"] == seq["collect"])

    def test_coalesced_deployment_bit_identical(self):
        net = _farm(workers=3)
        seq = run_sequential(net, 12, device=CPU)
        with ClusterDeployment(net, hosts=2, transport="inprocess",
                               microbatch_size=2, coalesce_bytes=1 << 14,
                               device=CPU) as dep:
            for _ in range(2):
                out = dep.run(instances=12)
                assert bool(out["collect"] == seq["collect"])

    def test_cost_profile_deployment_bit_identical(self):
        """A deployment handed the profile (``profile=``: coalesced cut
        sizing) of a calibrated farm stays equal to the oracle."""
        net = _farm(workers=3)
        seq = run_sequential(net, 12, device=CPU)
        profile = calibrate(net, microbatch_size=2, device=CPU)
        with ClusterDeployment(net, plan=partition(net, assignment=(
                cost_assignment(net, 2, profile))), transport="device",
                microbatch_size=2, coalesce_bytes=1 << 14,
                profile=profile, device=CPU) as dep:
            out = dep.run(instances=12)
            assert bool(out["collect"] == seq["collect"])


# ==========================================================================
# the two packages side by side
# ==========================================================================

class TestAgainstJax:
    def test_jax_profile_loads_in_the_port(self, tmp_path):
        path = str(tmp_path / "jax.json")
        jprof = jcl.calibrate(_pipeline("jax"), instances=4,
                              microbatch_size=2, transports=("inprocess",))
        jprof.save(path)
        ours = CostProfile.load(path)
        assert ours.to_json() == jprof.to_json()
        assert ours.describe() == jprof.describe()
        net = _pipeline()
        for hosts in (1, 2, 3):
            assert (cost_assignment(net, hosts, ours, transport="inprocess")
                    == jcl.cost_assignment(_pipeline("jax"), hosts, jprof,
                                           transport="inprocess"))

    def test_port_profile_loads_in_jax(self, tmp_path):
        path = str(tmp_path / "port.json")
        prof = calibrate(_pipeline(), instances=4, microbatch_size=2,
                         transports=("inprocess", "device"), device=CPU)
        prof.save(path)
        theirs = jcl.CostProfile.load(path)
        assert theirs.to_json() == prof.to_json()
        assert theirs.describe() == prof.describe()
        for name in prof.costs:
            assert theirs.time_of(name) == prof.time_of(name)
            assert theirs.out_bytes_of(name) == prof.out_bytes_of(name)
        assert theirs.transfer_s(4096, "device") == \
            prof.transfer_s(4096, "device")

    @pytest.mark.parametrize("heavy", [("stage0", "stage1"), ("stage3",),
                                       ("emit", "collect")])
    @pytest.mark.parametrize("hosts", [1, 2, 3, 4])
    def test_cost_assignment_equals_jax(self, heavy, hosts):
        d = _skewed_costs(heavy)
        ours = cost_assignment(_skewed_net(), hosts,
                               CostProfile.from_json(d),
                               transport="inprocess")
        theirs = jcl.cost_assignment(_skewed_net("jax"), hosts,
                                     jcl.CostProfile.from_json(d),
                                     transport="inprocess")
        assert ours == theirs

    @pytest.mark.parametrize("make,instances", [(_pipeline, 4),
                                                (_skewed_net, 4),
                                                (_farm, 6)])
    def test_calibrate_measures_the_stages_jax_measures(self, make,
                                                        instances):
        prof = calibrate(make(), instances=instances, microbatch_size=2,
                         device=CPU)
        jprof = jcl.calibrate(make("jax"), instances=instances,
                              microbatch_size=2)
        assert sorted(prof.costs) == sorted(jprof.costs)
        for name, c in prof.costs.items():
            j = jprof.costs[name]
            assert c.source == "measured" and c.wall_s > 0, name
            assert c.out_bytes == j.out_bytes, name
            assert c.signature() == j.signature(), name
            # only the sign of the prior is compared, not its value
            if j.flops > 0:
                assert c.flops > 0, name
                assert c.bytes_accessed > 0, name
        assert prof.default_wall_s > 0

    def test_signature_spells_dtypes_as_jax_does(self):
        x = torch.zeros(2, 3)
        assert _leaf_signature((x,)) == ((2, 3), "float32")
        assert _leaf_signature(({"a": torch.zeros(4, dtype=torch.int32)},)) \
            == ((4,), "int32")
        assert _leaf_signature(()) == ((), "")


class TestCalibration:
    def test_incremental_calibration_keeps_unchanged_stages(self):
        net = _pipeline()
        first = calibrate(net, instances=4, microbatch_size=2, device=CPU)
        before = {n: c.wall_s for n, c in first.costs.items()}
        again = calibrate(net, instances=4, microbatch_size=2,
                          profile=first, device=CPU)
        assert again is first
        assert {n: c.wall_s for n, c in again.costs.items()} == before

    def test_prior_counts_matmul_and_elementwise_ops(self):
        a, b = torch.ones(4, 8), torch.ones(8, 5)
        flops, nbytes = _count_prior(lambda x, y: x @ y, (a, b))
        assert flops == 2 * 4 * 8 * 5  # flop_counter's mm formula
        assert nbytes == (4 * 8 + 8 * 5 + 4 * 5) * 4
        flops, nbytes = _count_prior(lambda x: x * x + 1.0, (a,))
        assert flops == 2 * 32  # two ops, one flop an output element each
        assert nbytes >= 4 * 32 * 4

    @pytest.mark.parametrize("kind", ["inprocess", "device", "pipe", "shm"])
    def test_calibrate_bandwidth_every_transport(self, kind):
        bw = calibrate_bandwidth(kind, payload_bytes=1 << 12, repeats=4,
                                 device=CPU)
        assert np.isfinite(bw) and bw > 0

    def test_transfer_falls_back_to_the_fastest_transport(self):
        prof = CostProfile(bandwidths={"pipe": 1e6, "device": 1e9})
        assert prof.transfer_s(1000, "device") == 1e-6
        assert prof.transfer_s(1000, "shm") == 1e-6  # uncalibrated kind
        assert prof.transfer_s(1000, "pipe") == 1e-3
        assert prof.transfer_s(0, "pipe") == 0.0
        assert CostProfile().transfer_s(1000, "pipe") == 0.0

    def test_time_of_prefers_measured_then_prior_then_default(self):
        prof = CostProfile(costs={
            "m": ProcessCost("m", wall_s=2e-3, flops=1e9),
            "e": ProcessCost("e", flops=1e6, source="estimated")},
            default_wall_s=5e-7, flops_per_s=1e9)
        assert prof.time_of("m") == 2e-3
        assert prof.time_of("e") == pytest.approx(1e-3)
        assert prof.time_of("absent") == 5e-7

    @pytest.mark.parametrize("run", [
        lambda: calibrate(_pipeline(), instances=4, microbatch_size=2),
        lambda: calibrate_bandwidth("inprocess")],
        ids=["calibrate", "calibrate_bandwidth"])
    def test_card_by_default_refuses_without_gpu(self, run, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
