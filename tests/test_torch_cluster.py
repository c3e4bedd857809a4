"""The port's cluster runtime against the JAX package's, on the CPU.

Planning (assignments, cut lists, refinement verdicts, derived cut
capacities) must equal the JAX package's for the same networks.  Thread
hosts over the ``inprocess`` and ``device`` transports (``device="cpu"``)
must reproduce the port's sequential oracle bit for bit, as the
reference's ``tests/test_cluster.py`` demands of every transport, and the
farm and pipeline also agree with the JAX package's own
``run_cluster(..., transport="inprocess")``.  Spawned process hosts
(``pipe``, ``shm``) are in ``test_torch_cluster_procs.py``; the
transports' packing and the shared-memory ring are tested here, without
spawning.  Elastic recovery over thread hosts (restart, rebalance,
reconfigure) must give the JAX package's :class:`RecoveryEvent` and plan
for the same injected failure.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster as jcl
import repro.core as jcore
import repro_torch.core as tcore
from repro.core import stream as jstream
from repro_torch import workloads
from repro_torch.cluster import (ClusterDeployment, ClusterError,
                                 DeviceTransport, ExecConfig, InProcess,
                                 MultiProcessPipe, PartitionExecutor,
                                 SharedMemoryRing, abstract_partitioned_model,
                                 auto_assignment, check_redeployment,
                                 check_refinement, cost_assignment,
                                 derive_cut_capacities, make_host_executor,
                                 make_transport, partition,
                                 repartition_without, run_cluster)
from repro_torch.cluster import transport as tr
from repro_torch.core import (Collect, CombineNto1, DataParallelCollect,
                              Emit, GroupOfPipelineCollects, Network,
                              NetworkError, OnePipelineCollect,
                              OneSeqCastList, Worker, build, csp, netlog,
                              run_sequential)
from repro_torch.core import stream
from repro_torch.core.dataflow import Kind
from repro_torch.interop import tree_from_numpy

CPU = "cpu"


# -- the same networks in both packages ---------------------------------------

def _sq(x):
    return x * x


def _inc(x):
    return x + 1.0


def _add(a, x):
    return a + x


def _items(lib):
    if lib == "jax":
        return lambda i: jnp.asarray(float(i))
    return lambda i: torch.tensor(float(i))


def _zero(lib):
    return jnp.asarray(0.0) if lib == "jax" else torch.tensor(0.0)


def _core(lib):
    return jcore if lib == "jax" else tcore


def _farm(lib="torch", n=10, workers=3, **kw):
    return _core(lib).DataParallelCollect(
        create=_items(lib), function=_sq, collector=_add, init=_zero(lib),
        workers=workers, jit_combine=True, **kw)


def _pipeline(lib="torch", n=7):
    return _core(lib).OnePipelineCollect(
        create=_items(lib), stage_ops=[_sq, _inc], collector=_add,
        init=_zero(lib), jit_combine=True)


def _gop(lib="torch"):
    return _core(lib).GroupOfPipelineCollects(
        create=_items(lib), stage_ops=[_sq, _inc, _inc], collector=_add,
        init=_zero(lib), jit_combine=True, groups=3)


def _capped(lib="torch"):
    c = _core(lib)
    net = c.Network("capped")
    net.add(c.Emit(_items(lib), name="emit"), c.Worker(_sq, name="w"))
    net.procs["collect"] = c.Collect(_add, init=_zero(lib), jit_combine=True,
                                     name="collect")
    net.connect("w", "collect", capacity=1)
    return net


NETS = {"farm": _farm, "farm_explicit": lambda lib: _farm(lib, 12, 4,
                                                         explicit=True),
        "pipeline": _pipeline, "gop": _gop, "capped": _capped}


def _cut(plan):
    return [(c.src, c.dst, c.capacity) for c in plan.cut]


def _seq(net, n):
    return run_sequential(net, n, device=CPU)


# ==========================================================================
# planning
# ==========================================================================

class TestPartitionPlanning:
    @pytest.mark.parametrize("hosts", [1, 2, 3, 4])
    @pytest.mark.parametrize("name", sorted(NETS))
    def test_auto_plan_equals_jax(self, name, hosts):
        ours = partition(NETS[name]("torch"), hosts=hosts)
        theirs = jcl.partition(NETS[name]("jax"), hosts=hosts)
        assert ours.assignment == theirs.assignment
        assert _cut(ours) == _cut(theirs)
        assert ours.hosts() == theirs.hosts()
        assert ours.n_hosts == theirs.n_hosts
        for h in ours.hosts():
            sub, jsub = ours.subnetwork(h), theirs.subnetwork(h)
            assert list(sub.procs) == list(jsub.procs)
            assert [(c.src, c.dst) for c in sub.channels] == \
                [(c.src, c.dst) for c in jsub.channels]
        assert ours.describe() == theirs.describe()

    def test_auto_balanced_cut_farm(self):
        net = _farm()
        plan = partition(net, hosts=2)
        assert plan.hosts() == [0, 1]
        (c,) = plan.cut
        assert len(net.successors(c.src)) == 1  # never cuts a fan

    def test_explicit_farm_branches_stay_with_spreader(self):
        net = _farm(n=9, workers=3, explicit=True)
        a = auto_assignment(net, 2)
        assert len({a[w] for w in net.successors("ofa")} | {a["ofa"]}) == 1
        assert a == jcl.auto_assignment(_farm("jax", 9, 3, explicit=True), 2)

    def test_place_pins_override_auto(self):
        ours, theirs = _pipeline(), _pipeline("jax")
        for net in (ours, theirs):
            net.place("stage0", host=0).place("stage1", host=1)
        plan = partition(ours, hosts=2)
        assert plan.assignment["stage0"] == 0
        assert plan.assignment["stage1"] == 1
        assert plan.assignment == jcl.partition(theirs, hosts=2).assignment

    @pytest.mark.parametrize("case", ["cyclic", "fan", "missing"])
    def test_illegal_plans_rejected_as_jax_rejects(self, case):
        if case == "cyclic":
            build_net, match = _pipeline, "cyclic"
            a = {"emit": 1, "stage0": 1, "stage1": 0, "collect": 1}
        elif case == "fan":
            build_net, match = (lambda lib="torch": _farm(lib, 9, 3,
                                                          explicit=True),
                                "fans out")
            a = auto_assignment(build_net(), 1)
            for name in ("worker1", "afo", "collect"):
                a[name] = 1
        else:
            build_net, match, a = _pipeline, "no host for", {"emit": 0}
        with pytest.raises(NetworkError, match=match):
            partition(build_net(), assignment=a)
        with pytest.raises(jcore.NetworkError, match=match):
            jcl.partition(build_net("jax"), assignment=a)

    def test_place_validates(self):
        net = _pipeline()
        with pytest.raises(NetworkError, match="unknown process"):
            net.place("nope", host=0)
        with pytest.raises(NetworkError, match="host must be"):
            net.place("stage0", host=-1)

    def test_single_host_plan_has_no_cut(self):
        plan = partition(_farm(), hosts=1)
        assert plan.cut == [] and plan.hosts() == [0]

    @pytest.mark.parametrize("hosts", [1, 2, 3])
    @pytest.mark.parametrize("name", ["pipeline", "gop", "farm"])
    def test_cost_assignment_equals_jax(self, name, hosts):
        """The interval DP on the same profile (any object with time_of,
        out_bytes_of and transfer_s; a heavy middle stage)."""
        class Profile:
            def time_of(self, p):
                return {"stage1": 5.0, "group": 4.0}.get(p, 1.0)

            def out_bytes_of(self, p):
                return 1000 + 10 * len(p)

            def transfer_s(self, nbytes, transport=None):
                return nbytes * 1e-4

        ours = cost_assignment(NETS[name]("torch"), hosts, Profile())
        theirs = jcl.cost_assignment(NETS[name]("jax"), hosts, Profile())
        assert ours == theirs
        partition(NETS[name]("torch"), assignment=ours)

    @pytest.mark.parametrize("failed", [[0], [1], [2], [0, 2]])
    def test_repartition_without_equals_jax(self, failed):
        ours = partition(_pipeline(), hosts=3)
        theirs = jcl.partition(_pipeline("jax"), hosts=3)
        assert repartition_without(ours, failed) == \
            jcl.repartition_without(theirs, failed)


class TestCutRefinement:
    """core/csp.py across a partition cut: the partitioned model and the
    original refine each other — the paper's ``[T=`` in BOTH directions —
    with the JAX package's verdicts."""

    @pytest.mark.parametrize("hosts", [2, 3])
    @pytest.mark.parametrize("name", ["farm", "pipeline", "capped"])
    def test_refinement_verdicts_equal_jax(self, name, hosts):
        net, jnet = NETS[name]("torch"), NETS[name]("jax")
        plan, jplan = partition(net, hosts=hosts), jcl.partition(
            jnet, hosts=hosts)
        part = abstract_partitioned_model(net, plan)
        jpart = jcl.abstract_partitioned_model(jnet, jplan)
        assert list(part.procs) == list(jpart.procs)
        ours = (csp.trace_equivalent(part, net, instances=3),
                csp.trace_equivalent(net, part, instances=3),
                check_refinement(net, plan))
        theirs = (jcore.csp.trace_equivalent(jpart, jnet, instances=3),
                  jcore.csp.trace_equivalent(jnet, jpart, instances=3),
                  jcl.check_refinement(jnet, jplan))
        assert ours == theirs == (True, True, True)

    def test_relay_model_is_safe(self):
        net = _farm()
        r = csp.check(abstract_partitioned_model(net, partition(net, hosts=2)),
                      instances=3)
        assert r.deadlock_free and r.divergence_free
        assert r.all_paths_terminate and r.deterministic

    def test_three_way_cut_refines(self):
        net = _pipeline()
        plan = partition(net, hosts=3)
        assert len(plan.cut) >= 2
        assert check_refinement(net, plan)

    def test_redeployment_verdict_equals_jax(self):
        net, jnet = _pipeline(), _pipeline("jax")
        old, jold = partition(net, hosts=3), jcl.partition(jnet, hosts=3)
        new = partition(net, assignment=repartition_without(old, [1]))
        jnew = jcl.partition(jnet,
                             assignment=jcl.repartition_without(jold, [1]))
        assert check_redeployment(net, old, new) == \
            jcl.check_redeployment(jnet, jold, jnew)


# ==========================================================================
# thread hosts: inprocess and device (on the CPU)
# ==========================================================================

TRANSPORTS = ["inprocess", "device"]


class TestInProcessCluster:
    """Thread hosts, queue channels: results ≡ the port's sequential
    oracle, and the JAX package's cluster."""

    @pytest.mark.parametrize("transport", TRANSPORTS)
    @pytest.mark.parametrize("hosts,mb", [(2, 3), (2, 4), (3, 2)])
    def test_farm_bit_identical(self, hosts, mb, transport):
        net = _farm()
        seq = _seq(net, 10)["collect"]
        out = run_cluster(net, instances=10, hosts=hosts, microbatch_size=mb,
                          transport=transport, device=CPU)
        assert torch.equal(out["collect"], seq)
        assert all(r.ok for r in out.reports)
        theirs = jcl.run_cluster(_farm("jax"), instances=10, hosts=hosts,
                                 microbatch_size=mb)
        assert float(out["collect"]) == float(theirs["collect"])

    @pytest.mark.parametrize("transport", TRANSPORTS)
    def test_pipeline_uneven_chunks(self, transport):
        net = _pipeline()
        seq = _seq(net, 7)["collect"]
        out = run_cluster(net, instances=7, hosts=2, microbatch_size=3,
                          transport=transport, device=CPU)
        assert torch.equal(out["collect"], seq)
        theirs = jcl.run_cluster(_pipeline("jax"), instances=7, hosts=2,
                                 microbatch_size=3)
        assert float(out["collect"]) == float(theirs["collect"])

    def test_gop_composite(self):
        net = _gop()
        seq = _seq(net, 12)["collect"]
        out = run_cluster(net, instances=12, hosts=2, microbatch_size=4,
                          device=CPU)
        assert torch.equal(out["collect"], seq)

    def test_host_side_dict_collector(self):
        net = DataParallelCollect(
            create=_items("torch"), function=_sq,
            collector=lambda acc, x: {**acc, len(acc): float(x)},
            init={}, workers=2, jit_combine=False)
        out = run_cluster(net, instances=5, hosts=2, microbatch_size=2,
                          device=CPU)
        assert out["collect"] == {i: float(i * i) for i in range(5)}

    def test_combine_reducer_across_cut(self):
        """COMBINE emits nothing until its final chunk: SKIP markers keep
        the cut channel chunk-aligned."""
        vals = torch.arange(12, dtype=torch.float32)
        net = Network("comb")
        net.add(Emit(lambda i: vals[i], name="emit"),
                OneSeqCastList(name="cast"))
        for w in range(2):
            net.procs[f"w{w}"] = Worker(_sq if w == 0 else _inc,
                                        name=f"w{w}", tag=f"f{w}")
            net.connect("cast", f"w{w}")
        net.procs["comb"] = CombineNto1(lambda a, b: a + b, name="comb")
        net.connect("w0", "comb")
        net.connect("w1", "comb")
        net._tail = "comb"
        net.add(Collect(_add, init=torch.tensor(0.0), jit_combine=True,
                        name="collect"))
        assignment = {n: 0 for n in net.procs}
        assignment["collect"] = 1
        plan = partition(net, assignment=assignment)
        assert [(c.src, c.dst) for c in plan.cut] == [("comb", "collect")]
        streamed = build(net, device=CPU).run_streaming(instances=12,
                                                        microbatch_size=5)
        out = run_cluster(net, instances=12, plan=plan, microbatch_size=5,
                          device=CPU)
        assert torch.equal(out["collect"], streamed["collect"])

    def test_capacity_bounds_transport_queue(self):
        net = _capped()
        plan = partition(net, assignment={"emit": 0, "w": 0, "collect": 1})
        t = InProcess()
        out = run_cluster(net, instances=8, plan=plan, transport=t,
                          microbatch_size=2, device=CPU)
        assert float(out["collect"]) == float(sum(i ** 2 for i in range(8)))
        assert t._queues[("w", "collect")].maxsize == 1

    def test_results_carry_reports(self):
        out = run_cluster(_farm(), instances=10, hosts=2, microbatch_size=5,
                          device=CPU)
        assert {r.host for r in out.reports} == {0, 1}
        assert all("stream:" in r.stats_summary for r in out.reports)
        assert all("donation" in r.donation_summary for r in out.reports)
        assert out.epoch == 1

    @pytest.mark.parametrize("coalesce", [64, 1 << 20])
    def test_coalesced_channel_bit_identical(self, coalesce):
        """Records coalesced into one queue put (small and large budgets:
        every record alone, and the whole stream in one put)."""
        net = _pipeline()
        with ClusterDeployment(net, hosts=2, microbatch_size=1,
                               coalesce_bytes=coalesce, device=CPU) as dep:
            for _ in range(2):
                out = dep.run(instances=7)
                assert torch.equal(out["collect"], _seq(net, 7)["collect"])

    def test_no_device_without_gpu_raises(self, monkeypatch):
        """Thread hosts run on the card unless asked for the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_cluster(_farm(), instances=4, hosts=2, microbatch_size=2)


class TestWorkloadsOverThreadHosts:
    """The paper's farm and pipeline, as the chip run drives them, at a
    tiny size."""

    @pytest.mark.parametrize("transport", TRANSPORTS)
    def test_mandelbrot_farm(self, transport):
        net = workloads.mandelbrot_factory(48, 24, 6, 30)
        seq = workloads.assemble(_seq(net, 6)["collect"])
        with ClusterDeployment(net, hosts=2, transport=transport,
                               microbatch_size=2, device=CPU) as dep:
            for _ in range(2):
                out = dep.run(instances=6)
                assert np.array_equal(workloads.assemble(out["collect"]),
                                      seq)

    @pytest.mark.parametrize("transport", TRANSPORTS)
    def test_image_pipeline_cut_between_engines(self, transport):
        imgs = tree_from_numpy(workloads.synthetic_images(3, 24), CPU)
        net = workloads.image_pipeline(imgs)
        assignment = {n: 0 for n in net.procs}
        assignment["engine2"] = assignment["collector"] = 1
        plan = partition(net, assignment=assignment)
        assert [(c.src, c.dst) for c in plan.cut] == [("engine1", "engine2")]
        seq = _seq(net, 3)["collector"]
        out = run_cluster(net, instances=3, plan=plan, transport=transport,
                          microbatch_size=2, device=CPU)
        assert len(out["collector"]) == 3
        for a, b in zip(out["collector"], seq):
            assert np.array_equal(a, b)


# ==========================================================================
# capacities
# ==========================================================================

CFGS = [dict(), dict(max_in_flight=7), dict(max_in_flight=1, lanes=1),
        dict(lanes=5), dict(microbatch_size=5)]


class TestDerivedCapacities:
    @pytest.mark.parametrize("cfg", CFGS, ids=str)
    @pytest.mark.parametrize("hosts", [2, 3])
    @pytest.mark.parametrize("name", sorted(NETS))
    def test_capacities_equal_jax(self, name, hosts, cfg):
        ours = derive_cut_capacities(partition(NETS[name]("torch"),
                                               hosts=hosts), ExecConfig(**cfg))
        theirs = jcl.derive_cut_capacities(
            jcl.partition(NETS[name]("jax"), hosts=hosts),
            jcl.ExecConfig(**cfg))
        assert ours == theirs

    def test_fan_immediately_at_cut_boundary(self):
        net = _farm(n=12, workers=4, explicit=True)
        assignment = {n: (0 if n == "emit" else 1) for n in net.procs}
        plan = partition(net, assignment=assignment)
        (c,) = plan.cut
        assert net.procs[c.dst].kind is Kind.SPREADER
        depth, lanes = stream.plan_depth_lanes(plan.subnetwork(1), None,
                                               None)
        assert lanes == 4
        caps = derive_cut_capacities(plan, ExecConfig())
        assert caps[(c.src, c.dst)] == max(2, depth, lanes) >= 4
        out = run_cluster(net, instances=12, plan=plan, microbatch_size=4,
                          device=CPU)
        assert torch.equal(out["collect"], _seq(net, 12)["collect"])

    def test_single_process_partitions(self):
        net = _pipeline()
        order = net.toposort()
        plan = partition(net, assignment={n: i for i, n in enumerate(order)})
        assert len(plan.cut) == len(order) - 1
        caps = derive_cut_capacities(plan, ExecConfig())
        assert all(v >= 2 for v in caps.values())
        out = run_cluster(net, instances=7, plan=plan, microbatch_size=3,
                          device=CPU)
        assert torch.equal(out["collect"], _seq(net, 7)["collect"])

    def test_reports_and_netlog_carry_capacities(self):
        net = _farm()
        plan = partition(net, hosts=2)
        t = InProcess()
        out = run_cluster(net, instances=10, plan=plan, transport=t,
                          microbatch_size=5, device=CPU)
        merged = {}
        for r in out.reports:
            merged.update(r.capacities)
        (c,) = plan.cut
        key = f"{c.src}->{c.dst}"
        assert key in merged and merged[key] >= 2
        assert f"capacity={merged[key]}" in netlog.cluster_report(
            plan, out.reports)
        caps = derive_cut_capacities(plan, ExecConfig(microbatch_size=5))
        assert t._queues[(c.src, c.dst)].maxsize == caps[(c.src, c.dst)]

    @pytest.mark.parametrize("args", [(1, 1, 4096, 64, 4), (6, 3, 4096, 64,
                                                             4),
                                      (8, 1, 64, 256, 4), (3, 9, 10, 100, 2),
                                      (2, 2, 1, 1 << 20, 2)])
    def test_coalesced_capacity_equals_jax(self, args):
        depth, lanes, rb, cb, floor = args
        assert stream.coalesced_capacity(depth, lanes, rb, cb, floor) == \
            jstream.coalesced_capacity(depth, lanes, rb, cb, floor)

    @pytest.mark.parametrize("record_bytes", [1 << 20, 8])
    def test_derived_capacities_under_coalescing_equal_jax(self,
                                                           record_bytes):
        class Profile:
            def out_bytes_of(self, name):
                return record_bytes

        kw = dict(max_in_flight=4, lanes=1, coalesce_bytes=1 << 10)
        ours = derive_cut_capacities(partition(_farm(), hosts=2),
                                     ExecConfig(profile=Profile(), **kw))
        theirs = jcl.derive_cut_capacities(
            jcl.partition(_farm("jax"), hosts=2),
            jcl.ExecConfig(profile=Profile(), **kw))
        assert ours == theirs


# ==========================================================================
# warm deployments
# ==========================================================================

class TestClusterDeployment:
    @pytest.mark.parametrize("transport", TRANSPORTS)
    def test_three_batches_bit_identical(self, transport):
        net = _farm()
        with ClusterDeployment(net, hosts=2, microbatch_size=2,
                               transport=transport, device=CPU) as dep:
            for n in (4, 6, 10):
                out = dep.run(instances=n)
                assert torch.equal(out["collect"], _seq(net, n)["collect"])
                assert all(r.ok for r in out.reports)

    def test_stage_builds_happen_once(self):
        """The first batch builds every stage callable; warm batches (any
        chunk shape: PyTorch runs eagerly) build nothing."""
        net = _farm()
        with ClusterDeployment(net, hosts=2, microbatch_size=2,
                               device=CPU) as dep:
            out1 = dep.run(instances=4)
            assert sum(r.jit_builds for r in out1.reports) > 0
            built = {h: ex.jit_builds for h, ex in dep.executors.items()}
            for n in (4, 6, 5):
                out = dep.run(instances=n)
                assert sum(r.jit_builds for r in out.reports) == 0
            assert {h: ex.jit_builds
                    for h, ex in dep.executors.items()} == built

    def test_explicit_batch_pytree(self):
        net = _farm()
        vals = torch.arange(8, dtype=torch.float32) + 100.0
        with ClusterDeployment(net, hosts=2, microbatch_size=2,
                               device=CPU) as dep:
            out = dep.run(batch=vals)
            assert float(out["collect"]) == float(torch.sum(vals * vals))
            assert torch.equal(dep.run(instances=6)["collect"],
                               _seq(net, 6)["collect"])

    def test_closed_deployment_refuses(self):
        dep = ClusterDeployment(_farm(), hosts=2, microbatch_size=2,
                                device=CPU)
        dep.close()
        with pytest.raises(NetworkError, match="closed"):
            dep.run(instances=4)

    def test_process_transport_requires_factory(self):
        """Refused before the transport allocates anything."""
        t = make_transport("pipe")
        assert isinstance(t, MultiProcessPipe)
        with pytest.raises(NetworkError, match="factory"):
            with ClusterDeployment(_farm(), hosts=2, transport=t,
                                   device=CPU) as dep:
                dep.run(instances=4)
        assert not t._queues
        with pytest.raises(NetworkError, match="factory"):
            run_cluster(_farm(), instances=4, hosts=2, transport="pipe",
                        microbatch_size=2, device=CPU)

    def test_stop_host_retires_its_worker(self):
        with ClusterDeployment(_farm(), hosts=2, microbatch_size=2,
                               device=CPU) as dep:
            dep.run(instances=4)
            th = dep.controller._threads[1]
            dep.controller.stop_host(1)
            assert not th.is_alive() and 1 not in dep.executors
            assert 1 not in dep.controller._threads

    def test_trace_and_metrics(self):
        net = _pipeline()
        with ClusterDeployment(net, hosts=2, microbatch_size=2, trace=True,
                               device=CPU) as dep:
            dep.run(instances=7)
            events = dep.merged_trace()
            assert {e.host for e in events} >= {0, 1, "ctrl"}
            assert any(e.name == "send" for e in events)
            assert any(e.name == "recv" for e in events)
            snap = dep.metrics()
            (c,) = dep.plan.cut
            assert snap.bytes_per_s[f"{c.src}->{c.dst}"] > 0
            assert set(snap.throughput) == {0, 1}
            assert '"traceEvents"' in dep.export_trace()


class TestFailureCapture:
    def test_worker_failure_surfaces_cross_host(self):
        def boom(x):
            raise RuntimeError("worker exploded")

        net = DataParallelCollect(create=_items("torch"), function=boom,
                                  collector=_add, init=torch.tensor(0.0),
                                  workers=2, jit_combine=True)
        with pytest.raises(ClusterError) as ei:
            run_cluster(net, instances=4, hosts=2, microbatch_size=2,
                        timeout_s=60, device=CPU)
        err = ei.value
        assert "worker exploded" in str(err) and "FAILED" in str(err)
        failed = [r for r in err.reports if not r.ok]
        assert any("worker exploded" in (r.error or "") for r in failed)
        # the consumer host survived its producer's failure: stalled, with
        # its fold state at the first chunk it never received
        (survivor,) = [r for r in err.reports if r.stalled]
        assert survivor.resume_ci == 0 and "STALLED" in str(err)

    def test_cluster_report_renders_ok_hosts(self):
        net = _farm()
        plan = partition(net, hosts=2)
        out = run_cluster(net, instances=10, plan=plan, microbatch_size=5,
                          device=CPU)
        rep = netlog.cluster_report(plan, out.reports)
        assert "host 0 [ok]" in rep and "host 1 [ok]" in rep
        assert "channel" in rep

    def test_failed_deployment_refuses_the_next_batch(self):
        """After a failed batch the deployment is not poisoned: the next
        run first recovers it (no replay of the failed batch: an epoch
        bump, the failed stream's leftovers discarded) and then computes,
        instead of refusing."""
        def tripwire(acc, x):
            if float(x) >= 16.0:
                raise RuntimeError("collector tripped")
            return {**acc, len(acc): float(x)}

        net = DataParallelCollect(create=_items("torch"), function=_sq,
                                  collector=tripwire, init={}, workers=2,
                                  jit_combine=False)
        with ClusterDeployment(net, hosts=2, microbatch_size=2, timeout_s=60,
                               device=CPU) as dep:
            assert dep.run(instances=4)["collect"] == \
                {i: float(i * i) for i in range(4)}
            with pytest.raises(ClusterError, match="collector tripped"):
                dep.run(instances=8)
            assert dep.run(instances=4)["collect"] == \
                {i: float(i * i) for i in range(4)}
            (ev,) = dep.events
            assert dep.epoch == 2 and ev.erred == [1] and not ev.replay_from


# ==========================================================================
# packing for the pipe (no spawning here)
# ==========================================================================

class TestPacking:
    def test_pack_raw_preserves_dtype_endianness_and_0d(self):
        """Raw header+buffer records round-trip numpy dtypes (byte order
        included), 0-d leaves, bools, non-contiguous views and empties —
        and tensors of every dtype, bf16 and f16 included, bit for bit."""
        g = torch.Generator().manual_seed(0)
        tree = {
            "big": np.arange(6, dtype=">f4").reshape(2, 3),
            "little": np.arange(6, dtype="<i2"),
            "zerod": np.float64(3.25),
            "bool": np.asarray([True, False, True]),
            "noncontig": np.arange(12.0).reshape(3, 4).T,
            "empty": np.zeros((0, 4), np.int32),
            "t_f32": torch.randn(3, 5, generator=g),
            "t_bf16": torch.randn(4, 6, generator=g).to(torch.bfloat16),
            "t_f16": torch.randn(7, generator=g).to(torch.float16),
            "t_0d": torch.tensor(5, dtype=torch.int32),
            "t_bool": torch.tensor([True, False]),
            "t_u8": torch.arange(5, dtype=torch.uint8),
            "t_noncontig": torch.arange(12.0).reshape(3, 4).t(),
            "t_empty": torch.zeros(0, 3, dtype=torch.bfloat16),
        }
        packed = tr.pack_raw(tree)
        assert all(isinstance(l, tr._RawLeaf)
                   for l in torch.utils._pytree.tree_leaves(packed))
        dec = tr.unpack_raw(packed)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                assert isinstance(dec[k], torch.Tensor), k
                assert dec[k].dtype == v.dtype and dec[k].shape == v.shape, k
                assert torch.equal(dec[k], v), k
            else:
                a = np.asarray(v)
                assert dec[k].dtype == a.dtype and dec[k].shape == a.shape, k
                assert dec[k].tobytes() == \
                    np.ascontiguousarray(a).tobytes(), k

    def test_bf16_bits_survive(self):
        """Every bf16 bit pattern crosses unchanged (numpy has no bf16)."""
        bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
        t = bits.view(torch.bfloat16)
        out = tr.unpack_raw(tr.pack_raw(t))
        assert torch.equal(out.view(torch.int16), bits)

    def test_unpacked_leaves_are_writable(self):
        out = tr.unpack_raw(tr.pack_raw({"x": np.arange(4.0),
                                         "t": torch.arange(4.0)}))
        out["x"] *= 2.0
        out["t"] *= 2.0
        np.testing.assert_array_equal(out["x"], [0.0, 2.0, 4.0, 6.0])
        assert out["t"].tolist() == [0.0, 2.0, 4.0, 6.0]

    def test_markers_and_exotic_dtypes_pass_through(self):
        assert tr.pack_raw(tr.SKIP) == tr.SKIP
        assert tr.unpack_raw(tr.EOS) == tr.EOS
        structured = np.zeros(2, dtype=[("a", "<f4"), ("b", "<i8")])
        packed = tr.pack_raw(structured)
        assert isinstance(packed, np.ndarray)
        np.testing.assert_array_equal(tr.unpack_raw(packed), structured)

    def test_pipe_endpoint_roundtrip_onto_its_device(self):
        ep = tr._PipeEndpoint({})
        ep.device = torch.device("cpu")
        tree = {"x": np.arange(4, dtype=">u2"), "y": torch.tensor(7.0),
                "z": torch.ones(2, 3, dtype=torch.bfloat16)}
        out = ep._unpack(ep._pack(tree))
        assert out["x"].dtype == np.dtype(">u2")
        assert out["y"].shape == () and out["y"].dtype == torch.float32
        assert out["z"].dtype == torch.bfloat16 and torch.equal(out["z"],
                                                                tree["z"])

    def test_results_preserve_0d_and_dtype(self):
        """A process host's results (packed the same way) come back as
        CPU tensors."""
        out = tr.unpack_raw(tr.pack_raw(
            {"collect": torch.tensor(5, dtype=torch.int32),
             "v": torch.tensor([1.0, 2.0], dtype=torch.bfloat16),
             "bands": {0: np.ones((2, 2), np.int32)}}))
        assert out["collect"].shape == () and \
            out["collect"].dtype == torch.int32
        assert out["v"].dtype == torch.bfloat16
        assert np.array_equal(out["bands"][0], np.ones((2, 2), np.int32))


# ==========================================================================
# the device transport (thread hosts whose tensors stay on the card), on the
# CPU here
# ==========================================================================

class TestDeviceTransport:
    def test_farm_bit_identical_over_device_transport(self):
        net = _farm()
        out = run_cluster(net, instances=10, hosts=2, transport="device",
                          microbatch_size=3, device=CPU)
        assert torch.equal(out["collect"], _seq(net, 10)["collect"])
        theirs = jcl.run_cluster(_farm("jax"), instances=10, hosts=2,
                                 transport="jaxmesh", microbatch_size=3)
        assert float(out["collect"]) == float(theirs["collect"])

    def test_hosts_round_robin_over_devices(self, monkeypatch):
        """Host h on cuda:(h % device_count); off the card every host on
        the deployment's device."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert DeviceTransport.device_split(3, torch.device("cuda", 0)) == [
            torch.device("cuda", 0), torch.device("cuda", 1),
            torch.device("cuda", 0)]
        assert DeviceTransport.device_split(
            2, torch.device("cpu")) == [torch.device("cpu")] * 2

    def test_send_places_on_the_consumer_device(self):
        t = DeviceTransport()
        t.setup([("a", "b")], {})
        t.bind({("a", "b"): torch.device("meta")})
        t.endpoint(0).send(("a", "b"), 0, {"x": torch.ones(2)})
        got = t.endpoint(1).recv(("a", "b"), 0)
        assert got["x"].device.type == "meta"

    def test_hosts_get_their_devices(self):
        with ClusterDeployment(_pipeline(), hosts=2, transport="device",
                               microbatch_size=2, device=CPU) as dep:
            dep.run(instances=4)
            assert {h: ex.cn.device.type
                    for h, ex in dep.executors.items()} == {0: "cpu",
                                                            1: "cpu"}


# ==========================================================================
# the shared-memory ring, in one process (spawned hosts: the _procs file)
# ==========================================================================

CHAN = ("a", "b")


def _ring(slot_bytes=1 << 12, cap=2, **kw):
    t = make_transport("shm", slot_bytes=slot_bytes, **kw)
    t.setup([CHAN], {CHAN: cap})
    return t


class TestSharedMemoryRing:
    """Payload leaves cross as raw writes into preallocated slots."""

    def test_make_transport_builds_the_ring(self):
        t = make_transport("shm", slot_bytes=1 << 10, double_buffer=True)
        assert isinstance(t, SharedMemoryRing) and t.process_hosts
        assert t.slot_bytes == 1 << 10 and t.double_buffer
        t.close()

    def test_send_recv_in_process(self):
        t = _ring()
        try:
            val = {"x": torch.arange(8, dtype=torch.float64),
                   "h": torch.tensor(7.5, dtype=torch.bfloat16),
                   "n": np.arange(3, dtype=">i2"), "s": 5}
            for ci in range(4):  # more chunks than slots: slots recycle
                t.send(CHAN, ci, val)
                out = t.recv(CHAN, ci)
                assert torch.equal(out["x"], val["x"])
                assert out["h"].shape == () and out["h"].dtype == \
                    torch.bfloat16 and float(out["h"]) == 7.5
                assert out["n"].dtype == np.dtype(">i2")
                np.testing.assert_array_equal(out["n"], val["n"])
                assert out["s"] == 5
            assert t.ring_counts() == {CHAN: (4, 0)}
            assert t._rings[CHAN].free_q.qsize() == 2
        finally:
            t.close()

    def test_received_leaves_are_writable_and_do_not_alias_the_slot(self):
        t = _ring()
        try:
            src = torch.arange(6, dtype=torch.float32).reshape(2, 3)
            t.send(CHAN, 0, src.t())  # a strided view: written as values
            got = t.recv(CHAN, 0)
            assert torch.equal(got, src.t()) and got.is_contiguous()
            got += 1  # writable
            t.send(CHAN, 1, torch.zeros(3, 2))  # reuses a slot ...
            t.recv(CHAN, 1)
            assert torch.equal(got, src.t() + 1)  # ... which got not alias
        finally:
            t.close()

    def test_oversize_chunk_ships_inline_and_is_counted(self):
        t = _ring(slot_bytes=128)
        try:
            big = torch.arange(1024, dtype=torch.float64)
            t.send(CHAN, 0, big)
            assert torch.equal(t.recv(CHAN, 0), big)
            t.send(CHAN, 1, torch.ones(4))
            t.recv(CHAN, 1)
            assert t.ring_counts() == {CHAN: (1, 1)}
            assert t._rings[CHAN].free_q.qsize() == 2
        finally:
            t.close()

    def test_ring_capacity_is_slot_count(self):
        for double, slots in ((False, 3), (True, 6)):
            t = _ring(cap=3, double_buffer=double)
            try:
                ring = t._rings[CHAN]
                assert len(ring.slot_names) == slots
                assert ring.data_q._maxsize == 3
                assert t.channel_capacities() == {CHAN: 3}
            finally:
                t.close()

    def test_out_of_order_detected_and_slot_recycled(self):
        t = _ring()
        try:
            t.send(CHAN, 5, torch.arange(3.0))
            with pytest.raises(tr.TransportError, match="out of order"):
                t.recv(CHAN, 0)
            assert t._rings[CHAN].free_q.qsize() == 2
        finally:
            t.close()

    def test_drain_recycles_slots(self):
        t = _ring(cap=3)
        try:
            for ci in range(3):
                t.send(CHAN, ci, torch.arange(4.0))
            assert t.drain()[CHAN][1] == 3  # no keep: all discarded
            assert t._rings[CHAN].free_q.qsize() == 3
        finally:
            t.close()

    def test_close_and_atexit_unlink_owned_segments(self):
        from multiprocessing import shared_memory
        t = _ring()
        assert t._atexit_armed
        names = t.owned_names()
        assert len(names) == 2
        t._unlink_owned()  # what atexit would run
        for name in names:
            with pytest.raises(FileNotFoundError):
                shared_memory.SharedMemory(name=name)
        t.close()  # idempotent after the atexit path
        assert not t._atexit_armed and not t.owned_names()

    def test_coalesce_budget_clamps_to_slot_bytes(self):
        t = make_transport("shm", slot_bytes=1 << 12)
        try:
            with pytest.warns(RuntimeWarning, match="clamping"):
                t.coalesce_bytes = 1 << 13
            assert t.coalesce_bytes == 1 << 12
        finally:
            t.close()

    def test_ring_counts_reach_the_report(self):
        """The sender's chunks by path land in its host report's metrics
        and on the channel's line of the cluster report."""
        net = _pipeline()
        plan = partition(net, hosts=2)
        (c,) = plan.cut
        key = f"{c.src}->{c.dst}"
        t = make_transport("shm", slot_bytes=16)  # 2 f32 fit, 5 do not
        t.recv_timeout_s = 5.0
        t.setup([(c.src, c.dst)], {(c.src, c.dst): 4})
        try:
            ex = PartitionExecutor(build(plan.subnetwork(0), device=CPU),
                                   plan=plan, host=0, endpoint=t,
                                   microbatch_size=2)
            from repro_torch.core.builder import make_emit_batch
            ex.run_partition(stream.microbatch_plan(7, 2),
                             make_emit_batch(net, 7, device=CPU))
            sample = ex.metrics_sample(1.0)
            assert sample["ring"] == {key: (4, 0)}  # 7 items in chunks of 2
            assert t.drain()[(c.src, c.dst)][1] == 4
            ex.run_partition(stream.microbatch_plan(7, 5),
                             make_emit_batch(net, 7, device=CPU))
            assert ex.metrics_sample(1.0)["ring"] == {key: (1, 1)}  # 5, 2
            from repro_torch.cluster import HostReport
            rep = netlog.cluster_report(plan, [HostReport(
                host=0, procs=plan.procs_of(0), ok=True,
                metrics=ex.metrics_sample(1.0))])
            assert "ring slot=1 inline=1" in rep
        finally:
            t.close()


# ==========================================================================
# elastic recovery over thread hosts, against the JAX package
# ==========================================================================

def _trip_once_farm(lib, trip_at: int, state: dict):
    """Farm whose host-side collector raises exactly once, on its
    ``trip_at``-th call ever (a transient host failure)."""
    def coll(acc, x):
        state["n"] = state.get("n", 0) + 1
        if state["n"] == trip_at:
            raise RuntimeError("transient collector failure")
        return {**acc, len(acc): float(x)}

    return _core(lib).DataParallelCollect(
        create=_items(lib), function=_sq, collector=coll, init={},
        workers=2, jit_combine=False)


EXPECT8 = {i: float(i * i) for i in range(8)}
EVENT_FIELDS = ("epoch_from", "epoch_to", "mode", "dead", "erred", "stalled",
                "restarted", "moved", "requeued", "discarded", "replay_from",
                "refined", "bricked", "auto_mode")


def _failed_then(lib, mode, **dep_kw):
    """Batch 1 ok, batch 2 fails in host 1's collector, then ``mode``:
    returns (replayed result, the deployment's events, its plan and a warm
    batch after) from the package ``lib``."""
    state: dict = {}
    net = _trip_once_farm(lib, 12, state)
    if lib == "jax":
        dep = jcl.ClusterDeployment(net, hosts=2, microbatch_size=2,
                                    timeout_s=60, **dep_kw)
    else:
        dep = ClusterDeployment(net, hosts=2, microbatch_size=2,
                                timeout_s=60, device=CPU, **dep_kw)
    Error = jcl.ClusterError if lib == "jax" else ClusterError
    with dep:
        assert dep.run(instances=8)["collect"] == EXPECT8
        with pytest.raises(Error, match="transient collector failure"):
            dep.run(instances=8)
        rec = dep.recover(mode=mode)
        after = dep.run(instances=8)["collect"]
        return rec, list(dep.events), dict(dep.plan.assignment), after, dep


class TestElasticRecovery:
    """A live deployment is a control plane: failures are drained,
    repaired (restart or rebalance), epoch-stamped, re-proved, and the
    failed batch's lost chunks replayed, without a fresh start()."""

    @pytest.mark.parametrize("mode", ["restart", "rebalance"])
    def test_recovery_event_and_plan_equal_jax(self, mode):
        rec, events, plan, after, dep = _failed_then("torch", mode)
        jrec, jevents, jplan, jafter, _ = _failed_then("jax", mode)
        assert rec["collect"] == EXPECT8 == jrec["collect"]
        assert after == jafter == EXPECT8
        assert all(r.ok for r in rec.reports) and rec.epoch == 2
        (ev,), (jev,) = events, jevents
        for f in EVENT_FIELDS:
            assert getattr(ev, f) == getattr(jev, f), f
        assert plan == jplan
        assert ev.erred == [1] and ev.refined is True
        if mode == "rebalance":
            assert dep.plan.hosts() == [0] and ev.moved
            assert all(dst == 0 for _, dst in ev.moved.values())
        else:
            assert dep.plan.hosts() == [0, 1] and not ev.moved

    def test_recover_keeps_survivors_warm_and_reports(self):
        rec, events, _, _, dep = _failed_then("torch", "restart")
        assert sum(r.jit_builds for r in rec.reports) == 0
        rep = netlog.cluster_report(dep.plan, rec.reports, events=events)
        assert "plan epoch 2" in rep and "-- recovery --" in rep
        assert "epoch 1 -> 2 (restart)" in rep
        assert "refinement(epoch 2)=True" in rep

    def test_stalled_survivor_resumes_partial_fold(self):
        """A consumer whose producer dies mid-stream stalls with its fold
        intact: resuming replays ONLY the lost chunks, and the result
        matches the uninterrupted oracle."""
        from repro_torch.core.builder import make_emit_batch
        net = _farm()
        plan = partition(net, hosts=2)
        (c,) = plan.cut
        chan = (c.src, c.dst)
        t = InProcess()
        t.setup([chan], {chan: 8})

        def ex_of(h):
            return PartitionExecutor(build(plan.subnetwork(h), device=CPU),
                                     plan=plan, host=h, endpoint=t,
                                     microbatch_size=2)

        consumer = ex_of(plan.assignment[c.dst])
        producer = ex_of(plan.assignment[c.src])
        bounds = [(0, 2), (2, 4), (4, 6), (6, 8)]
        batch = make_emit_batch(net, 8, device=CPU)
        producer.run_partition(bounds[:2], batch)  # chunks 0..1, then dies
        t.send(chan, -1, tr.EOS)
        with pytest.raises(NetworkError):
            consumer.run_partition(bounds)
        assert consumer.replay_state.next_ci == 2
        t.set_epoch(2)
        producer.reset_run_state()
        producer.run_partition(bounds, batch, start_ci=2)
        out = consumer.resume_partition()
        assert torch.equal(out["collect"], _seq(net, 8)["collect"])
        assert consumer.stats.replays == 1 and consumer.stats.resumed_at == 2
        with pytest.raises(NetworkError, match="no interrupted run"):
            consumer.resume_plan()

    def test_plain_run_after_failure_discards_undelivered_chunks(self):
        """A run() after a failure recovers without replay and DISCARDS
        the failed stream's undelivered chunks (a fresh consumer expects
        chunk 0)."""
        state: dict = {}
        with ClusterDeployment(_trip_once_farm("torch", 12, state), hosts=2,
                               microbatch_size=2, timeout_s=60,
                               device=CPU) as dep:
            assert dep.run(instances=8)["collect"] == EXPECT8
            with pytest.raises(ClusterError):
                dep.run(instances=8)
            ctrl = dep.controller
            (c,) = dep.plan.cut
            ctrl._kept = {(c.src, c.dst): [(2, tr.SKIP), (3, tr.SKIP)]}
            ctrl._stalled = {dep.plan.assignment[c.dst]: 2}
            assert dep.run(instances=8)["collect"] == EXPECT8
            assert dep.events[-1].requeued == {}
            assert dep.events[-1].discarded >= 2

    def test_kill_host_refused_for_thread_hosts(self):
        with ClusterDeployment(_farm(), hosts=2, microbatch_size=2,
                               device=CPU) as dep:
            dep.run(instances=8)
            with pytest.raises(NetworkError, match="process transports"):
                dep.kill_host(0)

    def test_recover_without_failure_refused(self):
        with ClusterDeployment(_farm(), hosts=2, microbatch_size=2,
                               device=CPU) as dep:
            dep.run(instances=8)
            with pytest.raises(NetworkError, match="nothing to recover"):
                dep.recover()
            with pytest.raises(NetworkError, match="unknown mode"):
                dep.recover(mode="reboot")

    def test_restart_host_keeps_serving(self):
        with ClusterDeployment(_farm(), hosts=2, microbatch_size=2,
                               device=CPU) as dep:
            dep.run(instances=4)
            old = dep.executors[1]
            dep.restart_host(1)
            assert torch.equal(dep.run(instances=6)["collect"],
                               _seq(_farm(), 6)["collect"])
            assert dep.executors[1] is not old

    @pytest.mark.parametrize("hosts", [1, 3])
    def test_reconfigure_equals_jax(self, hosts):
        """Scale in and out between batches: the same moves, epoch and
        re-proof as the JAX package, and the next batch still exact."""
        net, jnet = _pipeline(), _pipeline("jax")
        with ClusterDeployment(net, hosts=2, microbatch_size=2,
                               device=CPU) as dep, \
                jcl.ClusterDeployment(jnet, hosts=2,
                                      microbatch_size=2) as jdep:
            dep.run(instances=7)
            jdep.run(instances=7)
            ev = dep.reconfigure(hosts=hosts)
            jev = jdep.reconfigure(hosts=hosts)
            for f in EVENT_FIELDS:
                assert getattr(ev, f) == getattr(jev, f), f
            assert dict(dep.plan.assignment) == dict(jdep.plan.assignment)
            assert ev.refined is True and dep.epoch == 2
            out = dep.run(instances=7)
            assert torch.equal(out["collect"], _seq(net, 7)["collect"])
            assert float(out["collect"]) == float(
                jdep.run(instances=7)["collect"])
        with pytest.raises(NetworkError, match="exactly one"):
            ClusterDeployment(net, hosts=2, device=CPU).reconfigure()


# ==========================================================================
# what later slices bring
# ==========================================================================

class TestLaterSlices:
    def test_unknown_transport_rejected(self):
        with pytest.raises(NetworkError, match="unknown transport"):
            make_transport("jaxmesh")

    def test_snapshot_config_attaches_a_snapshotter_and_adopt_resumes(
            self, tmp_path):
        """``snapshot_every`` / ``snapshot_dir`` give each host executor a
        fold snapshotter, the deployment writes its meta and snapshots,
        and ``adopt`` resumes it at epoch 2 with the JAX package's
        result."""
        plan = partition(_farm(), hosts=2)
        ex = make_host_executor(plan, 0, InProcess().endpoint(0),
                                ExecConfig(snapshot_every=2,
                                           snapshot_dir=str(tmp_path),
                                           device=CPU))
        assert ex.snapshotter is not None and ex.snapshot_every == 2
        assert make_host_executor(plan, 0, InProcess().endpoint(0),
                                  ExecConfig(device=CPU)).snapshotter is None
        d = str(tmp_path / "dep")
        with ClusterDeployment(_farm(), hosts=2, snapshot_every=1,
                               snapshot_dir=d, microbatch_size=2,
                               device=CPU) as dep:
            out = dep.run(instances=10)
        assert sorted(p.name for p in tmp_path.joinpath("dep").iterdir()) \
            == ["host_0", "host_1", "meta"]
        with ClusterDeployment.adopt(d, factory=(_farm, ())) as dep2:
            assert dep2.epoch == 2 and dep2.events[-1].mode == "adopt"
            again = dep2.run(instances=10)
        assert torch.equal(again["collect"], out["collect"])
        assert float(out["collect"]) == float(
            jcl.run_cluster(_farm("jax"), instances=10, hosts=2,
                            microbatch_size=2)["collect"])


def test_launch_counts_lose_nothing_under_threads():
    """Thread hosts count their kernel launches at once: 8 threads x 2000
    counts with a tiny switch interval lose none (``kernels._launches``)."""
    import sys
    import threading
    from repro_torch.kernels import _launches

    def fn():
        pass

    fn.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_launches.count(fn) for _ in range(2000)])
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert fn.launches == 16000
