"""The port's cluster over spawned OS-process hosts (the ``pipe`` and
``shm`` transports), on the CPU: the paper's genuine host boundary, and a
host killed and recovered.

Each host is a fresh interpreter that rebuilds the network from a
module-level factory, so this file imports no JAX (a child imports it to
unpickle the factory).  Results must equal the port's sequential oracle bit
for bit.  Every deployment has a small ``timeout_s``, so a hung host fails
its test instead of the run.  The JAX package's sequential output, which
the ring's results must equal, is computed inside the test that needs it.
"""

import numpy as np
import pytest
import torch

from repro_torch import workloads
from repro_torch.cluster import ClusterDeployment, ClusterError, partition
from repro_torch.core import (DataParallelCollect, OnePipelineCollect,
                              run_sequential)

CPU = "cpu"
TIMEOUT_S = 60


def farm_factory(n, workers):
    return DataParallelCollect(
        create=lambda i: torch.tensor(float(i)), function=lambda x: x * x,
        collector=lambda a, x: a + x, init=torch.tensor(0.0),
        workers=workers, jit_combine=True)


def exploding_factory(n):
    def boom(x):
        raise RuntimeError("worker exploded in its host process")

    return DataParallelCollect(
        create=lambda i: torch.tensor(float(i)), function=boom,
        collector=lambda a, x: a + x, init=torch.tensor(0.0), workers=2,
        jit_combine=True)


def test_pipe_deployment_reuse_over_real_processes():
    """Three batches through one warm pipe deployment, then an explicit
    batch: each equal to the oracle, the warm ones building nothing."""
    net = farm_factory(10, 3)
    with ClusterDeployment(net, hosts=2, transport="pipe", microbatch_size=2,
                           factory=(farm_factory, (10, 3)), device=CPU,
                           timeout_s=TIMEOUT_S) as dep:
        for n in (4, 10, 10):
            out = dep.run(instances=n)
            assert isinstance(out["collect"], torch.Tensor)
            assert torch.equal(out["collect"],
                               run_sequential(net, n, device=CPU)["collect"])
            assert all(r.ok for r in out.reports)
        assert sum(r.jit_builds for r in out.reports) == 0
        vals = torch.arange(8, dtype=torch.float32) + 100.0
        assert float(dep.run(batch=vals)["collect"]) == \
            float(torch.sum(vals * vals))
        procs = list(dep.controller._procs.values())
    assert procs and not any(p.is_alive() for p in procs)


def test_image_pipeline_over_pipe_cut_between_engines():
    """The pipeline cut between its two engines: the grey images cross the
    process boundary as raw bytes and come back bit-identical."""
    factory = (workloads.image_pipeline_factory, (3, 24, CPU))
    net = factory[0](*factory[1])
    assignment = {n: 0 for n in net.procs}
    assignment["engine2"] = assignment["collector"] = 1
    plan = partition(net, assignment=assignment)
    seq = run_sequential(net, 3, device=CPU)["collector"]
    with ClusterDeployment(net, plan=plan, transport="pipe",
                           microbatch_size=2, factory=factory, device=CPU,
                           timeout_s=TIMEOUT_S) as dep:
        for _ in range(2):
            out = dep.run(instances=3)
            assert len(out["collector"]) == 3
            for a, b in zip(out["collector"], seq):
                assert np.array_equal(a, b)
        (c,) = plan.cut
        sent = out.reports[0].metrics["sent_bytes"][f"{c.src}->{c.dst}"]
        assert sent == 3 * 24 * 24 * 4  # three float32 grey images


def test_failure_in_a_host_process_surfaces():
    with pytest.raises(ClusterError) as ei:
        with ClusterDeployment(hosts=2, transport="pipe", microbatch_size=2,
                               factory=(exploding_factory, (4,)), device=CPU,
                               timeout_s=TIMEOUT_S) as dep:
            dep.run(instances=4)
    assert "worker exploded in its host process" in str(ei.value)
    assert any(not r.ok and not r.stalled for r in ei.value.reports)


# -- the shared-memory ring between spawned hosts ---------------------------

def pipeline_factory(n, seed):
    vals = np.random.default_rng(seed).standard_normal((n, 5)).astype(
        np.float32)
    return OnePipelineCollect(
        create=lambda i: torch.from_numpy(vals[i].copy()),
        stage_ops=[lambda x: x * x, lambda x: x + 1.0],
        collector=lambda a, x: a + [x.numpy()], init=[], jit_combine=False)


def _jax_sequential(kind, n, *args):
    """The JAX package's sequential output of the same seeded network
    (imported here, never at the top: spawned hosts import this module)."""
    import jax.numpy as jnp
    import repro.core as jcore
    if kind == "farm":
        net = jcore.DataParallelCollect(
            create=lambda i: jnp.asarray(float(i)), function=lambda x: x * x,
            collector=lambda a, x: a + x, init=jnp.asarray(0.0),
            workers=args[1], jit_combine=True)
        return np.asarray(jcore.run_sequential(net, n)["collect"])
    vals = np.random.default_rng(args[1]).standard_normal(
        (args[0], 5)).astype(np.float32)
    net = jcore.OnePipelineCollect(
        create=lambda i: jnp.asarray(vals[i]),
        stage_ops=[lambda x: x * x, lambda x: x + 1.0],
        collector=lambda a, x: a + [np.asarray(x)], init=[],
        jit_combine=False)
    return jcore.run_sequential(net, n)["collect"]


def test_shm_farm_and_pipeline_equal_jax_sequential():
    """Over the ring, two warm batches each: the farm and the pipeline
    equal the JAX package's sequential output bit for bit, every chunk
    went through a slot, and no segment outlives the deployment."""
    from repro_torch.cluster import SharedMemoryRing
    from multiprocessing import shared_memory
    for kind, factory, n in (("farm", (farm_factory, (10, 3)), 10),
                             ("pipeline", (pipeline_factory, (7, 3)), 7)):
        want = _jax_sequential(kind, n, *factory[1])
        t = SharedMemoryRing(slot_bytes=1 << 12)
        with ClusterDeployment(hosts=2, transport=t, microbatch_size=3,
                               factory=factory, device=CPU,
                               timeout_s=TIMEOUT_S) as dep:
            for _ in range(2):
                out = dep.run(instances=n)
                got = out["collect"]
                if kind == "farm":
                    assert np.array_equal(got.numpy(), want)
                else:
                    assert len(got) == n and all(
                        np.array_equal(a, b) for a, b in zip(got, want))
                ring = [v for r in out.reports
                        for v in r.metrics.get("ring", {}).values()]
                assert ring and all(inline == 0 for _, inline in ring)
                assert sum(slots for slots, _ in ring) == -(-n // 3)
            names = t.owned_names()
            assert names
        assert not t.owned_names()
        for name in names:
            with pytest.raises(FileNotFoundError):
                shared_memory.SharedMemory(name=name)


def test_image_pipeline_over_shm_cut_between_engines():
    """The grey images cross the process boundary through the slots and
    come back bit-identical to the sequential run; the report names the
    ring's paths."""
    from repro_torch.core import netlog
    factory = (workloads.image_pipeline_factory, (3, 24, CPU))
    net = factory[0](*factory[1])
    assignment = {n: 0 for n in net.procs}
    assignment["engine2"] = assignment["collector"] = 1
    plan = partition(net, assignment=assignment)
    seq = run_sequential(net, 3, device=CPU)["collector"]
    with ClusterDeployment(net, plan=plan, transport="shm",
                           microbatch_size=2, factory=factory, device=CPU,
                           timeout_s=TIMEOUT_S) as dep:
        out = dep.run(instances=3)
        for a, b in zip(out["collector"], seq):
            assert np.array_equal(a, b)
        (c,) = plan.cut
        key = f"{c.src}->{c.dst}"
        assert out.reports[0].metrics["ring"] == {key: (2, 0)}
        assert "ring slot=2 inline=0" in netlog.cluster_report(
            dep.plan, out.reports)


# -- a killed host, recovered ------------------------------------------------

@pytest.mark.parametrize("transport", ["pipe", "shm"])
def test_kill_host_then_recover_restarts_and_replays(transport):
    """SIGKILL the producer host's process between batches: the next batch
    fails (the survivor stalls resumably), recover() respawns the corpse
    against the warm transport, replays the batch equal to the oracle,
    and the deployment is warm again."""
    net = farm_factory(10, 3)
    seq = run_sequential(net, 10, device=CPU)["collect"]
    with ClusterDeployment(net, hosts=2, transport=transport,
                           microbatch_size=2, factory=(farm_factory, (10, 3)),
                           device=CPU, timeout_s=TIMEOUT_S) as dep:
        assert torch.equal(dep.run(instances=10)["collect"], seq)
        victim = dep.plan.assignment["emit"]
        survivor = next(h for h in dep.plan.hosts() if h != victim)
        q_before = dict(dep.controller._result_qs)
        dep.kill_host(victim)
        with pytest.raises(ClusterError) as ei:
            dep.run(instances=10)
        assert any(not r.ok and not r.stalled for r in ei.value.reports)
        rec = dep.recover()
        assert torch.equal(rec["collect"], seq) and dep.epoch == 2
        (ev,) = dep.events
        assert ev.dead == [victim] and ev.restarted == [victim]
        assert ev.refined is True and ev.replay_from[survivor] == 0
        assert {r.host: r for r in rec.reports}[survivor].jit_builds == 0
        assert dep.controller._result_qs[victim] is not q_before[victim]
        assert dep.controller._result_qs[survivor] is q_before[survivor]
        out = dep.run(instances=10)
        assert torch.equal(out["collect"], seq)
        assert sum(r.jit_builds for r in out.reports) == 0
        procs = list(dep.controller._procs.values())
    assert not any(p.is_alive() for p in procs)
