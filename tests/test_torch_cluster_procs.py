"""The port's cluster over spawned OS-process hosts (the ``pipe``
transport), on the CPU: the paper's genuine host boundary.

Each host is a fresh interpreter that rebuilds the network from a
module-level factory, so this file imports no JAX (a child imports it to
unpickle the factory).  Results must equal the port's sequential oracle bit
for bit.  Every deployment has a small ``timeout_s``, so a hung host fails
its test instead of the run.
"""

import numpy as np
import pytest
import torch

from repro_torch import workloads
from repro_torch.cluster import ClusterDeployment, ClusterError, partition
from repro_torch.core import DataParallelCollect, run_sequential

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
