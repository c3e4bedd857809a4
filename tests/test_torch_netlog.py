"""The port's ``netlog`` renders against the JAX package's golden ones.

``tests/test_netlog_snapshot.py`` on the port: ``netlog.cluster_report``
renders deterministically (hosts sorted, capacities merged in host order,
each event's collections sorted), its recovery and durability sections
match the reference's golden text, the channel telemetry columns and the
timeline's zero-wall case render as the reference's do.  Every case builds
the same plan, host reports and events in both packages and requires the
port's text to equal the JAX package's, as well as the golden snapshot.
"""

import types

import jax.numpy as jnp
import pytest
import torch

import repro.cluster as jcluster
import repro.cluster.control as jcontrol
import repro.cluster.durable as jdurable
import repro.cluster.runtime as jruntime
import repro.core as jcore
import repro.core.builder as jbuilder
import repro_torch.cluster as tcluster
import repro_torch.cluster.control as tcontrol
import repro_torch.cluster.durable as tdurable
import repro_torch.cluster.runtime as truntime
import repro_torch.core as tcore
import repro_torch.core.builder as tbuilder

JAX = types.SimpleNamespace(
    core=jcore, partition=jcluster.partition,
    RecoveryEvent=jcontrol.RecoveryEvent, HostReport=jruntime.HostReport,
    DurabilityEvent=jdurable.DurabilityEvent, StageLog=jbuilder.StageLog,
    scalar=jnp.asarray)
PORT = types.SimpleNamespace(
    core=tcore, partition=tcluster.partition,
    RecoveryEvent=tcontrol.RecoveryEvent, HostReport=truntime.HostReport,
    DurabilityEvent=tdurable.DurabilityEvent, StageLog=tbuilder.StageLog,
    scalar=torch.tensor)

HEAD = [
    "== cluster: pipeline over 2 host(s), plan epoch 2 ==",
    "  channel stage0 -> stage1: host 0 -> 1 (capacity=3)",
    "-- host 0 [ok]: emit, stage0",
    "   stream: 4 chunks",
    "-- host 1 [ok]: stage1, collect",
    "   stream: 4 chunks",
]


def _plan(pkg):
    net = pkg.core.OnePipelineCollect(
        create=lambda i: pkg.scalar(float(i)),
        stage_ops=[lambda x: x * x, lambda x: x + 1.0],
        collector=lambda a, x: a + x, init=pkg.scalar(0.0),
        jit_combine=True)
    return pkg.partition(net, assignment={"emit": 0, "stage0": 0,
                                          "stage1": 1, "collect": 1})


def _reports(pkg, order):
    by_host = {
        0: pkg.HostReport(host=0, procs=["emit", "stage0"], ok=True,
                          stats_summary="stream: 4 chunks", epoch=2,
                          capacities={"stage0->stage1": 3}),
        1: pkg.HostReport(host=1, procs=["stage1", "collect"], ok=True,
                          stats_summary="stream: 4 chunks", epoch=2,
                          capacities={"stage0->stage1": 3}),
    }
    return [by_host[h] for h in order]


def _event(pkg):
    return pkg.RecoveryEvent(
        epoch_from=1, epoch_to=2, mode="restart",
        dead=[1, 0], erred=[], stalled={1: 2, 0: 1},
        restarted=[1, 0], moved={},
        requeued={"stage0->stage1": [2, 3]}, discarded=1,
        replay_from={1: 2, 0: 0}, refined=True, wall_s=0.25,
        bricked=["stage0->stage1"])


def _render(pkg, case):
    """The text one package renders for ``case``."""
    netlog = pkg.core.netlog
    if case == "order-0-1":
        return netlog.cluster_report(_plan(pkg), _reports(pkg, [0, 1]),
                                     events=[_event(pkg)])
    if case == "order-1-0":
        return netlog.cluster_report(_plan(pkg), _reports(pkg, [1, 0]),
                                     events=[_event(pkg)])
    if case == "event-line":
        return _event(pkg).describe()
    if case == "durability":
        dur = [pkg.DurabilityEvent(kind="snapshot", epoch=2, step=3,
                                   hosts={1: 4, 0: 2}),
               pkg.DurabilityEvent(kind="restore", epoch=3, step=3,
                                   hosts={1: 4}, note="batch 5"),
               pkg.DurabilityEvent(kind="adopt", epoch=3, step=7,
                                   note="batch_seq=6")]
        return netlog.cluster_report(_plan(pkg), _reports(pkg, [1, 0]),
                                     durability=dur)
    if case in ("zero-wall", "nonzero-wall"):
        wall = (0.0, 0.0) if case == "zero-wall" else (0.001, 0.002)
        return netlog.timeline([
            pkg.StageLog(stage="emit", kind="terminal", wall_s=wall[0]),
            pkg.StageLog(stage="worker", kind="functional",
                         wall_s=wall[1])])
    reports = _reports(pkg, [0, 1])
    if case == "telemetry":
        reports[0].metrics = {"wall_s": 2.0,
                              "sent_bytes": {"stage0->stage1": 4096}}
        return netlog.cluster_report(_plan(pkg), reports,
                                     depths={"stage0->stage1": 3})
    if case == "unsampled":
        return netlog.cluster_report(_plan(pkg), reports)
    assert case == "negative-depth"  # qsize() unsupported (macOS mp): -1
    return netlog.cluster_report(_plan(pkg), reports,
                                 depths={"stage0->stage1": -1})


def _check(case, text):
    """The reference test's own assertion for ``case``."""
    if case in ("order-0-1", "order-1-0"):
        assert text == "\n".join(HEAD + [
            "-- recovery --",
            "   epoch 1 -> 2 (restart); dead hosts [0, 1]; "
            "stalled host 0 at chunk 1, host 1 at chunk 2; "
            "bricked ingress FIFO stage0->stage1; "
            "restarted [0, 1]; "
            "requeued 2 [stage0->stage1:[2, 3]] / discarded 1 "
            "in-flight chunks; "
            "replayed host 0 from chunk 0, host 1 from chunk 2; "
            "refinement(epoch 2)=True; wall 0.25s"])
    elif case == "event-line":
        assert "dead hosts [0, 1]" in text  # input was [1, 0]
        assert "restarted [0, 1]" in text
        assert "stalled host 0 at chunk 1, host 1 at chunk 2" in text
        assert "replayed host 0 from chunk 0, host 1 from chunk 2" in text
    elif case == "durability":
        assert text == "\n".join(HEAD + [
            "-- durability --",
            "   snapshot (epoch 2, step 3); host 0@chunk 2, host 1@chunk 4",
            "   restore (epoch 3, step 3); host 1@chunk 4; batch 5",
            "   adopt (epoch 3, step 7); batch_seq=6"])
    elif case == "zero-wall":
        assert "(no measurable time)" in text and "█" not in text
        assert "emit" in text and "worker" in text
    elif case == "nonzero-wall":
        assert "█" in text and "(no measurable time)" not in text
        assert "bottleneck: worker" in text
    elif case == "telemetry":
        assert "(capacity=3, 2.0KB/s, depth=3)" in text
    elif case == "unsampled":
        assert "(capacity=3)" in text
    else:
        assert "depth=" not in text


CASES = ["order-0-1", "order-1-0", "event-line", "durability", "zero-wall",
         "nonzero-wall", "telemetry", "unsampled", "negative-depth"]


@pytest.mark.parametrize("case", CASES)
def test_render_matches_jax_and_golden(case):
    ours = _render(PORT, case)
    assert ours == _render(JAX, case)
    _check(case, ours)
