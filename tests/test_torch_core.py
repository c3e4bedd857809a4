"""The port's process-network core against the JAX package's, on the CPU.

``verify`` must give the same verdicts as the JAX package and ``csp.check``
the same state counts and verdicts, on the network shapes of
``tests/test_core_verify.py``, ``tests/test_csp.py`` and
``tests/test_builder.py``.  Within the port, the sequential oracle, the fused
run and the logged run must agree exactly, and the streaming schedule's CSP
model must be trace-equivalent to the synchronous one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import csp as jcsp
from repro_torch.core import csp as tcsp
from repro_torch.core.stream import (streaming_abstract_model,
                                     synchronous_abstract_model)

def _f(x):
    return x


def _coll(a, x):
    return a


def _verdict(build_net, lib):
    """('ok', checks) or ('refused', message) for one package."""
    try:
        rep = lib.verify(build_net(lib))
    except lib.NetworkError as e:
        return "refused", str(e)
    return "ok", rep.checks


# -- verify ------------------------------------------------------------------

def _farm(lib, workers=4):
    return lib.DataParallelCollect(create=lambda i: i, function=_f,
                                   collector=_coll, workers=workers,
                                   explicit=True)


def _no_emit(lib):
    net = lib.Network("x")
    return net.add(lib.Worker(_f, name="w"), lib.Collect(_coll, name="c"))


def _no_collect(lib):
    return lib.Network("x").add(lib.Emit(lambda i: i, name="e"),
                                lib.Worker(_f, name="w"))


def _cycle(lib):
    net = lib.Network("x").add(lib.Emit(lambda i: i, name="e"),
                               lib.Worker(_f, name="w1"),
                               lib.Worker(_f, name="w2"),
                               lib.Collect(_coll, name="c"))
    net.channels.append(type(net.channels[0])("w2", "w1"))
    return net


def _orphan(lib):
    net = lib.Network("x").add(lib.Emit(lambda i: i, name="e"),
                               lib.Worker(_f, name="w"),
                               lib.Collect(_coll, name="c"))
    net.procs["orphan"] = lib.Worker(_f, name="orphan")
    net.connect("w", "orphan")
    return net


def _shared_producer(lib):
    net = lib.Network("x")
    net.add(lib.Emit(lambda i: i, name="e1"), lib.Worker(_f, name="w"),
            lib.Collect(_coll, name="c"))
    net.procs["e2"] = lib.Emit(lambda i: i, name="e2")
    net.connect("e2", "w")
    return net


def _spec(lib, good: bool):
    if lib is jcore:
        spec = jax.ShapeDtypeStruct((4,), jnp.float32) if good else 3
    else:
        spec = tcore.TensorSpec((4,), torch.float32) if good else 3
    net = lib.Network("x").add(lib.Emit(lambda i: i, name="e"))
    net.procs["w"] = lib.Worker(_f, name="w")
    net.connect("e", "w", {"x": spec})
    net._tail = "w"
    return net.add(lib.Collect(_coll, name="c"))


@pytest.mark.parametrize("build_net", [
    _farm, _no_emit, _no_collect, _cycle, _orphan, _shared_producer,
    lambda lib: _spec(lib, True), lambda lib: _spec(lib, False)],
    ids=["farm", "no_emit", "no_collect", "cycle", "orphan",
         "shared_producer", "spec_ok", "spec_bad"])
def test_verify_verdicts_match_jax(build_net):
    assert _verdict(build_net, tcore) == _verdict(build_net, jcore)


def _pattern(lib, kind, workers, stages):
    ops = [_f] * stages
    if kind == "farm":
        return _farm(lib, workers)
    if kind == "pipe":
        return lib.OnePipelineCollect(create=lambda i: i, stage_ops=ops,
                                      collector=_coll)
    if kind == "gop":
        return lib.GroupOfPipelineCollects(create=lambda i: i, stage_ops=ops,
                                           collector=_coll, groups=workers,
                                           explicit=True)
    return lib.TaskParallelOfGroupCollects(create=lambda i: i, stage_ops=ops,
                                           collector=_coll, workers=workers,
                                           explicit=True)


@pytest.mark.parametrize("kind", ["farm", "pipe", "gop", "pog"])
@pytest.mark.parametrize("workers,stages", [(1, 2), (3, 3), (6, 5)])
def test_pattern_networks_verify_alike(kind, workers, stages):
    t = tcore.verify(_pattern(tcore, kind, workers, stages)).checks
    j = jcore.verify(_pattern(jcore, kind, workers, stages)).checks
    assert t == j


# -- csp ---------------------------------------------------------------------

def _summary(r):
    return (r.n_states, r.deadlock_free, r.divergence_free, r.deterministic,
            r.all_paths_terminate, r.outcomes)


@pytest.mark.parametrize("workers,instances", [(1, 1), (2, 4), (3, 3)])
def test_csp_farm_matches_jax(workers, instances):
    t = tcsp.check(_farm(tcore, workers), instances=instances)
    j = jcsp.check(_farm(jcore, workers), instances=instances)
    assert _summary(t) == _summary(j)
    assert t.deadlock_free and t.deterministic and t.all_paths_terminate


def test_csp_pipeline_and_refinement_match_jax():
    t = tcsp.check(_pattern(tcore, "pipe", 1, 3), instances=3)
    j = jcsp.check(_pattern(jcore, "pipe", 1, 3), instances=3)
    assert _summary(t) == _summary(j)
    (outcome,) = t.outcomes
    assert ("s2", ("s1", ("s0", ("i", 0)))) in outcome[0]
    for lib, mod in ((tcore, tcsp), (jcore, jcsp)):
        gop = _pattern(lib, "gop", 2, 3)
        pog = _pattern(lib, "pog", 2, 3)
        assert mod.trace_equivalent(gop, pog, instances=3)
        assert mod.trace_refines(_farm(lib, 2), _farm(lib, 1), instances=3)
        assert not mod.trace_refines(_farm(lib, 1), _farm(lib, 2),
                                     instances=3)


def test_csp_deadlock_detected_like_jax():
    def ring(lib):
        net = lib.Network("broken")
        net.procs["w1"] = lib.Worker(_f, name="w1")
        net.procs["w2"] = lib.Worker(_f, name="w2")
        net.connect("w1", "w2")
        net.connect("w2", "w1")
        return net

    t = tcsp.check(ring(tcore), instances=2)
    assert not t.deadlock_free
    assert _summary(t) == _summary(jcsp.check(ring(jcore), instances=2))


# -- the oracle: sequential == fused == logged, within the port --------------

def _sq(x):
    return x * x


def _inc(x):
    return x + 1.0


def _add(a, x):
    return a + x


def _items(i):
    return torch.tensor(float(i))


def _nets():
    kw = dict(collector=_add, init=torch.tensor(0.0), jit_combine=True)
    yield "farm", 8, tcore.DataParallelCollect(
        create=_items, function=_sq, workers=3, **kw), sum(
            i * i for i in range(8))
    yield "pipeline", 6, tcore.OnePipelineCollect(
        create=_items, stage_ops=[_sq, _inc], **kw), sum(
            i * i + 1 for i in range(6))
    yield "gop", 12, tcore.GroupOfPipelineCollects(
        create=_items, stage_ops=[_sq, _inc, _inc], groups=3, **kw), sum(
            i * i + 2 for i in range(12))
    yield "pog", 12, tcore.TaskParallelOfGroupCollects(
        create=_items, stage_ops=[_sq, _inc, _inc], workers=3, **kw), sum(
            i * i + 2 for i in range(12))
    yield "explicit_gop", 12, tcore.GroupOfPipelineCollects(
        create=_items, stage_ops=[_sq, _inc], groups=3, explicit=True,
        **kw), sum(i * i + 1 for i in range(12))


@pytest.mark.parametrize("name,n,net,want",
                         list(_nets()), ids=[t[0] for t in _nets()])
def test_sequential_equals_fused_equals_logged(name, n, net, want):
    seq = tcore.run_sequential(net, n, device="cpu")["collect"]
    cn = tcore.build(net, device="cpu")
    fused = cn.run(instances=n)["collect"]
    logged = cn.run(instances=n, logged=True)["collect"]
    assert float(seq) == float(fused) == float(logged) == want
    assert {l.stage for l in cn.logs} >= {"collect"}


def test_host_side_collector_and_emit_with_local():
    net = tcore.DataParallelCollect(
        create=_items, function=_sq,
        collector=lambda acc, x: {**acc, len(acc): float(x)},
        init={}, workers=2)
    out = tcore.build(net, device="cpu").run(instances=5)["collect"]
    assert out == {i: float(i * i) for i in range(5)}

    def create(i, local):  # running sum as local state (sieve-like)
        local = local + i
        return torch.tensor(float(local)), local

    net = tcore.Network("loc")
    net.add(tcore.EmitWithLocal(create, lambda: 0, name="emit"),
            tcore.OneFanAny(name="s"), tcore.Worker(_f, name="w"),
            tcore.AnyFanOne(name="r"),
            tcore.Collect(_add, init=torch.tensor(0.0), jit_combine=True,
                          name="collect"))
    seq = tcore.run_sequential(net, 5, device="cpu")["collect"]
    fused = tcore.build(net, device="cpu").run(instances=5)["collect"]
    assert float(seq) == float(fused) == 20.0


def test_logged_run_reports_and_netlog():
    from repro_torch.core import netlog
    net = tcore.DataParallelCollect(create=_items, function=_sq,
                                    collector=_add, init=torch.tensor(0.0),
                                    workers=2, jit_combine=True)
    cn = tcore.build(net, device="cpu")
    cn.run(instances=8, logged=True)
    assert [l.stage for l in cn.logs] == ["group", "collect"]
    assert all(l.wall_s >= 0 for l in cn.logs)
    rep = netlog.report(cn)
    assert "bottleneck" in rep and "spreader/fan" in rep
    assert "bottleneck" in cn.log_report()


def test_logged_flops_from_the_flop_counter():
    """A matmul stage has its FLOPs counted; an elementwise one records
    None rather than a count of 0."""
    w = torch.ones(4, 4)
    net = tcore.OnePipelineCollect(
        create=lambda i: torch.full((4, 2), float(i)),
        stage_ops=[lambda x: w @ x, _sq], collector=_add,
        init=torch.zeros(4, 2), jit_combine=True)
    cn = tcore.build(net, device="cpu")
    cn.run(instances=3, logged=True)
    flops = {l.stage: l.flops for l in cn.logs}
    assert flops["stage0"] == 3 * 2 * 4 * 4 * 2  # three (4,4)@(4,2)
    assert flops["stage1"] is None


def test_fold_order_is_the_oracle_order():
    """The Collect fold runs left to right in item order: a
    non-associative collector gives the oracle's answer in every mode."""
    net = tcore.OnePipelineCollect(
        create=_items, stage_ops=[_f, _f],
        collector=lambda a, x: a * 0.5 + x, init=torch.tensor(0.0),
        jit_combine=True)
    seq = tcore.run_sequential(net, 7, device="cpu")["collect"]
    cn = tcore.build(net, device="cpu")
    want = 0.0
    for i in range(7):
        want = want * 0.5 + i
    assert float(seq) == float(cn.run(instances=7)["collect"]) == want
    assert float(cn.run_streaming(instances=7, microbatch_size=3)
                 ["collect"]) == want


def test_mesh_refused():
    """A mesh builds only inside a world of its ranks (the SPMD runs are
    ``tests/test_torch_distributed.py``'s); in one process it is refused,
    naming the world it needs."""
    from repro_torch.launch.mesh import make_mesh
    net = _pattern(tcore, "pipe", 1, 2)
    with pytest.raises(RuntimeError, match="needs a world of 2 ranks"):
        tcore.build(net, mesh=make_mesh((2,), ("data",), device="cpu"))


def test_oracle_matches_jax_on_the_builder_farm():
    """Same user methods, both packages: the farm sums agree."""
    n = 8
    t = tcore.run_sequential(
        tcore.DataParallelCollect(create=_items, function=_sq,
                                  collector=_add, init=torch.tensor(0.0),
                                  workers=3, jit_combine=True),
        n, device="cpu")["collect"]
    j = jcore.build(jcore.DataParallelCollect(
        create=lambda i: jnp.asarray(float(i)), function=_sq,
        collector=_add, init=jnp.asarray(0.0), workers=3,
        jit_combine=True)).run(instances=n)["collect"]
    assert float(t) == float(np.asarray(j))


# -- the streaming schedule refines the synchronous one ----------------------

@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_streaming_model_trace_equivalent(lanes, fused):
    net = _pattern(tcore, "pipe", 1, 2)
    strm = streaming_abstract_model(net, lanes=lanes, fused=fused)
    sync = synchronous_abstract_model(net)
    assert tcsp.trace_equivalent(strm, sync, instances=3)
    r = tcsp.check(strm, instances=3)
    assert r.deadlock_free and r.divergence_free and r.deterministic


def test_farm_streaming_model_trace_equivalent():
    net = tcore.DataParallelCollect(create=_items, function=_sq,
                                    collector=_add, workers=3)
    assert tcsp.trace_equivalent(streaming_abstract_model(net, lanes=2),
                                 synchronous_abstract_model(net),
                                 instances=3)
