"""The port's streaming microbatch executor, on the CPU.

Streaming must be bit-identical to the logged (stage-by-stage) run — and to
the sequential oracle and the fused run — on a representative set of the
``tests/test_stream.py`` networks: fan-any, fan-list, pipeline, COMBINE and
fused chains; and its ``StreamStats`` must be filled in.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.core.stream import (StreamExecutor, fused_chains,
                                     microbatch_plan, plan_depth_lanes,
                                     slice_microbatch, stack_microbatches)


def _sq(x):
    return x * x


def _inc(x):
    return x + 1.0


def _add(a, x):
    return a + x


def _items(i):
    return torch.tensor(float(i))


def _bits(x) -> bytes:
    return x.numpy().tobytes()


def _all_modes(net, n, mb, **kw):
    """(sequential, fused, logged, streaming) Collect values."""
    cn = tcore.build(net, device="cpu")
    seq = tcore.run_sequential(net, n, device="cpu")["collect"]
    fused = cn.run(instances=n)["collect"]
    logged = cn.run(instances=n, logged=True)["collect"]
    strm = cn.run_streaming(instances=n, microbatch_size=mb, **kw)["collect"]
    return cn, seq, fused, logged, strm


def _combine_net(vals):
    net = tcore.Network("comb")
    net.add(tcore.Emit(lambda i: vals[i], name="emit"),
            tcore.OneSeqCastList(name="cast"))
    for w in range(2):
        net.procs[f"w{w}"] = tcore.Worker(_sq if w == 0 else _inc,
                                          name=f"w{w}", tag=f"f{w}")
        net.connect("cast", f"w{w}")
    net.procs["comb"] = tcore.CombineNto1(lambda a, b: a + b, name="comb")
    net.connect("w0", "comb")
    net.connect("w1", "comb")
    net._tail = "comb"
    return net.add(tcore.Collect(_add, init=torch.tensor(0.0),
                                 jit_combine=True, name="collect"))


def _networks():
    """Representative networks over random float32 items, so any change of
    fold order shows in the bits."""
    vals = torch.from_numpy(
        (np.random.default_rng(7).normal(size=32) * 100.0).astype(np.float32))
    kw = dict(collector=_add, init=torch.tensor(0.0), jit_combine=True)
    create = lambda i: vals[i]  # noqa: E731
    yield "fan_any", tcore.DataParallelCollect(
        create=create, function=_sq, workers=3, **kw)
    yield "fan_any_explicit", tcore.DataParallelCollect(
        create=create, function=_sq, workers=3, explicit=True, **kw)
    yield "fan_list", tcore.GroupOfPipelineCollects(
        create=create, stage_ops=[_sq, _inc], groups=3, explicit=True, **kw)
    yield "pipeline", tcore.OnePipelineCollect(
        create=create, stage_ops=[_sq, _inc, lambda x: x * 3.0], **kw)
    yield "pog", tcore.TaskParallelOfGroupCollects(
        create=create, stage_ops=[_sq, _inc], workers=2, explicit=True, **kw)
    yield "combine", _combine_net(vals)


@pytest.mark.parametrize("mb", [1, 4, 5, 24])
@pytest.mark.parametrize("name,net", list(_networks()),
                         ids=[n for n, _ in _networks()])
def test_streaming_bit_identical_to_logged(name, net, mb):
    # 24 items: the fused run splits a 2- or 3-way fan item by item
    _, seq, fused, logged, strm = _all_modes(net, 24, mb)
    assert _bits(strm) == _bits(logged) == _bits(fused)
    if name == "combine":
        # the oracle folds the branches' items interleaved, the batched
        # modes add across branches first: the same sum, associated
        # differently (as in the JAX package)
        np.testing.assert_allclose(seq.numpy(), strm.numpy(), rtol=1e-6)
    else:
        assert _bits(strm) == _bits(seq)


@pytest.mark.parametrize("fuse", [True, False])
def test_fused_chains_bit_identical(fuse):
    net = tcore.OnePipelineCollect(
        create=_items, stage_ops=[_sq, _inc, lambda x: x * 3.0],
        collector=_add, init=torch.tensor(0.0), jit_combine=True)
    cn, seq, fused, logged, strm = _all_modes(net, 7, 3, fuse=fuse)
    assert float(strm) == float(seq) == float(fused) == float(logged)
    st = cn.stream_stats
    if fuse:
        assert st.fused == [("stage0", "stage1", "stage2")]
        assert set(st.donation) == {"stage0+stage1+stage2"}
        assert "fused_chains=1" in st.summary()
    else:
        assert st.fused == []
        assert set(st.donation) == {"stage0", "stage1", "stage2"}


def test_stream_stats_filled_in():
    net = tcore.DataParallelCollect(create=_items, function=_sq,
                                    collector=_add, init=torch.tensor(0.0),
                                    workers=3, jit_combine=True,
                                    explicit=True)
    cn = tcore.build(net, device="cpu")
    cn.run_streaming(instances=9, microbatch_size=2)
    st = cn.stream_stats
    assert (st.n_items, st.microbatch_size, st.n_chunks) == (9, 2, 5)
    assert (st.chunks_done, st.items_done) == (5, 9)
    assert st.depth == 2 and st.lanes == 3
    assert len(st.schedule) == 5  # one lane assignment per chunk
    assert {lane for _, lane in st.schedule} <= {0, 1, 2}
    assert st.stalls == 3  # depth 2: every chunk after the second waits
    assert not st.donation_enabled
    assert "disabled" in st.donation_summary()
    assert "stream: 5 chunks" in st.summary()


def test_host_side_collector_and_finalise():
    net = tcore.DataParallelCollect(
        create=_items, function=_sq,
        collector=lambda acc, x: {**acc, len(acc): float(x)},
        init={}, workers=2)
    out = tcore.build(net, device="cpu").run_streaming(
        instances=5, microbatch_size=2)
    assert out["collect"] == {i: float(i * i) for i in range(5)}
    net = tcore.DataParallelCollect(create=_items, function=_sq,
                                    collector=_add, init=torch.tensor(0.0),
                                    finalise=lambda acc: acc * 10.0,
                                    workers=2, jit_combine=True)
    got = tcore.build(net, device="cpu").run_streaming(
        instances=6, microbatch_size=4)["collect"]
    assert float(got) == 10.0 * sum(i * i for i in range(6))


def test_dict_pytree_items():
    net = tcore.DataParallelCollect(
        create=lambda i: {"a": torch.tensor(float(i)),
                          "emit": torch.tensor(float(2 * i))},
        function=lambda d: {"a": d["a"] * d["emit"], "emit": d["emit"]},
        collector=lambda acc, d: acc + d["a"],
        init=torch.tensor(0.0), workers=2, jit_combine=True)
    cn = tcore.build(net, device="cpu")
    seq = tcore.run_sequential(net, 6, device="cpu")["collect"]
    strm = cn.run_streaming(instances=6, microbatch_size=4)["collect"]
    assert float(seq) == float(strm) == sum(2.0 * i * i for i in range(6))


def test_heterogeneous_fan_ragged_chunks_fail_fast():
    net = tcore.Network("hetero")
    net.add(tcore.Emit(_items, name="emit"), tcore.OneFanList(name="ofl"))
    for w, fn in enumerate([_sq, _inc, lambda x: x * 3.0]):
        net.procs[f"w{w}"] = tcore.Worker(fn, name=f"w{w}", tag=f"f{w}")
        net.connect("ofl", f"w{w}")
    net.procs["lso"] = tcore.ListSeqOne(name="lso")
    for w in range(3):
        net.connect(f"w{w}", "lso")
    net._tail = "lso"
    net.add(tcore.Collect(_add, init=torch.tensor(0.0), jit_combine=True,
                          name="collect"))
    cn = tcore.build(net, device="cpu")
    with pytest.raises(tcore.NetworkError, match="microbatch_size=5"):
        cn.run_streaming(instances=12, microbatch_size=5)
    seq = tcore.run_sequential(net, 12, device="cpu")["collect"]
    strm = cn.run_streaming(instances=12, microbatch_size=6)["collect"]
    assert float(seq) == float(strm)


def test_backpressure_depth_from_channel_capacity():
    net = tcore.Network("capped")
    net.add(tcore.Emit(_items, name="emit"), tcore.Worker(_sq, name="w"))
    net.procs["collect"] = tcore.Collect(_add, init=torch.tensor(0.0),
                                         jit_combine=True, name="collect")
    net.connect("w", "collect", capacity=1)
    cn = tcore.build(net, device="cpu")
    strm = cn.run_streaming(instances=8, microbatch_size=2)["collect"]
    assert float(strm) == sum(i * i for i in range(8))
    assert cn.stream_stats.depth == 1
    assert cn.stream_stats.stalls == 3  # 4 chunks through a depth-1 pipe


def test_depth_bounds_unretired_chunks():
    """Backpressure retires BEFORE dispatch: never more than `depth`
    chunks un-retired."""
    net = tcore.OnePipelineCollect(create=_items, stage_ops=[_sq, _inc],
                                   collector=_add, init=torch.tensor(0.0),
                                   jit_combine=True)
    cn = tcore.build(net, device="cpu")
    ex = StreamExecutor(cn, microbatch_size=2, max_in_flight=1)
    seen, retired = [], []
    orig_dispatch, orig_retire = ex._dispatch_chunk, ex._retire

    def spy(ci, chunk, final):
        seen.append(ci)
        return orig_dispatch(ci, chunk, final)

    ex._dispatch_chunk = spy
    ex._retire = lambda e, h: (retired.append(e[0]), orig_retire(e, h))[1]
    ex.run(cn.make_batch(8))
    for ci in seen[1:]:
        assert ci - 1 in retired[:ci]


def test_warm_executor_builds_nothing_new():
    net = tcore.OnePipelineCollect(create=_items, stage_ops=[_sq, _inc],
                                   collector=_add, init=torch.tensor(0.0),
                                   jit_combine=True)
    cn = tcore.build(net, device="cpu")
    a = cn.run_streaming(instances=6, microbatch_size=2)["collect"]
    ex = cn._streams[(2, None, None, True)]
    built = ex.jit_builds
    assert built > 0
    b = cn.run_streaming(instances=6, microbatch_size=2)["collect"]
    assert float(a) == float(b)
    assert ex.jit_builds == built and len(cn._streams) == 1


def test_plans_and_slicing():
    assert microbatch_plan(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert microbatch_plan(0, 4) == []
    with pytest.raises(tcore.NetworkError):
        microbatch_plan(8, 0)
    x = {"a": torch.arange(10.0), "b": torch.arange(20.0).reshape(10, 2)}
    chunks = [slice_microbatch(x, lo, hi) for lo, hi in microbatch_plan(10, 3)]
    assert torch.equal(torch.cat([c["b"] for c in chunks]), x["b"])
    assert stack_microbatches(x["b"], 5).shape == (5, 2, 2)
    with pytest.raises(tcore.NetworkError, match="not divisible"):
        stack_microbatches(x["b"], 3)
    net = tcore.DataParallelCollect(create=_items, function=_sq,
                                    collector=_add, workers=3, explicit=True)
    assert plan_depth_lanes(net, None, None) == (2, 3)
    assert fused_chains(net) == []


def test_slot_plan_admission_trace():
    from repro_torch.core.stream import SlotEvent, SlotPlan
    plan = SlotPlan(2)
    assert plan.claim(7) == 0 and plan.claim(8) == 1
    with pytest.raises(tcore.NetworkError, match="no free slot"):
        plan.claim(9)
    plan.tick()
    assert plan.release(0) == 7 and plan.n_free == 1
    assert torch.equal(plan.mask(), torch.tensor([False, True]))
    assert plan.active() == [(1, 8)]
    assert plan.events == [SlotEvent(0, "join", 0, 7),
                           SlotEvent(0, "join", 1, 8),
                           SlotEvent(1, "leave", 0, 7)]
    with pytest.raises(tcore.NetworkError, match="already free"):
        plan.release(0)
