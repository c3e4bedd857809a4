"""The port's clustered decode farm, on the CPU.

The cluster cases of ``tests/test_serve_engine.py`` on the port: the farm's
redeployments refine for 1, 2 and 3 hosts, the farm-parked backend equals
the local one across an epoch-bumped ``scale(3)`` over ``inprocess``,
``device`` and ``pipe``, argument validation, the seeded kill-during-serving
scenarios (against the JAX package's outcome on the same schedule), and
adoption exactly once across a crash.  Beside them: the farm against the
JAX package's ``ClusterDecodeBackend`` on the reduced qwen2-0.5b and
mamba2-2.7b over the same weights, through a scale-out; a farm step leaves
its input item as it found it and a failed-and-replayed step equals an
unfailed one; ``ServeEngine.step`` polls a backend's ``maybe_autoscale``
once per decode step, in both packages; the per-shard caches persist and
come back through ``_state``/``adopt``; and no entry point runs without a
GPU unless it is given the CPU.
"""

import random

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import repro.cluster.sim as jsim
from repro.serve import (ClusterDecodeBackend as JClusterDecodeBackend,
                         Request as JRequest, ServeEngine as JServeEngine,
                         build_decode_model as jbuild_decode_model,
                         make_decode_farm as jmake_decode_farm)
from repro.cluster.partition import partition as jpartition
from repro_torch.cluster import DeploymentStore
from repro_torch.cluster import sim
from repro_torch.cluster.partition import check_redeployment, partition
from repro_torch.core import build
from repro_torch.core.dataflow import NetworkError
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.serve import (ClusterDecodeBackend, LocalDecodeBackend,
                               Request, ServeEngine, build_decode_model,
                               make_decode_farm)
from repro_torch.serve import engine as engine_mod

TOY = ("toy", 32, 8)
CPU = "cpu"


def _toy():
    return build_decode_model(TOY, device=CPU)


def _oracle_tokens(model, params, req, max_len=64):
    """The sequential reference: one request alone in a one-slot engine."""
    eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=1,
                                         max_len=max_len))
    eng.submit(req)
    eng.run_until_drained()
    return eng.poll(req.rid).tokens


def _backend(spec=TOY, **kw):
    kw = {"n_slots": 4, "shards": 2, "hosts": 2, "max_len": 64,
          "device": CPU, **kw}
    return ClusterDecodeBackend(spec, **kw)


# ==========================================================================
# The reference's cluster cases
# ==========================================================================

@pytest.mark.parametrize("a,b", [(1, 2), (2, 3), (3, 2)])
def test_decode_farm_redeployment_refines(a, b):
    """The farm declares its per-branch relay buffering, so every replan
    passes check_redeployment — the proof reconfigure re-runs."""
    net = make_decode_farm(TOY, 4, 2, 32, 4, device=CPU)
    assert check_redeployment(net, partition(net, hosts=a),
                              partition(net, hosts=b)), f"{a}->{b}"


@pytest.mark.parametrize("transport", ["inprocess", "device", "pipe"])
def test_cluster_backend_matches_local_and_scales(transport):
    """The farm-parked backend equals the local one, across an
    epoch-bumped scale-out mid-serving (reconfigure, not restart)."""
    model, params = _toy()
    reqs = [Request(rid=i, prompt=tuple(range(1, 2 + i)), max_new=2 + i % 2)
            for i in range(4)]
    expect = {r.rid: _oracle_tokens(model, params, r) for r in reqs}
    be = _backend(transport=transport)
    try:
        eng = ServeEngine(be)
        for r in reqs[:2]:
            eng.submit(r)
        eng.step()
        ev = be.scale(3)  # grow the decode farm while requests are live
        assert ev.mode == "reconfigure"
        assert ev.refined is True
        assert be.dep.epoch == 2
        for r in reqs[2:]:
            eng.submit(r)
        eng.run_until_drained()
        for r in reqs:
            assert eng.poll(r.rid).tokens == expect[r.rid], f"req {r.rid}"
    finally:
        be.close()


def test_reconfigure_validates_arguments():
    be = _backend(n_slots=2, shards=1, hosts=1, max_len=32)
    try:
        with pytest.raises(NetworkError, match="exactly one"):
            be.dep.reconfigure()
    finally:
        be.close()
    with pytest.raises(NetworkError, match="not divisible"):
        ClusterDecodeBackend(TOY, n_slots=3, shards=2, hosts=1, device=CPU)
    with pytest.raises(NetworkError, match="not divisible"):
        make_decode_farm(TOY, 3, 2, 32, 4, device=CPU)


@pytest.mark.parametrize("seed", [1, 7])
def test_serve_kill_scenario_green(seed):
    """Seeded host kills under a live engine: every accepted request
    answered exactly once, identical to the oracle (seed 7 is the JAX
    package's regression for stale same-epoch leftovers after a completed
    replay), with the JAX package's schedule, kind and fault count."""
    r = sim.run_serve_kill_scenario(seed, device=CPU)
    assert r.ok, r.describe()
    assert r.fired >= 1  # the schedule actually injected its fault
    j = jsim.run_serve_kill_scenario(seed)
    assert j.ok, j.describe()
    assert (r.kind, r.topology, r.hosts, r.schedule, r.fired,
            r.recoveries) == (j.kind, j.topology, j.hosts, j.schedule,
                              j.fired, j.recoveries)


@pytest.mark.parametrize("seed", range(6))
def test_serve_kill_draw_equals_jax(seed):
    """What a seed fixes before the engine runs — host count, requests and
    fault schedule — is the JAX package's draw."""
    def draw(make, part, schedule_cls, device_kw):
        rng = random.Random(seed)
        hosts = rng.choice((2, 3))
        reqs = [(tuple(rng.randrange(1, 32)
                       for _ in range(rng.randrange(1, 7))),
                 rng.randrange(1, 7))
                for _ in range(rng.randrange(5, 9))]
        plan = part(make(TOY, 4, 2, 32, 4, **device_kw), hosts=hosts)
        return hosts, reqs, schedule_cls.random(rng, plan).describe()

    assert draw(make_decode_farm, partition, sim.FaultSchedule,
                {"device": CPU}) == draw(jmake_decode_farm, jpartition,
                                         jsim.FaultSchedule, {})


def test_engine_adopt_exactly_once_across_crash(tmp_path):
    """Durable serving: the engine persists its in-flight request table, a
    crash mid-serving loses the backend AND engine, and a fresh pair adopts
    the store — every request answered exactly once, identical to the
    per-request oracle (no drop, no duplicate)."""
    model, params = _toy()
    reqs = [Request(rid=i, prompt=(3 + i, 7, 11 + i)[:1 + i % 3],
                    max_new=3 + i % 4) for i in range(6)]
    expect = {r.rid: _oracle_tokens(model, params, r, max_len=32)
              for r in reqs}
    d = str(tmp_path)
    kw = {"max_len": 32, "prefill_chunk": 4, "snapshot_every": 2,
          "snapshot_dir": d}
    be = _backend(**kw)
    eng = ServeEngine(be, store=be.store)
    for r in reqs[:4]:
        eng.submit(r)
    for _ in range(4):
        eng.step()  # some requests complete, some stay in flight
    be.close()  # the crash: engine and backend both die here

    be2 = _backend(**kw)
    try:
        eng2 = ServeEngine.adopt(be2, DeploymentStore(d))
        for r in reqs[4:]:
            eng2.submit(r)
        eng2.run_until_drained()
        answered = [resp.rid for resp in eng2.completed]
        for r in reqs:
            assert answered.count(r.rid) == 1, \
                f"rid {r.rid} answered {answered.count(r.rid)} times"
            assert eng2.poll(r.rid).tokens == expect[r.rid], f"req {r.rid}"
    finally:
        be2.close()


# ==========================================================================
# Against the JAX package's farm
# ==========================================================================

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_farm_streams_identical_to_jax_farm(monkeypatch, arch):
    """The JAX package's ClusterDecodeBackend and the port's, each over
    ``inprocess`` with 4 slots in 2 shards, on the JAX package's weights
    carried across: token streams and completion order identical, through
    a ``scale(3)`` after the first step."""
    spec = ("model", arch, True)
    jmodel, jparams = jbuild_decode_model(spec)
    model, like = build_decode_model(spec, device=CPU)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU, like=like)
    # thread hosts build the farm in this process: hand them these weights
    monkeypatch.setattr(engine_mod, "build_decode_model",
                        lambda s, device=None: (model, params))
    reqs = serve_launcher.requests(6, model.cfg.vocab, 6)
    kw = {"n_slots": 4, "shards": 2, "hosts": 2, "transport": "inprocess",
          "max_len": 32}
    jbe = JClusterDecodeBackend(spec, **kw)
    be = ClusterDecodeBackend(spec, device=CPU, **kw)
    try:
        jeng, eng = JServeEngine(jbe), ServeEngine(be)
        for r in reqs[:3]:
            jeng.submit(JRequest(rid=r.rid, prompt=r.prompt,
                                 max_new=r.max_new))
            eng.submit(r)
        jeng.step()
        eng.step()
        for b in (jbe, be):
            ev = b.scale(3)
            assert ev.mode == "reconfigure" and ev.refined is True
        for r in reqs[3:]:
            jeng.submit(JRequest(rid=r.rid, prompt=r.prompt,
                                 max_new=r.max_new))
            eng.submit(r)
        jeng.run_until_drained()
        eng.run_until_drained()
    finally:
        jbe.close()
        be.close()
    assert eng.steps_run == jeng.steps_run
    for r in reqs:
        assert len(eng.poll(r.rid).tokens) == r.max_new
        assert eng.poll(r.rid).tokens == jeng.poll(r.rid).tokens, \
            f"req {r.rid}"
    assert [r.rid for r in eng.completed] == [r.rid for r in jeng.completed]


# ==========================================================================
# The worker's copy of its item's cache
# ==========================================================================

def _qwen2():
    return build_decode_model(("model", "qwen2-0.5b", True), device=CPU)


def _items(model, rows=2, max_len=16, seed=0):
    """A seeded decode batch of two shard items, each cache filled with a
    few real decode steps so its k/v buffers are not zero."""
    _, params = _qwen2()
    g = np.random.default_rng(seed)
    items = []
    for _ in range(2):
        cache = model.init_cache(rows, max_len, device=CPU)
        for t in g.integers(1, model.cfg.vocab, (3, rows)):
            _, cache = model.decode_step(
                params, cache, torch.as_tensor(t, dtype=torch.int32)[:, None])
        items.append(engine_mod._shard_item(
            cache, rows, 4, torch.device(CPU),
            last=g.integers(1, model.cfg.vocab, rows),
            adv=np.array([True, False])))
    return ClusterDecodeBackend._stack(items)


def test_farm_step_leaves_its_input_unchanged():
    """The model writes the k/v buffers in place; the worker decodes into
    a copy, so the batch a controller keeps for a replay is untouched."""
    model, _ = _qwen2()
    batch = _items(model)
    before = pytree.tree_map(torch.clone, batch)
    net = make_decode_farm(("model", "qwen2-0.5b", True), 4, 2, 16, 4,
                           device=CPU)
    out = build(net, device=CPU).run(batch)["collect"]
    assert len(out) == 2
    for got, want in zip(pytree.tree_leaves(batch),
                         pytree.tree_leaves(before)):
        assert torch.equal(got, want)
    # the step did write: the advanced row's step index moved
    assert any(not torch.equal(o["cache"]["step"], batch["cache"]["step"][w])
               for w, o in enumerate(out))


class _FailOnce:
    """The reduced qwen2 whose ``decode_step`` raises once, AFTER the real
    step wrote its k/v buffers in place: a host failing mid-step."""

    def __init__(self, model, at: int):
        self._model = model
        self.calls = 0
        self.at = at

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, params, cache, tokens, **kw):
        out = self._model.decode_step(params, cache, tokens, **kw)
        self.calls += 1
        if self.calls == self.at:
            raise RuntimeError("injected host failure mid-step")
        return out


def test_failed_and_replayed_step_equals_unfailed(monkeypatch):
    """A farm step whose worker fails after writing its cache is recovered
    and replayed from the kept batch: the engine's streams equal a run
    without the failure, and the backend counted the recovery."""
    spec = ("model", "qwen2-0.5b", True)
    model, params = _qwen2()
    reqs = serve_launcher.requests(4, model.cfg.vocab, 6)

    def serve(fail_at):
        flaky = _FailOnce(model, fail_at)
        monkeypatch.setattr(engine_mod, "build_decode_model",
                            lambda s, device=None: (flaky, params))
        be = ClusterDecodeBackend(spec, n_slots=4, shards=2, hosts=2,
                                  max_len=32, device=CPU)
        try:
            eng = ServeEngine(be)
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
            return {r.rid: eng.poll(r.rid).tokens for r in reqs}, \
                be.recoveries
        finally:
            be.close()

    clean, n0 = serve(fail_at=0)
    # call 40: past the prefills (4 chunks x 8 single-token steps), so a
    # decode step fails with one shard written and replays
    flaky, n1 = serve(fail_at=40)
    assert (n0, n1) == (0, 1)
    assert flaky == clean


# ==========================================================================
# Fault 13: the engine polls the backend's autoscaler every decode step
# ==========================================================================

class _CountingBackend:
    """A numpy-only decode backend: the next token is ``(last + 1) % 32``;
    ``maybe_autoscale`` counts its calls."""

    n_slots = 2
    prefill_chunk = 4

    def __init__(self):
        self.polls = 0

    def reset(self, slot):
        pass

    def prefill(self, slot, toks, act):
        pass

    def decode(self, last, adv):
        return (np.asarray(last, np.int32) + 1) % 32

    def maybe_autoscale(self):
        self.polls += 1

    def close(self):
        pass


def test_engine_polls_maybe_autoscale_every_step():
    reqs = [(i, tuple(range(1, 2 + i % 3)), 2 + i) for i in range(4)]
    for engine_cls, request_cls in ((ServeEngine, Request),
                                    (JServeEngine, JRequest)):
        be = _CountingBackend()
        eng = engine_cls(be)
        for rid, prompt, max_new in reqs:
            eng.submit(request_cls(rid=rid, prompt=prompt, max_new=max_new))
        eng.run_until_drained()
        assert eng.steps_run > 0
        assert be.polls == eng.steps_run, engine_cls.__module__


# ==========================================================================
# The per-shard caches through _state / adopt
# ==========================================================================

def test_state_and_adopt_round_trip_shard_cache(tmp_path):
    """A farm engine persists each shard's cache on the CPU and no local
    cache; ``adopt`` puts every shard back onto the new backend's device,
    equal leaf for leaf."""
    be = _backend(max_len=32, prefill_chunk=4)
    be2 = None
    try:
        eng = ServeEngine(be, store=DeploymentStore(str(tmp_path)))
        for i in range(3):
            eng.submit(Request(rid=i, prompt=(3 + i, 5), max_new=4))
        eng.step()
        eng.step()
        state = eng._state()
        assert state["cache"] is None
        assert len(state["shard_cache"]) == 2
        for saved, live in zip(state["shard_cache"], be.shard_cache):
            for a, b in zip(pytree.tree_leaves(saved),
                            pytree.tree_leaves(live)):
                assert a.device.type == CPU and torch.equal(a, b)
        be2 = _backend(max_len=32, prefill_chunk=4)
        eng2 = ServeEngine.adopt(be2, DeploymentStore(str(tmp_path)))
        assert eng2.steps_run == 2
        for got, want in zip(be2.shard_cache, be.shard_cache):
            for a, b in zip(pytree.tree_leaves(got),
                            pytree.tree_leaves(want)):
                assert a.device == be2.device and torch.equal(a, b)
    finally:
        be.close()
        if be2 is not None:
            be2.close()


def test_farm_emit_probe_runs():
    """Emit's zero items (what a ``run(instances=)`` probe streams) decode
    through the farm: one output item per shard, as many rows each."""
    net = make_decode_farm(TOY, 4, 2, 32, 4, device=CPU)
    out = build(net, device=CPU).run(instances=2)["collect"]
    assert len(out) == 2
    assert all(tuple(o["nxt"].shape) == (2,) for o in out)


# ==========================================================================
# No GPU: nothing runs unless it is given the CPU
# ==========================================================================

@pytest.mark.parametrize("entry", [
    lambda: ClusterDecodeBackend(TOY, n_slots=2, shards=1, hosts=1),
    lambda: make_decode_farm(TOY, 2, 1, 8, 4),
    lambda: serve_launcher.main(["--arch", "qwen2-0.5b", "--reduced",
                                 "--hosts", "2"])],
    ids=["ClusterDecodeBackend", "make_decode_farm", "launcher --hosts 2"])
def test_no_gpu_refuses_without_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
