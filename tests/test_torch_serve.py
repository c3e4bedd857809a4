"""The port's serving engine, on the CPU.

The non-cluster cases of ``tests/test_serve_engine.py`` run on the port's
``ToyLM`` (the sequential oracle, eos, ``max_new=0``, duplicates, the
slot-event audit), and the port's engine over the reduced qwen2-0.5b,
mamba2-2.7b, zamba2-1.2b, deepseek-moe-16b and phi3.5-moe (the MoE archs on
both of their paths), fed the JAX package's ``PRNGKey(0)`` weights, must
give token streams identical to the JAX engine's on the same requests.  The
launcher runs with ``--reduced --device cpu``, locally and over two thread
hosts (``--hosts 2``).
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.models import Model as JModel
from repro.serve import (LocalDecodeBackend as JLocalDecodeBackend,
                         Request as JRequest, ServeEngine as JServeEngine,
                         build_decode_model as jbuild_decode_model)
from repro_torch.core.trace import CountingClock, TraceRecorder
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import Model
from repro_torch.serve import (LocalDecodeBackend, Request, Response,
                               ServeEngine, build_decode_model)

TOY = ("toy", 32, 8)


def _toy():
    return build_decode_model(TOY, device="cpu")


def _engine(model, params, n_slots, max_len=64, **kw):
    return ServeEngine(LocalDecodeBackend(model, params, n_slots=n_slots,
                                          max_len=max_len), **kw)


def _oracle_tokens(model, params, req, max_len=64):
    """The sequential reference: one request alone in a one-slot engine."""
    eng = _engine(model, params, 1, max_len)
    eng.submit(req)
    eng.run_until_drained()
    return eng.poll(req.rid).tokens


# ==========================================================================
# Request / Response surface
# ==========================================================================

def test_request_immutable_prompt_coerced():
    req = Request(rid=0, prompt=[3, 5], max_new=2)
    assert req.prompt == (3, 5)
    with pytest.raises(dataclasses.FrozenInstanceError):
        req.max_new = 9


def test_poll_api_and_response_fields():
    model, params = _toy()
    eng = _engine(model, params, 2)
    assert eng.submit(Request(rid=5, prompt=(3, 4), max_new=3)) == 5
    assert eng.poll(5) is None  # queued, not finished
    with pytest.raises(KeyError):
        eng.poll(99)
    eng.run_until_drained()
    resp = eng.poll(5)
    assert isinstance(resp, Response)
    assert len(resp.tokens) == 3 and resp.finish_reason == "length"
    assert resp.ttft > 0 and resp.latency >= resp.ttft
    with pytest.raises(dataclasses.FrozenInstanceError):
        resp.tokens = ()


def test_duplicate_and_empty_submissions_rejected():
    model, params = _toy()
    eng = _engine(model, params, 2)
    eng.submit(Request(rid=0, prompt=(3,), max_new=1))
    with pytest.raises(ValueError, match="duplicate rid"):
        eng.submit(Request(rid=0, prompt=(4,), max_new=1))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid=1, prompt=(), max_new=1))
    eng.run_until_drained()
    assert [r.rid for r in eng.completed] == [0]


def test_max_new_zero_completes_without_slot():
    model, params = _toy()
    eng = _engine(model, params, 2)
    eng.submit(Request(rid=0, prompt=(5, 7), max_new=0))
    resp = eng.poll(0)
    assert resp is not None and resp.tokens == ()
    assert resp.finish_reason == "length" and resp.first_token_at is None
    assert eng.plan.n_free == 2 and eng.steps_run == 0


def test_eos_truncates_and_reports_reason():
    model, params = _toy()
    req = Request(rid=0, prompt=(5, 9), max_new=6)
    full = _oracle_tokens(model, params, req)
    assert len(full) == 6
    eos = full[2]  # stop on the third generated token
    eng = _engine(model, params, 1, eos_id=eos)
    eng.submit(req)
    eng.run_until_drained()
    resp = eng.poll(0)
    assert resp.finish_reason == "eos"
    assert resp.tokens == tuple(full[:full.index(eos) + 1])


def test_slot_events_audit_matches_trace():
    """Every decoded request's Response carries exactly its own join and
    leave, and the engine's audit trail agrees with the trace recorder's
    admit/done instants."""
    model, params = _toy()
    rec = TraceRecorder(host="serve", clock=CountingClock())
    eng = _engine(model, params, 2, max_len=32, recorder=rec)
    for i in range(3):  # 3 requests > 2 slots forces a slot hand-off
        eng.submit(Request(rid=i, prompt=(2 + i,), max_new=4))
    eng.run_until_drained()
    for i in range(3):
        r = eng.poll(i)
        assert len(r.slot_events) == 2, r.slot_events
        join, leave = r.slot_events
        assert (join.kind, leave.kind) == ("join", "leave")
        assert join.slot == leave.slot and join.step <= leave.step
        assert all(e.rid == i for e in r.slot_events)
    trail = eng.slot_events
    assert sorted((e.rid, e.kind) for e in trail) == sorted(
        (i, k) for i in range(3) for k in ("join", "leave"))
    admits = {e.args["rid"] for e in rec.events() if e.name == "admit"}
    dones = {e.args["rid"] for e in rec.events() if e.name == "done"}
    assert admits == dones == {0, 1, 2}
    assert {e.rid for e in trail if e.kind == "join"} == admits


def test_store_persists_every_step_and_adopt_resumes(tmp_path):
    """``ServeEngine(store=)`` persists the request table and cache each
    step; ``ServeEngine.adopt`` over a fresh backend resumes mid-decode and
    every request ends with its sequential-oracle tokens, answered once."""
    from repro_torch.cluster import DeploymentStore
    model, params = _toy()
    reqs = [Request(rid=i, prompt=tuple(range(1, 2 + i)), max_new=3 + i % 3)
            for i in range(5)]
    expect = {r.rid: _oracle_tokens(model, params, r) for r in reqs}
    store = DeploymentStore(str(tmp_path))
    eng = _engine(model, params, 2, store=store)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    assert store.serve_step() == eng.steps_run == 4
    eng2 = ServeEngine.adopt(LocalDecodeBackend(model, params, n_slots=2,
                                                max_len=64),
                             DeploymentStore(str(tmp_path)))
    assert eng2.steps_run == 4 and eng2._persist_seq == 4
    eng2.run_until_drained()
    answered = [r.rid for r in eng2.completed]
    assert sorted(answered) == list(range(5))
    for r in reqs:
        assert eng2.poll(r.rid).tokens == expect[r.rid], f"req {r.rid}"


# ==========================================================================
# Continuous batching ≡ sequential generation
# ==========================================================================

def test_engine_matches_sequential_oracle():
    model, params = _toy()
    reqs = [Request(rid=i, prompt=tuple(range(1, 2 + i)), max_new=3 + i % 3)
            for i in range(6)]  # 6 requests > 3 slots forces slot reuse
    expect = {r.rid: _oracle_tokens(model, params, r) for r in reqs}
    eng = _engine(model, params, 3)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert sorted(r.rid for r in done) == list(range(6))
    for r in reqs:
        assert eng.poll(r.rid).tokens == expect[r.rid], f"req {r.rid}"


@settings(deadline=None, max_examples=10)
@given(n_slots=st.integers(min_value=1, max_value=3),
       seed=st.integers(min_value=0, max_value=3))
def test_admission_interleavings_each_rid_exactly_once(n_slots, seed):
    """Any interleaving of submits and steps yields every rid exactly once,
    identical to the sequential oracle."""
    model, params = _toy()
    rng = random.Random(seed)
    reqs = [Request(rid=i,
                    prompt=tuple(rng.randrange(1, 32)
                                 for _ in range(rng.randrange(1, 5))),
                    max_new=rng.randrange(1, 5))
            for i in range(5)]
    expect = {r.rid: _oracle_tokens(model, params, r) for r in reqs}
    eng = _engine(model, params, n_slots)
    i = 0
    while i < len(reqs) or eng.pending or eng._live:
        if i < len(reqs) and (rng.random() < 0.5
                              or not (eng.pending or eng._live)):
            eng.submit(reqs[i])
            i += 1
        else:
            eng.step()
    assert sorted(r.rid for r in eng.completed) == [r.rid for r in reqs]
    for r in reqs:
        assert eng.poll(r.rid).tokens == expect[r.rid]


# ==========================================================================
# The real model: the same streams as the JAX engine
# ==========================================================================

def _streams_identical_to_jax_engine(arch, n_slots, **overrides):
    jmodel, jparams = jbuild_decode_model(("model", arch, True))
    model, like = build_decode_model(("model", arch, True), device="cpu")
    if overrides:  # another path through the same weights
        jmodel = JModel(dataclasses.replace(jmodel.cfg, **overrides))
        model = Model(dataclasses.replace(model.cfg, **overrides))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu", like=like)
    reqs = serve_launcher.requests(6, model.cfg.vocab, 8)
    jeng = JServeEngine(JLocalDecodeBackend(jmodel, jparams,
                                            n_slots=n_slots, max_len=32))
    eng = _engine(model, params, n_slots, max_len=32)
    for r in reqs:
        jeng.submit(JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new))
        eng.submit(r)
    jeng.run_until_drained()
    eng.run_until_drained()
    for r in reqs:
        ours, theirs = eng.poll(r.rid), jeng.poll(r.rid)
        assert len(ours.tokens) == r.max_new
        assert ours.tokens == theirs.tokens, f"req {r.rid}"
    assert [r.rid for r in eng.completed] == [r.rid for r in jeng.completed]


@pytest.mark.parametrize("n_slots", [1, 3])
def test_qwen2_streams_identical_to_jax_engine(n_slots):
    _streams_identical_to_jax_engine("qwen2-0.5b", n_slots)


@pytest.mark.parametrize("n_slots", [1, 3])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssm_streams_identical_to_jax_engine(arch, n_slots):
    """The mamba state (conv window, f32 ``h``) through slot reuse: each
    admission resets its slot, and frozen rows keep their state."""
    _streams_identical_to_jax_engine(arch, n_slots)


@pytest.mark.parametrize("n_slots", [1, 3])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_streams_identical_to_jax_engine(arch, ragged, n_slots):
    """Both MoE paths: the capacity path (the configs' default) and the
    ragged grouped-matmul path, through slot reuse and frozen rows."""
    _streams_identical_to_jax_engine(
        arch, n_slots, **({"moe_ragged": True} if ragged else {}))


def test_launcher_runs_reduced_on_cpu(capsys):
    done = serve_launcher.main(["--arch", "qwen2-0.5b", "--reduced",
                                "--device", "cpu", "--requests", "5",
                                "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] qwen2-0.5b (local cpu): 5 requests" in out
    assert "ttft p50" in out and "tpot p50" in out
    assert sorted(r.rid for r in done) == list(range(5))
    for r in done:
        assert len(r.tokens) == 4 // 2 + (r.rid % 4) // 2 + 1
        assert [e.kind for e in r.slot_events] == ["join", "leave"]


def test_launcher_serves_cluster_reduced_on_cpu(capsys):
    """``--hosts 2`` parks the decode farm on a deployment of two thread
    hosts: the same responses as the local backend, and the report names
    the cluster."""
    args = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
            "--requests", "5", "--slots", "4", "--max-new", "4"]
    local = serve_launcher.main(args)
    capsys.readouterr()
    done = serve_launcher.main(args + ["--hosts", "2", "--transport",
                                       "inprocess"])
    out = capsys.readouterr().out
    assert ("[serve] qwen2-0.5b (cluster[inprocessx2h/2 shards] cpu): "
            "5 requests") in out
    assert "ttft p50" in out and "tpot p50" in out
    assert {r.rid: r.tokens for r in done} == {r.rid: r.tokens
                                               for r in local}
    assert all([e.kind for e in r.slot_events] == ["join", "leave"]
               for r in done)


def test_launcher_refuses_virtual_devices(capsys):
    """``--virtual-devices`` no longer refuses: over the ``device``
    transport it puts the decode farm's 2 hosts on 4 virtual devices (all
    the CPU here), and the served tokens are those without the flag."""
    args = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
            "--requests", "5", "--slots", "4", "--max-new", "4", "--hosts",
            "2", "--transport", "device"]
    plain = serve_launcher.main(args)
    done = serve_launcher.main(args + ["--virtual-devices", "4"])
    out = capsys.readouterr().out
    assert "(cluster[devicex2h/2 shards] cpu): 5 requests" in out
    assert {r.rid: r.tokens for r in done} == {r.rid: r.tokens
                                               for r in plain}


def test_launcher_serves_mamba2_reduced_on_cpu(capsys):
    done = serve_launcher.main(["--arch", "mamba2-2.7b", "--reduced",
                                "--device", "cpu", "--requests", "4",
                                "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] mamba2-2.7b (local cpu): 4 requests" in out
    assert sorted(r.rid for r in done) == list(range(4))
    assert all([e.kind for e in r.slot_events] == ["join", "leave"]
               for r in done)


def test_launcher_serves_deepseek_moe_reduced_on_cpu(capsys):
    done = serve_launcher.main(["--arch", "deepseek-moe-16b", "--reduced",
                                "--device", "cpu", "--requests", "4",
                                "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] deepseek-moe-16b (local cpu): 4 requests" in out
    assert sorted(r.rid for r in done) == list(range(4))
    assert all([e.kind for e in r.slot_events] == ["join", "leave"]
               for r in done)
