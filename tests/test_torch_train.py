"""The port's training substrate against the JAX package's, on the CPU:
one train step, gradient accumulation, the loop, the fault-tolerant
runner, the data pipeline, the step as a GPP network, the launcher and the
example CLI.

Weights are the port's seed-0 draw carried to both packages (see
``_torch_loss_pairs.py``); batches are ``SyntheticLM``'s, whose tokens are
the same numpy integers in both.  Float32 at reduced width.  The
gradients agree within 1e-4 (``test_torch_loss_grads.py``), the moments
within 1e-6; the parameters after one AdamW step within 5e-5, the
reference's own gate for two computations of one update
(``test_grad_accum_equivalence``): the first step moves each weight by
lr · g / (|g| + eps), so an entry whose gradient is near eps (the key
bias's is zero in exact arithmetic) turns float rounding of g into up to
1.3e-5 of step at lr 1e-3.  Twelve steps with restarts compound that:
2e-4 there.
"""

import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from _torch_loss_pairs import pair
from repro.data import Prefetcher as JPrefetcher, SyntheticLM as JSyntheticLM
from repro.train import (AdamW as JAdamW, Checkpointer as JCheckpointer,
                         FaultInjector as JFaultInjector,
                         FaultTolerantRunner as JRunner,
                         make_train_step as jmake_train_step)
from repro_torch.core import verify
from repro_torch.data import Prefetcher, SyntheticLM, shard_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.sharding import P, NamedSharding
from repro_torch.interop import params_from_numpy
from repro_torch.train import (AdamW, Checkpointer, FaultInjector,
                               FaultTolerantRunner, make_train_step, remesh,
                               train)
from repro_torch.train.train_loop import as_network

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _by_path(tree) -> dict:
    return {pytree.keystr(k): v
            for k, v in pytree.tree_flatten_with_path(tree)[0]}


def _max_diff(a, b) -> float:
    """Largest leaf difference, leaves paired by key path (a restored
    checkpoint holds its dicts' keys in sorted order)."""
    a, b = _by_path(a), _by_path(b)
    assert a.keys() == b.keys()
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _from_jax(tree, like):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             "cpu", like=like)


# (arch, microbatches): qwen2-0.5b's cases keep their ids "1" and "2"
# (zamba2-1.2b has its own test below)
STEP_CASES = [pytest.param("qwen2-0.5b", 1, id="1"),
              pytest.param("qwen2-0.5b", 2, id="2")] + [
    pytest.param(arch, 1, id=arch)
    for arch in ("mamba2-2.7b", "whisper-tiny")]


class TestTrainStep:
    @pytest.mark.parametrize("arch,accum", STEP_CASES)
    def test_step_equals_the_references(self, arch, accum):
        jm, jp, m, p = pair(arch)
        jopt, opt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
        jsrc = JSyntheticLM(batch=8, seq=16, vocab=m.cfg.vocab)
        src = SyntheticLM(batch=8, seq=16, vocab=m.cfg.vocab, device="cpu")
        jp2, jo2, jmet = jax.jit(jmake_train_step(jm, jopt, grad_accum=accum))(
            jp, jopt.init(jp), jsrc.create(0))
        p2, o2, met = make_train_step(m, opt, grad_accum=accum)(
            p, opt.init(p), src.create(0))
        assert _max_diff(p2, _from_jax(jp2, p2)) < 5e-5
        assert _max_diff(o2["m"], _from_jax(jo2["m"], o2["m"])) < 1e-6
        assert int(o2["step"]) == 1
        assert set(met) == set(jmet)
        for k in met:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)

    def test_zamba2_step_equals_the_references_where_adam_is_conditioned(
            self):
        """zamba2-1.2b's step against the reference's, with
        :meth:`test_step_equals_the_references`' gates on the moments
        (1e-6) and metrics, and its 5e-5 on every parameter whose gradient
        is at least 10 eps in both packages.  Below that, AdamW's first
        step lr · g / (|g| + eps) turns the gradients' rounding into the
        step (reduced zamba2 has in_proj entries with |g| of 1e-10 to 2e-9
        in columns whose largest is 1.6e-3), so such an entry is held to
        5e-5 plus that rounding carried through the step to first order,
        lr · |g - g_ref| / eps."""
        jm, jp, m, p = pair("zamba2-1.2b")
        jopt, opt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
        jsrc = JSyntheticLM(batch=8, seq=16, vocab=m.cfg.vocab)
        src = SyntheticLM(batch=8, seq=16, vocab=m.cfg.vocab, device="cpu")
        jp2, jo2, jmet = jax.jit(jmake_train_step(jm, jopt))(
            jp, jopt.init(jp), jsrc.create(0))
        p2, o2, met = make_train_step(m, opt)(p, opt.init(p), src.create(0))
        assert _max_diff(o2["m"], _from_jax(jo2["m"], o2["m"])) < 1e-6
        ours, theirs = _by_path(p2), _by_path(_from_jax(jp2, p2))
        g, jg = (_by_path(pytree.tree_map(lambda x: x / (1 - opt.b1), t))
                 for t in (o2["m"], _from_jax(jo2["m"], o2["m"])))
        loose = 0
        for k in ours:
            sharp = torch.minimum(g[k].abs(), jg[k].abs()) >= 10 * opt.eps
            gate = torch.where(sharp, 5e-5, 5e-5 + opt.lr
                               * (g[k] - jg[k]).abs() / opt.eps)
            assert bool(((ours[k] - theirs[k]).abs() <= gate).all()), k
            loose += int((~sharp).sum())
        assert loose < 1e-2 * sum(t.numel() for t in ours.values())
        assert int(o2["step"]) == 1 and set(met) == set(jmet)
        for k in met:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)

    def test_grad_accum_equivalence(self):
        """accum=2 over the same global batch ≈ accum=1 (same update)."""
        _, _, m, p = pair("qwen2-0.5b")
        opt = AdamW(lr=1e-3)
        batch = SyntheticLM(batch=8, seq=16, vocab=m.cfg.vocab,
                            device="cpu").create(0)
        p1, _, _ = make_train_step(m, opt, grad_accum=1)(p, opt.init(p),
                                                         batch)
        p2, _, _ = make_train_step(m, opt, grad_accum=2)(p, opt.init(p),
                                                         batch)
        assert _max_diff(p1, p2) < 5e-5

    def test_step_leaves_its_arguments_alone(self):
        _, _, m, p = pair("qwen2-0.5b")
        opt = AdamW(lr=1e-3)
        state = opt.init(p)
        batch = SyntheticLM(batch=4, seq=16, vocab=m.cfg.vocab,
                            device="cpu").create(0)
        snap = [t.clone() for t in pytree.tree_leaves((p, state, batch))]
        step = make_train_step(m, opt)
        a, b = step(p, state, batch), step(p, state, batch)
        for x, y in zip(pytree.tree_leaves((p, state, batch)), snap):
            assert torch.equal(x, y)
        assert _max_diff(a[0], b[0]) == 0.0

    @pytest.mark.parametrize("arch,accum", [("qwen2-0.5b", 1),
                                            ("qwen2-0.5b", 2),
                                            ("mamba2-2.7b", 1)])
    def test_donating_step_equals_the_pure_one(self, arch, accum):
        """Three steps with ``donate=True`` give the pure step's
        parameters, moments and metrics bit for bit, in the storage the
        weights and moments had before."""
        _, _, m, p = pair(arch)
        opt = AdamW(lr=1e-2)
        src = SyntheticLM(batch=4, seq=16, vocab=m.cfg.vocab, device="cpu")
        pure = make_train_step(m, opt, grad_accum=accum)
        donating = make_train_step(m, opt, grad_accum=accum, donate=True)
        state = opt.init(p)
        ours = pytree.tree_map(torch.clone, (p, state))
        ptrs = [t.data_ptr() for t in pytree.tree_leaves(
            (ours[0], ours[1]["m"], ours[1]["v"]))]
        for i in range(3):
            p, state, met = pure(p, state, src.create(i))
            p2, s2, met2 = donating(*ours, src.create(i))
            ours = (p2, s2)
            for a, b in zip(pytree.tree_leaves((p, state)),
                            pytree.tree_leaves(ours)):
                assert torch.equal(a, b)
            assert met.keys() == met2.keys()
            for k in met:
                assert torch.equal(met[k], met2[k]), k
        assert ptrs == [t.data_ptr() for t in pytree.tree_leaves(
            (ours[0], ours[1]["m"], ours[1]["v"]))]

    def test_train_writes_no_given_tree(self):
        """``train(params=p, opt_state=s)`` leaves ``p`` and ``s`` as they
        were (its first step is the pure one, the rest donate what the
        loop owns), and its history and result are the pure loop's."""
        _, _, m, p = pair("mamba2-2.7b")
        opt = AdamW(lr=1e-2)
        src = SyntheticLM(batch=4, seq=16, vocab=m.cfg.vocab, device="cpu")
        state = opt.init(p)
        snap = [t.clone() for t in pytree.tree_leaves((p, state))]
        res = train(m, src, steps=3, opt=opt, device="cpu", params=p,
                    opt_state=state, log_every=1)
        for x, y in zip(pytree.tree_leaves((p, state)), snap):
            assert torch.equal(x, y)
        step, want = make_train_step(m, opt), []
        for i in range(3):
            p, state, met = step(p, state, src.create(i))
            want.append({k: float(v) for k, v in met.items()})
        for h, w in zip(res["history"], want):
            assert {k: h[k] for k in w} == w
        for a, b in zip(pytree.tree_leaves((res["params"],
                                            res["opt_state"])),
                        pytree.tree_leaves((p, state))):
            assert torch.equal(a, b)

    def test_train_of_its_own_weights_equals_the_pure_loop(self):
        """Without given trees every step donates, and the loop still
        gives the pure loop's weights, moments and losses bit for bit."""
        _, _, m, _ = pair("qwen2-0.5b")
        opt = AdamW(lr=1e-2)
        src = SyntheticLM(batch=4, seq=16, vocab=m.cfg.vocab, device="cpu")
        res = train(m, src, steps=3, opt=opt, device="cpu", seed=0,
                    log_every=1)
        p = m.init(seed=0, device="cpu")
        state, step, losses = opt.init(p), make_train_step(m, opt), []
        for i in range(3):
            p, state, met = step(p, state, src.create(i))
            losses.append(float(met["loss"]))
        assert [h["loss"] for h in res["history"]] == losses
        for a, b in zip(pytree.tree_leaves((res["params"],
                                            res["opt_state"])),
                        pytree.tree_leaves((p, state))):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("async_save", [False, True],
                             ids=["sync", "async"])
    def test_checkpoint_outlives_later_in_place_steps(self, tmp_path,
                                                      async_save):
        """A checkpoint saved at step 2 of a donating loop, restored after
        two more steps wrote into the same storage, is the state of step
        2."""
        _, _, m, _ = pair("qwen2-0.5b")
        src = SyntheticLM(batch=2, seq=8, vocab=m.cfg.vocab, device="cpu")
        ck = Checkpointer(str(tmp_path), async_save=async_save)
        seen = {}

        def on_step(i, params, opt_state, metrics):
            if i == 1:  # the state that the step-2 checkpoint saves
                seen["state"] = pytree.tree_map(
                    torch.clone, {"params": params, "opt_state": opt_state})
                seen["ptr"] = pytree.tree_leaves(params)[0].data_ptr()

        res = train(m, src, steps=4, device="cpu", checkpointer=ck,
                    ckpt_every=2, on_step=on_step)
        ck.wait()
        assert pytree.tree_leaves(res["params"])[0].data_ptr() == seen["ptr"]
        assert _max_diff(res["params"], seen["state"]["params"]) > 0
        step, back = ck.restore(seen["state"], 2, device="cpu")
        assert step == 2
        assert _max_diff(back, seen["state"]) == 0

    def test_loss_decreases(self):
        _, _, m, _ = pair("qwen2-0.5b")
        src = SyntheticLM(batch=8, seq=32, vocab=m.cfg.vocab, device="cpu")
        res = train(m, src, steps=40, opt=AdamW(lr=1e-2), device="cpu",
                    log_every=1)
        losses = [h["loss"] for h in res["history"]]
        first = sum(losses[:5]) / 5
        last = sum(losses[-5:]) / 5  # step noise: compare window means
        assert last < first - 0.25, (first, last)
        assert res["step"] == 40 and len(res["history"]) == 40

    def test_train_checkpoints_and_refuses_a_mesh(self, tmp_path):
        _, _, m, _ = pair("qwen2-0.5b")
        src = SyntheticLM(batch=2, seq=8, vocab=m.cfg.vocab, device="cpu")
        ck = Checkpointer(str(tmp_path), async_save=True)
        res = train(m, src, steps=4, device="cpu", checkpointer=ck,
                    ckpt_every=2, log_every=2)
        ck.wait()
        assert ck.steps_on_disk() == [2, 4]
        assert [h["step"] for h in res["history"]] == [0, 2, 3]
        step, back = ck.restore({"params": res["params"],
                                 "opt_state": res["opt_state"]},
                                device="cpu")
        assert step == 4 and _max_diff(back["params"], res["params"]) == 0
        # a mesh trains SPMD inside a world of its ranks
        # (tests/test_torch_distributed.py); in one process it is refused
        with pytest.raises(RuntimeError, match="needs a world of 4 ranks"):
            train(m, src, steps=1, device="cpu",
                  mesh=make_mesh((2, 2), ("data", "model"), device="cpu"))

    def test_train_runs_on_the_card_by_default(self, monkeypatch):
        _, _, m, _ = pair("qwen2-0.5b")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train(m, None, steps=1)


def _runner_step(m, opt, src):
    step = make_train_step(m, opt)

    def step_fn(i, st):
        p, o, _ = step(st["params"], st["opt_state"], src.create(i))
        return {"params": p, "opt_state": o}

    return step_fn


class TestFaultTolerance:
    @pytest.mark.parametrize("async_save", [False, True],
                             ids=["sync", "async"])
    def test_injected_failures_recovered(self, async_save):
        _, _, m, p = pair("qwen2-0.5b")
        opt = AdamW(lr=1e-3)
        step_fn = _runner_step(m, opt, SyntheticLM(
            batch=4, seq=16, vocab=m.cfg.vocab, device="cpu"))
        state = {"params": p, "opt_state": opt.init(p)}
        with tempfile.TemporaryDirectory() as d:
            runner = FaultTolerantRunner(
                Checkpointer(d, async_save=async_save), max_restarts=3)
            final = runner.run(total_steps=12, state=state,
                               step_fn=step_fn, save_every=3,
                               injector=FaultInjector(fail_at=(4, 9)))
            runner.ckpt.wait()
        assert runner.restarts == 2
        clean = state  # deterministic data: a clean 12-step run
        for i in range(12):
            clean = step_fn(i, clean)
        assert _max_diff(final["params"], clean["params"]) < 1e-6
        assert int(final["opt_state"]["step"]) == 12

    def test_recovered_state_equals_the_references(self):
        """Both packages' runners, failures at 4 and 9: the same final
        parameters."""
        jm, jp, m, p = pair("qwen2-0.5b")
        jopt, opt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
        jsrc = JSyntheticLM(batch=4, seq=16, vocab=m.cfg.vocab)
        jstep = jax.jit(jmake_train_step(jm, jopt))

        def jstep_fn(i, st):
            pp, oo, _ = jstep(st["params"], st["opt_state"], jsrc.create(i))
            return {"params": pp, "opt_state": oo}

        step_fn = _runner_step(m, opt, SyntheticLM(
            batch=4, seq=16, vocab=m.cfg.vocab, device="cpu"))
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            jrun = JRunner(JCheckpointer(d1), max_restarts=3)
            jfinal = jrun.run(total_steps=12,
                              state={"params": jp,
                                     "opt_state": jopt.init(jp)},
                              step_fn=jstep_fn, save_every=3,
                              injector=JFaultInjector(fail_at=(4, 9)))
            run = FaultTolerantRunner(Checkpointer(d2), max_restarts=3)
            final = run.run(total_steps=12,
                            state={"params": p, "opt_state": opt.init(p)},
                            step_fn=step_fn, save_every=3,
                            injector=FaultInjector(fail_at=(4, 9)))
        assert run.restarts == jrun.restarts == 2
        assert _max_diff(final["params"],
                         _from_jax(jfinal["params"], final["params"])) < 2e-4

    def test_failure_before_any_checkpoint_restarts_from_the_start(self):
        """No checkpoint yet: step 0 again, from the state given (the
        reference keeps the failed run's state)."""
        seen = []

        def step_fn(i, st):
            seen.append(i)
            return {"x": st["x"] + 1}

        with tempfile.TemporaryDirectory() as d:
            runner = FaultTolerantRunner(Checkpointer(d), max_restarts=1)
            final = runner.run(total_steps=4, state={"x": torch.zeros(())},
                               step_fn=step_fn, save_every=3,
                               injector=FaultInjector(fail_at=(2,)))
        assert seen == [0, 1, 0, 1, 2, 3] and float(final["x"]) == 4.0

    def test_restart_before_a_checkpoint_starts_from_the_given_state(self):
        """A failure before the first save: the runner restarts from the
        state it was given, which no step wrote (its steps are pure), and
        ends where a clean run does."""
        _, _, m, p = pair("qwen2-0.5b")
        opt = AdamW(lr=1e-3)
        step_fn = _runner_step(m, opt, SyntheticLM(
            batch=4, seq=16, vocab=m.cfg.vocab, device="cpu"))
        state = {"params": p, "opt_state": opt.init(p)}
        snap = pytree.tree_map(torch.clone, state)
        with tempfile.TemporaryDirectory() as d:
            runner = FaultTolerantRunner(Checkpointer(d), max_restarts=1)
            final = runner.run(total_steps=4, state=state, step_fn=step_fn,
                               save_every=10,
                               injector=FaultInjector(fail_at=(2,)))
        assert runner.restarts == 1
        assert _max_diff(state, snap) == 0
        clean = snap
        for i in range(4):
            clean = step_fn(i, clean)
        assert _max_diff(final, clean) == 0

    def test_resumes_from_an_existing_checkpoint(self):
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d)
            ck.save(3, {"x": torch.full((2,), 3.0)})
            runner = FaultTolerantRunner(ck)
            seen = []

            def step_fn(i, st):
                seen.append(i)
                return {"x": st["x"] + 1}

            final = runner.run(total_steps=5, state={"x": torch.zeros(2)},
                               step_fn=step_fn, save_every=10)
        assert seen == [3, 4] and torch.equal(final["x"],
                                              torch.full((2,), 5.0))

    def test_exceeding_restarts_raises(self):
        with tempfile.TemporaryDirectory() as d:
            runner = FaultTolerantRunner(Checkpointer(d), max_restarts=1)

            def bad_step(i, st):
                raise RuntimeError("permafail")

            with pytest.raises(RuntimeError, match="max_restarts"):
                runner.run(total_steps=3, state={"x": torch.zeros(1)},
                           step_fn=bad_step, save_every=1)

    def test_remesh_places_on_a_device(self):
        """A device re-places every leaf there; new shardings place the
        tree on their mesh, which needs a world of its ranks
        (``test_torch_distributed.py::test_remesh_onto_new_shardings``)."""
        tree = {"a": torch.ones(2), "b": [torch.zeros(1), 3]}
        out = remesh(tree, "cpu")
        assert out["a"].device.type == "cpu" and out["b"][1] == 3
        mesh = make_mesh((2,), ("data",), device="cpu")
        with pytest.raises(RuntimeError, match="needs a world of 2 ranks"):
            remesh({"a": torch.ones(2)}, {"a": NamedSharding(mesh, P())})


class TestDataPipeline:
    @pytest.mark.parametrize("args", [(2, 8, 100, 3), (4, 33, 151936, 0),
                                      (1, 1, 7, 11)])
    def test_tokens_identical_to_the_references(self, args):
        batch, seq, vocab, seed = args
        ours = SyntheticLM(batch, seq, vocab, seed=seed, device="cpu")
        theirs = JSyntheticLM(batch, seq, vocab, seed=seed)
        for step in (0, 5, 17):
            a, b = ours.create(step), theirs.create(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == torch.int32
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))

    def test_synthetic_deterministic(self):
        src = SyntheticLM(batch=2, seq=8, vocab=100, seed=3, device="cpu")
        a, b = src.create(5), src.create(5)
        assert torch.equal(a["tokens"], b["tokens"])
        assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])

    def test_prefetcher_order_and_ut(self):
        src = SyntheticLM(batch=1, seq=4, vocab=50, device="cpu")
        pf = Prefetcher(src, depth=2, n_steps=5)
        got = list(pf)
        assert [s for s, _ in got] == [0, 1, 2, 3, 4]  # ordered, then UT
        jsteps = [s for s, _ in JPrefetcher(JSyntheticLM(1, 4, 50), depth=2,
                                            n_steps=5)]
        assert jsteps == [s for s, _ in got]
        assert torch.equal(got[3][1]["tokens"], src.create(3)["tokens"])

    def test_shard_batch_places_and_refuses_a_mesh(self):
        """Without a mesh the batch lands on the device; a mesh shards it
        inside a world of its ranks (``test_torch_distributed.py``), and
        is refused, naming that world, in one process."""
        b = {"tokens": torch.ones(2, 3, dtype=torch.int32)}
        assert shard_batch(b, None, device="cpu")["tokens"].device.type \
            == "cpu"
        mesh = make_mesh((2,), ("data",), device="cpu")
        with pytest.raises(RuntimeError, match="needs a world of 2 ranks"):
            shard_batch(b, mesh)
        with pytest.raises(RuntimeError, match="needs a world of 2 ranks"):
            Prefetcher(SyntheticLM(1, 4, 50, device="cpu"), mesh=mesh)

    def test_source_runs_on_the_card_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SyntheticLM(1, 4, 50)


class TestLMAsNetwork:
    def test_train_network_verifies_and_steps(self):
        _, _, m, p = pair("qwen2-0.5b")
        opt = AdamW(lr=1e-3)
        net = as_network(m, opt)
        assert net.name == "train[qwen2-0.5b]"
        report = verify(net)  # gppBuilder accepts the training topology
        assert report.checks
        src = SyntheticLM(batch=4, seq=16, vocab=m.cfg.vocab, device="cpu")
        worker = next(pd for pd in net.procs.values()
                      if pd.name == "train_step")
        p2, o2, metrics = worker.fn((p, opt.init(p), src.create(0)))
        assert np.isfinite(float(metrics["loss"]))
        assert int(o2["step"]) == 1


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def test_train_cli(capsys):
    from repro_torch.launch import train as launcher
    res = launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                         "8", "--batch", "4", "--seq", "32", "--device",
                         "cpu"])
    out = capsys.readouterr().out
    assert "network train[qwen2-0.5b] verified" in out
    assert "loss" in out and res["step"] == 8
    assert np.isfinite(res["history"][-1]["loss"])


@pytest.mark.parametrize("flag", [["--mesh", "single"], ["--mesh", "multi"]])
def test_train_cli_refuses_a_mesh(flag):
    """The production mesh needs a world of 256 or 512 ranks; one process
    is refused, naming it."""
    from repro_torch.launch import train as launcher
    need = 512 if flag[1] == "multi" else 256
    with pytest.raises(SystemExit, match=f"needs a world of {need} ranks"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                       "cpu", *flag])


def test_train_cli_checkpoints(tmp_path, capsys):
    from repro_torch.launch import train as launcher
    launcher.main(["--arch", "mamba2-2.7b", "--reduced", "--steps", "4",
                   "--batch", "2", "--seq", "16", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert Checkpointer(str(tmp_path)).steps_on_disk() == [2, 4]
    assert "network train[mamba2-2.7b] verified" in capsys.readouterr().out


def test_example_recovers_the_injected_failure():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_lm.py"),
         "--device", "cpu", "--steps", "20", "--batch", "2", "--seq", "32"],
        env=_env(), capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "restarts survived: 1" in out.stdout
    assert "injected node failure at step 10" in out.stderr
