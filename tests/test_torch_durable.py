"""The port's durable deployments against the JAX package's, on the CPU.

The cases of the reference's ``tests/test_durable.py`` that need no
fault-injection simulator, on the same farms written in tensors: the
deployment store, fresh and salvage adoption, replay from a fold snapshot
instead of chunk 0, and the stale-epoch guard — each result equal to the
JAX deployment's on the same farm (exact: the sums are of integer-valued
floats).  A mid-batch crash that the reference reaches only through its
simulator: a thread-host batch fails, the deployment is dropped without
``recover()``, and a new controller adopts it and replays from the host
snapshots.  The reference's ``Checkpointer`` cases of
``tests/test_train.py``, a bfloat16 round trip, and one checkpoint in each
direction between the packages.  Durable serving on the reduced qwen2
with the JAX package's weights: a crashed engine's store adopted by a new
one answers every request exactly once with the JAX engine's tokens.
"""

import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster as jcl
import repro.core as jcore
from repro.serve import (LocalDecodeBackend as JLocalDecodeBackend,
                         Request as JRequest, ServeEngine as JServeEngine,
                         build_decode_model as jbuild_decode_model)
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch.cluster import (ClusterDeployment, ClusterError,
                                 DeploymentStore, DurabilityEvent)
from repro_torch.cluster.durable import _to_blob, to_host
from repro_torch.core import DataParallelCollect, run_sequential
from repro_torch.core.dataflow import NetworkError
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.serve import (LocalDecodeBackend, ServeEngine,
                               build_decode_model)
from repro_torch.train import Checkpointer

CPU = "cpu"


# -- the reference's farms, in both packages ----------------------------------

def _dur_farm(n, workers):
    return DataParallelCollect(
        create=lambda i: torch.tensor(float(i)), function=lambda x: x * x,
        collector=lambda a, x: a + x, init=torch.tensor(0.0),
        workers=workers, jit_combine=True)


def _jdur_farm(n, workers):
    return jcore.DataParallelCollect(
        create=lambda i: jnp.asarray(float(i)), function=lambda x: x * x,
        collector=lambda a, x: a + x, init=jnp.asarray(0.0),
        workers=workers, jit_combine=True)


_TRIP: dict = {}  # module-level so the collector closure stays picklable


def _trip_farm(trip_at, lib="torch"):
    """A stateful dict-collector farm whose collector raises ONCE, on its
    ``trip_at``-th call — a transient failure landing mid-batch, past the
    fold snapshots the stream wrote along the way."""
    def coll(acc, x):
        _TRIP[lib] = _TRIP.get(lib, 0) + 1
        if _TRIP[lib] == trip_at:
            raise RuntimeError("transient collector failure")
        return {**acc, len(acc): float(x)}

    if lib == "jax":
        return jcore.DataParallelCollect(
            create=lambda i: jnp.asarray(float(i)), function=lambda x: x * x,
            collector=coll, init={}, workers=2, jit_combine=False)
    return DataParallelCollect(
        create=lambda i: torch.tensor(float(i)), function=lambda x: x * x,
        collector=coll, init={}, workers=2, jit_combine=False)


def _same_values(a, b) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.fixture
def tmpdirs():
    made = []

    def make():
        made.append(tempfile.mkdtemp())
        return made[-1]

    yield make
    for d in made:
        shutil.rmtree(d, ignore_errors=True)


# ==========================================================================
# the deployment store
# ==========================================================================

class TestDeploymentStore:
    def test_meta_roundtrip_across_instances(self, tmp_path):
        """A SECOND store instance (the adopting controller) sees the
        flushed meta — async writes are invisible cross-instance until
        flush()."""
        state = {"epoch": 3, "kept": {("a", "b"): [1, 2]},
                 "arr": np.arange(4.0), "t": torch.arange(3.0)}
        s1 = DeploymentStore(str(tmp_path))
        s1.save_meta(1, state)
        s1.flush()
        s2 = DeploymentStore(str(tmp_path))
        got = s2.load_meta()
        assert got["epoch"] == 3
        assert got["kept"] == {("a", "b"): [1, 2]}
        np.testing.assert_array_equal(got["arr"], state["arr"])
        assert torch.equal(got["t"], state["t"])
        assert s2.meta_step() == 1

    def test_empty_store_loads_none(self, tmp_path):
        assert DeploymentStore(str(tmp_path)).load_meta() is None
        assert DeploymentStore(str(tmp_path)).load_host_snapshot(0) is None

    def test_host_snapshot_roundtrip(self, tmp_path):
        snap = {"batch_id": 4, "epoch": 2, "next_ci": 6,
                "host_accs": {"collect": {0: 0.0, 1: 1.0}}}
        store = DeploymentStore(str(tmp_path))
        ck = store.host_checkpointer(1)
        ck.save(6, _to_blob(snap))
        ck.wait()
        assert DeploymentStore(str(tmp_path)).load_host_snapshot(1) == snap

    def test_event_describe_sorts_hosts(self):
        ev = DurabilityEvent(kind="restore", epoch=2, step=4,
                             hosts={1: 2, 0: 0}, note="batch 3")
        jev = jcl.DurabilityEvent(kind="restore", epoch=2, step=4,
                                  hosts={1: 2, 0: 0}, note="batch 3")
        assert ev.describe() == jev.describe() == (
            "restore (epoch 2, step 4); host 0@chunk 0, host 1@chunk 2; "
            "batch 3")


def test_to_host_moves_every_tensor_and_keeps_the_rest():
    t = torch.arange(4.0)
    tree = {"t": t, "n": np.ones(2), "i": 3, "l": [t, "x"]}
    out = to_host(tree)
    assert out["n"] is tree["n"] and out["i"] == 3 and out["l"][1] == "x"
    assert torch.equal(out["t"], t) and out["t"].device.type == "cpu"


# ==========================================================================
# adoption after the controller is gone
# ==========================================================================

class TestAdopt:
    def test_fresh_adopt_bit_identical(self, tmpdirs):
        """Controller and workers both gone: a brand-new controller stands
        itself up from the on-disk meta, re-proves the refinement across
        the restart, bumps the epoch, and serves batches equal to the JAX
        package's doing the same."""
        outs = {}
        for lib, cls, farm in (("torch", ClusterDeployment, _dur_farm),
                               ("jax", jcl.ClusterDeployment, _jdur_farm)):
            d = tmpdirs()
            kw = {"device": CPU} if lib == "torch" else {}
            with cls(factory=(farm, (24, 3)), hosts=2,
                     transport="inprocess", microbatch_size=2,
                     snapshot_every=2, snapshot_dir=d, **kw) as dep:
                r1 = dep.run(instances=24)
                kinds = [e.kind for e in dep.controller.durable_events]
                assert "snapshot" in kinds  # fold snapshots actually wrote
            dep2 = cls.adopt(d, factory=(farm, (24, 3)))
            try:
                ev = dep2.events[-1]
                assert ev.mode == "adopt" and ev.refined is True
                assert dep2.epoch == 2
                assert any(e.kind == "adopt"
                           for e in dep2.controller.durable_events)
                r2 = dep2.run(instances=24)
                _same_values(r1, r2)
                outs[lib] = (r2, ev.describe())
            finally:
                dep2.close()
        _same_values(outs["torch"][0], outs["jax"][0])
        assert outs["torch"][1].split("; wall")[0] == \
            outs["jax"][1].split("; wall")[0]

    def test_salvage_adopt_zero_new_builds(self, tmpdirs):
        """Only the controller died: the new one adopts the on-disk meta
        AND the still-live workers (salvage wiring) — warm survivors build
        not a single stage callable."""
        d = tmpdirs()
        dep = ClusterDeployment(factory=(_dur_farm, (24, 3)), hosts=2,
                                transport="inprocess", microbatch_size=2,
                                snapshot_every=2, snapshot_dir=d, device=CPU)
        dep2 = None
        try:
            dep.start()
            r1 = dep.run(instances=24)
            dep.run(instances=24)  # fully warm
            dep2 = ClusterDeployment.adopt(d, factory=(_dur_farm, (24, 3)),
                                           salvage=dep.salvageable())
            assert dep2.epoch == 2
            assert dep2.events[-1].refined is True
            out = dep2.run(instances=24)
            assert sum(r.jit_builds for r in out.reports) == 0
            _same_values(r1, out)
            with jcl.ClusterDeployment(factory=(_jdur_farm, (24, 3)),
                                       hosts=2, microbatch_size=2) as jdep:
                _same_values(out, jdep.run(instances=24))
        finally:
            (dep2 or dep).close()

    def test_adopt_without_meta_refused(self, tmp_path):
        with pytest.raises(NetworkError, match="no deployment meta"):
            ClusterDeployment.adopt(str(tmp_path),
                                    factory=(_dur_farm, (4, 2)))

    def test_snapshot_every_needs_a_dir(self):
        with pytest.raises(NetworkError, match="snapshot_dir"):
            ClusterDeployment(_dur_farm(4, 2), hosts=2, snapshot_every=2,
                              device=CPU)


# ==========================================================================
# replay from a fold snapshot, not chunk 0
# ==========================================================================

def _fail_then_recover(lib, d):
    """The reference's scenario in ``lib``: the collector trips on its 13th
    call (chunk ~6 of 8, microbatch 2), ``recover()`` replays.  Returns the
    recovered result, the event, the Collect's host and its snapshot."""
    _TRIP.pop(lib, None)
    net = _trip_farm(13, lib)
    if lib == "jax":
        dep = jcl.ClusterDeployment(net, hosts=2, microbatch_size=2,
                                    timeout_s=60, snapshot_every=2,
                                    snapshot_dir=d)
    else:
        dep = ClusterDeployment(net, hosts=2, microbatch_size=2,
                                timeout_s=60, snapshot_every=2,
                                snapshot_dir=d, device=CPU)
    with dep:
        with pytest.raises((ClusterError, jcl.ClusterError)):
            dep.run(instances=16)
        coll_host = [h for h in dep.plan.hosts()
                     if dep.controller._host_stateful(h)][0]
        store = (DeploymentStore if lib == "torch"
                 else jcl.DeploymentStore)(d)
        snap = store.load_host_snapshot(coll_host)
        rec = dep.recover()
        kinds = [e.kind for e in dep.controller.durable_events]
        after = dep.run(instances=16)
        return rec, dep.events, coll_host, snap, kinds, after


class TestReplayFromSnapshot:
    def test_recover_replays_from_snapshot_not_chunk0(self, tmpdirs):
        """A mid-batch failure past the last fold snapshot replays from
        that snapshot's chunk, not chunk 0 — as the JAX deployment does —
        and the stream counts exactly the one resumed attempt."""
        expect = {i: float(i * i) for i in range(16)}
        try:
            got = {lib: _fail_then_recover(lib, tmpdirs())
                   for lib in ("torch", "jax")}
        finally:
            _TRIP.clear()
        rec, events, coll_host, snap, kinds, after = got["torch"]
        assert snap is not None and snap["next_ci"] > 0
        assert rec["collect"] == expect
        (ev,) = events
        assert ev.refined is True
        assert ev.replay_from[coll_host] == snap["next_ci"]
        assert "restore" in kinds
        rep = [r for r in rec.reports if r.host == coll_host][0]
        assert "replays=1@chunk" in rep.stats_summary
        assert after["collect"] == expect
        assert sum(r.jit_builds for r in after.reports) == 0
        jrec, jevents, jcoll, jsnap, _, _ = got["jax"]
        assert jrec["collect"] == rec["collect"]
        assert jcoll == coll_host and jsnap["next_ci"] == snap["next_ci"]
        assert jevents[0].replay_from == ev.replay_from

    def test_snapshot_holds_no_tensor_off_the_cpu(self, tmpdirs):
        """What a host writes is device-free: every tensor of an unpickled
        fold snapshot lies on the CPU, and the jit fold restores."""
        d = tmpdirs()
        with ClusterDeployment(factory=(_dur_farm, (16, 2)), hosts=2,
                               microbatch_size=2, snapshot_every=2,
                               snapshot_dir=d, device=CPU) as dep:
            dep.run(instances=16)
        snaps = [DeploymentStore(d).load_host_snapshot(h) for h in (0, 1)]
        leaves = [l for s in snaps if s is not None
                  for l in torch.utils._pytree.tree_leaves(
                      (s["jit_accs"], s["host_accs"], s["combine_carry"]))]
        assert any(isinstance(l, torch.Tensor) for l in leaves)
        assert all(l.device.type == "cpu" for l in leaves
                   if isinstance(l, torch.Tensor))


class TestMidBatchControllerCrash:
    def test_dropped_deployment_adopted_and_replayed(self, tmpdirs):
        """A thread-host batch fails and the deployment is dropped without
        ``recover()`` (the controller is gone).  A new controller adopts
        the store, finds the batch still pending, and ``recover()``
        replays the Collect's host from its snapshot to the oracle."""
        d = tmpdirs()
        expect = {i: float(i * i) for i in range(16)}
        _TRIP.pop("torch", None)
        try:
            dep = ClusterDeployment(_trip_farm(13), hosts=2,
                                    microbatch_size=2, timeout_s=60,
                                    snapshot_every=2, snapshot_dir=d,
                                    device=CPU)
            with dep:
                with pytest.raises(ClusterError):
                    dep.run(instances=16)
                coll_host = [h for h in dep.plan.hosts()
                             if dep.controller._host_stateful(h)][0]
            snap = DeploymentStore(d).load_host_snapshot(coll_host)
            assert snap is not None and snap["next_ci"] > 0
            dep2 = ClusterDeployment.adopt(d, factory=(_trip_farm, (13,)))
            with dep2:
                assert dep2.epoch == 2 and dep2.controller._needs_recovery
                assert dep2.events[-1].refined is True
                rec = dep2.recover()
                assert rec["collect"] == expect
                ev = dep2.events[-1]
                assert ev.mode == "restart" and dep2.epoch == 3
                assert ev.replay_from[coll_host] == snap["next_ci"]
                assert [e.kind for e in dep2.durable_events].count(
                    "restore") == 1
                assert dep2.run(instances=16)["collect"] == expect
        finally:
            _TRIP.clear()


class TestStaleEpochGuard:
    def test_stale_epoch_report_is_dropped(self):
        """A host that stalled past timeout_s eventually finishes the
        abandoned attempt and reports under the OLD epoch with the CURRENT
        batch id — only the epoch stamp tells it apart from the replay.
        The controller drops it rather than record the pre-recovery
        payload."""
        with ClusterDeployment(factory=(_dur_farm, (12, 2)), hosts=2,
                               transport="inprocess", microbatch_size=2,
                               device=CPU) as dep:
            r1 = dep.run(instances=12)
            ctrl = dep.controller
            for h in dep.plan.hosts():
                ctrl._result_q.put(
                    ("ok", h, ctrl._batch_seq, ctrl.epoch - 1,
                     {"collect": torch.tensor(-999.0)}, None))
            out = dep.run(instances=12)
            assert torch.equal(out["collect"], r1["collect"])
            assert float(out["collect"]) == float(
                run_sequential(_dur_farm(12, 2), 12, device=CPU)["collect"])


# ==========================================================================
# the Checkpointer (the reference's TestCheckpoint, bf16, both packages)
# ==========================================================================

class TestCheckpoint:
    def test_roundtrip_exact(self, tmp_path):
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)}}
        ck = Checkpointer(str(tmp_path))
        ck.save(7, tree)
        step, restored = ck.restore(tree, device=CPU)
        assert step == 7
        assert torch.equal(restored["a"], tree["a"])
        assert torch.equal(restored["b"]["c"], tree["b"]["c"])
        assert restored["b"]["c"].dtype == torch.int32

    def test_latest_pointer_and_gc(self, tmp_path):
        tree = {"x": torch.zeros(3)}
        ck = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, tree)
        assert ck.latest_step() == 4
        steps = sorted(x for x in os.listdir(tmp_path)
                       if x.startswith("step_"))
        assert len(steps) == 2  # GC kept the last two

    def test_async_save(self, tmp_path):
        tree = {"x": torch.ones(100)}
        ck = Checkpointer(str(tmp_path), async_save=True)
        ck.save(1, tree)
        ck.wait()
        assert ck.latest_step() == 1

    def test_structure_mismatch_refused(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, {"a": torch.zeros(3)})
        with pytest.raises(AssertionError, match="structure mismatch"):
            ck.restore({"a": torch.zeros(3), "b": torch.zeros(2)},
                       device=CPU)

    def test_corrupt_latest_falls_back_to_previous_step(self, tmp_path):
        """A torn write (process killed mid-save) does not take restore()
        down with it: the truncated latest step is skipped and the
        previous complete step restores."""
        like = {"x": torch.zeros(4)}
        ck = Checkpointer(str(tmp_path), keep=3)
        ck.save(1, {"x": torch.arange(4.0)})
        ck.save(2, {"x": torch.arange(4.0) * 10})
        leaf = os.path.join(tmp_path, "step_00000002", "leaf_00000.npy")
        with open(leaf, "wb") as f:
            f.write(b"\x93NUMPY")  # header cut short
        step, restored = ck.restore(like, device=CPU)
        assert step == 1
        assert torch.equal(restored["x"], torch.arange(4.0))
        # an explicit step= stays strict
        with pytest.raises(Exception):
            ck.restore(like, step=2, device=CPU)

    def test_tmp_dir_from_killed_write_is_invisible(self, tmp_path):
        """A kill BEFORE the atomic rename leaves only step_X.tmp — which
        neither restore() nor steps_on_disk() may see."""
        like = {"x": torch.zeros(2)}
        ck = Checkpointer(str(tmp_path))
        ck.save(5, {"x": torch.tensor([1.0, 2.0])})
        os.makedirs(os.path.join(tmp_path, "step_00000006.tmp"))
        assert ck.steps_on_disk() == [5]
        step, restored = ck.restore(like, device=CPU)
        assert step == 5
        assert torch.equal(restored["x"], torch.tensor([1.0, 2.0]))

    def test_all_steps_corrupt_reraises(self, tmp_path):
        like = {"x": torch.zeros(2)}
        ck = Checkpointer(str(tmp_path))
        ck.save(1, {"x": torch.ones(2)})
        leaf = os.path.join(tmp_path, "step_00000001", "leaf_00000.npy")
        with open(leaf, "wb") as f:
            f.write(b"junk")
        with pytest.raises(Exception):
            ck.restore(like, device=CPU)

    def test_bfloat16_roundtrip_as_uint16_bits(self, tmp_path):
        """numpy has no bf16: the leaf is saved as its uint16 bits, the
        manifest says "bfloat16", and it comes back bit for bit; a None
        holds no leaf, as in JAX."""
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)
                             ).to(torch.bfloat16)
        tree = {"w": x, "none": None, "s": torch.tensor(2.5)}
        ck = Checkpointer(str(tmp_path))
        ck.save(1, tree)
        import json
        with open(os.path.join(tmp_path, "step_00000001",
                               "manifest.json")) as f:
            man = json.load(f)
        assert man["n_leaves"] == 2
        assert [l["dtype"] for l in man["leaves"]] == ["float32", "bfloat16"]
        assert np.load(os.path.join(tmp_path, "step_00000001",
                                    "leaf_00001.npy")).dtype == np.uint16
        _, got = ck.restore(tree, device=CPU)
        assert got["none"] is None and got["s"].shape == ()
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))


def _cross_tree():
    rng = np.random.default_rng(7)
    return {"b": {"c": rng.integers(-5, 5, size=(3,)).astype(np.int32)},
            "a": rng.normal(size=(3, 4)).astype(np.float32),
            "z": np.float32(1.5)}


def test_jax_writes_the_port_restores(tmp_path):
    """The JAX Checkpointer writes an f32/int32 tree; the port restores it
    into its own tree, leaf for leaf (dict keys in JAX's sorted order)."""
    tree = _cross_tree()
    JCheckpointer(str(tmp_path)).save(3, jax.tree_util.tree_map(
        jnp.asarray, tree))
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(3)},
            "z": torch.zeros(())}
    step, got = Checkpointer(str(tmp_path)).restore(like, device=CPU)
    assert step == 3
    for k in ("a", "z"):
        assert np.array_equal(got[k].numpy(), tree[k])
    assert got["b"]["c"].dtype == torch.int32
    assert np.array_equal(got["b"]["c"].numpy(), tree["b"]["c"])


def test_the_port_writes_jax_restores(tmp_path):
    tree = _cross_tree()
    Checkpointer(str(tmp_path)).save(
        4, {k: v if k == "b" else torch.from_numpy(np.asarray(v))
            for k, v in tree.items()})
    like = jax.tree_util.tree_map(jnp.zeros_like, tree)
    step, got = JCheckpointer(str(tmp_path)).restore(like)
    assert step == 4
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(tree)):
        assert pa == pb
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), b)


# ==========================================================================
# durable serving: crash, adopt, every request exactly once
# ==========================================================================

def _crash_and_adopt(engine_cls, make_backend, store, reqs):
    """Serve ``reqs`` until at least two have finished and two are in
    flight, drop engine and backend (the crash), adopt the store on a
    fresh backend and drain.  Returns the adopted engine."""
    eng = engine_cls(make_backend(), store=store, persist_every=1)
    for r in reqs:
        eng.submit(r)
    while len(eng.completed) < 2 or len(eng._live) < 2:
        assert eng.step(), "drained before the crash point"
    del eng  # the crash: engine and backend both die here
    eng2 = engine_cls.adopt(make_backend(), type(store)(store.root))
    eng2.run_until_drained()
    return eng2


def test_durable_serving_answers_once_with_jax_tokens(tmpdirs):
    arch = "qwen2-0.5b"
    jmodel, jparams = jbuild_decode_model(("model", arch, True))
    model, like = build_decode_model(("model", arch, True), device=CPU)
    assert model.cfg.compute_dtype == "float32"
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU, like=like)
    reqs = serve_launcher.requests(6, model.cfg.vocab, 8)
    eng = _crash_and_adopt(
        ServeEngine, lambda: LocalDecodeBackend(model, params, n_slots=3,
                                                max_len=32),
        DeploymentStore(tmpdirs()), reqs)
    jeng = _crash_and_adopt(
        JServeEngine, lambda: JLocalDecodeBackend(jmodel, jparams, n_slots=3,
                                                  max_len=32),
        jcl.DeploymentStore(tmpdirs()),
        [JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
         for r in reqs])
    answered = [r.rid for r in eng.completed]
    for r in reqs:
        assert answered.count(r.rid) == 1, f"rid {r.rid}: {answered}"
        ours = eng.poll(r.rid)
        assert len(ours.tokens) == r.max_new
        assert ours.tokens == jeng.poll(r.rid).tokens, f"req {r.rid}"
    assert answered == [r.rid for r in jeng.completed]
    # the persisted state is device-free and the cache came back whole
    state = DeploymentStore(eng.store.root).load_serve()
    assert all(l.device.type == "cpu"
               for l in torch.utils._pytree.tree_leaves(state["cache"]))


def test_adopt_without_serving_state_refused(tmp_path):
    model, params = build_decode_model(("toy", 32, 8), device=CPU)
    backend = LocalDecodeBackend(model, params, n_slots=1, max_len=8)
    with pytest.raises(NetworkError, match="no persisted serving state"):
        ServeEngine.adopt(backend, DeploymentStore(str(tmp_path)))
