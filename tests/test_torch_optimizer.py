"""The port's optimizer against the JAX package's, on the CPU.

The reference's ``TestOptimizer`` cases run on the port, then three AdamW
updates (clipped, cosine schedule) from the same numpy-seeded parameters,
gradients and state go through both packages; the JAX state crosses with
``params_from_numpy`` (its 0-d int32 ``step`` included).  Float32 all
through: parameters and moments must agree within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.train import optimizer as jopt
from repro_torch.interop import params_from_numpy
from repro_torch.train import AdamW, cosine_warmup
from repro_torch.train.optimizer import (clip_by_global_norm, global_norm,
                                         linear_warmup)


class TestOptimizer:
    def test_quadratic_convergence(self):
        opt = AdamW(lr=0.1, weight_decay=0.0)
        params = {"w": torch.tensor([5.0, -3.0])}
        state = opt.init(params)
        for _ in range(200):
            w = params["w"].clone().requires_grad_()
            (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
            params, state, _ = opt.update({"w": g}, state, params)
        assert float(params["w"].abs().max()) < 1e-2

    def test_clip_by_global_norm(self):
        tree = {"a": torch.ones(4) * 10.0}
        clipped, norm = clip_by_global_norm(tree, 1.0)
        assert float(norm) == pytest.approx(20.0)
        assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)

    def test_cosine_warmup_shape(self):
        lr = cosine_warmup(1.0, warmup=10, total=100)
        assert float(lr(0)) == 0.0
        assert float(lr(10)) == pytest.approx(1.0)
        assert float(lr(100)) == pytest.approx(0.1, rel=1e-2)
        assert float(lr(55)) < float(lr(20))


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 130])
def test_schedules_equal_the_references(step):
    ours = [cosine_warmup(3e-3, 5, 100)(torch.tensor(step, dtype=torch.int32)),
            linear_warmup(1e-2, 7)(step)]
    theirs = [jopt.cosine_warmup(3e-3, 5, 100)(jnp.int32(step)),
              jopt.linear_warmup(1e-2, 7)(step)]
    for o, t in zip(ours, theirs):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(float(o), float(t), rtol=1e-6)


def _tree(rng):
    return {"embed": rng.normal(size=(16, 8)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(3, 8, 8)).astype(np.float32),
                        "b": rng.normal(size=(3, 8)).astype(np.float32)}],
            "norm": {"scale": np.ones(8, np.float32)}}


@pytest.mark.parametrize("clip", [1.0, None], ids=["clipped", "unclipped"])
def test_adamw_updates_equal_the_references(clip):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [jax.tree_util.tree_map(lambda x: x * s, _tree(rng))
             for s in (0.5, 3.0, 0.01)]
    jo = jopt.AdamW(lr=jopt.cosine_warmup(3e-2, 1, 10), clip_norm=clip)
    o = AdamW(lr=cosine_warmup(3e-2, 1, 10), clip_norm=clip)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init(jp)
    like = pytree.tree_map(torch.from_numpy, params)
    p = params_from_numpy(params, "cpu", like=like)
    s = params_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu",
                          like=o.init(like))
    assert s["step"].shape == () and s["step"].dtype == torch.int32
    for g in grads:
        jp, js, jstats = jo.update(
            jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        gt = params_from_numpy(g, "cpu", like=like)
        p, s, stats = o.update(gt, s, p)
        ours = {"params": p, "m": s["m"], "v": s["v"]}
        theirs = params_from_numpy(
            jax.tree_util.tree_map(np.asarray,
                                   {"params": jp, "m": js["m"],
                                    "v": js["v"]}),
            "cpu", like=ours)
        for a, b in zip(pytree.tree_leaves(ours), pytree.tree_leaves(theirs)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        assert int(s["step"]) == int(js["step"])
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(stats["lr"]), float(jstats["lr"]),
                                   rtol=1e-6)


def test_update_writes_nothing_into_its_inputs():
    """The reference is pure, so two steps may start from one state."""
    rng = np.random.default_rng(1)
    like = pytree.tree_map(torch.from_numpy, _tree(rng))
    params = pytree.tree_map(torch.clone, like)
    grads = pytree.tree_map(lambda x: x * 2.0, like)
    opt = AdamW(lr=1e-2)
    state = opt.update(grads, opt.init(params), params)[1]
    snap = [t.clone() for t in pytree.tree_leaves((params, grads, state))]
    a = opt.update(grads, state, params)
    b = opt.update(grads, state, params)
    for x, y in zip(pytree.tree_leaves((params, grads, state)), snap):
        assert torch.equal(x, y)
    for x, y in zip(pytree.tree_leaves(a[:2]), pytree.tree_leaves(b[:2])):
        assert torch.equal(x, y)


def _model_tree(arch, rng):
    """A reduced arch's parameter tree (the port's seed-0 draw) and a
    numpy-seeded gradient tree of its shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    params = Model(get_config(arch, reduced=True)).init(seed=0, device="cpu")
    grads = pytree.tree_map(
        lambda x: torch.from_numpy(rng.normal(size=x.shape).astype(
            np.float32)), params)
    return params, grads


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
@pytest.mark.parametrize("clip", [1.0, None], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_donating_update_equals_update_bit_for_bit(arch, clip, chunk,
                                                   monkeypatch):
    """Three updates of a reduced arch's tree (gradient scales 0.5, 30 and
    0.01: clipped hard, then not at all): ``update_`` gives ``update``'s
    parameters, moments, step and stats bit for bit, whether a leaf is
    taken whole or in chunks of 64 elements along its leading axis."""
    from repro_torch.train import optimizer
    if chunk is not None:
        monkeypatch.setattr(optimizer, "CHUNK_ELEMS", chunk)
    rng = np.random.default_rng(2)
    params, grads = _model_tree(arch, rng)
    opt = AdamW(lr=cosine_warmup(3e-2, 1, 10), clip_norm=clip)
    state = opt.init(params)
    p2, s2 = pytree.tree_map(torch.clone, (params, state))
    for s in (0.5, 30.0, 0.01):
        g = pytree.tree_map(lambda x: x * s, grads)
        params, state, stats = opt.update(g, state, params)
        p2, s2, stats2 = opt.update_(pytree.tree_map(torch.clone, g), s2,
                                     p2)
        for a, b in zip(pytree.tree_leaves((params, state)),
                        pytree.tree_leaves((p2, s2))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for k in stats:
            assert torch.equal(stats[k], stats2[k]), k


def test_donating_update_writes_into_its_trees():
    """``update_`` returns its own trees with the new values in the same
    storage, and empties a list of gradients as it applies them."""
    rng = np.random.default_rng(3)
    params, grads = _model_tree("mamba2-2.7b", rng)
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    ptrs = [t.data_ptr() for t in
            pytree.tree_leaves((params, state["m"], state["v"]))]
    want = opt.update(grads, state, params)
    glist = pytree.tree_leaves(pytree.tree_map(torch.clone, grads))
    got = opt.update_(glist, state, params)
    assert got[0] is params and got[1]["m"] is state["m"]
    assert got[1]["v"] is state["v"] and int(got[1]["step"]) == 1
    assert ptrs == [t.data_ptr() for t in
                    pytree.tree_leaves((params, state["m"], state["v"]))]
    assert glist == [None] * len(glist)
    for a, b in zip(pytree.tree_leaves(want[:2]), pytree.tree_leaves(got[:2])):
        assert torch.equal(a, b)
