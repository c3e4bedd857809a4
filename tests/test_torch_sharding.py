"""The port's sharding rules against the JAX package's, entry for entry.

For every arch at full width (the port's trees as fake tensors, the JAX
package's through ``eval_shape``), every mesh and every rule set of
``tests/test_sharding.py``, ``param_specs`` gives the same spec at the
same key path; so do ``cache_specs`` for the four archs and two shapes
there, and the ``batch_specs`` fallback.  The derivation reads only
``mesh.shape``, so the meshes are shapes without a world."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import pytest
import torch.utils._pytree as pytree
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JARCHS, get_config as jget_config
from repro.models import Model as JModel
from repro.parallel import sharding as jsh
from repro.parallel.axes import ShardingRules as JRules
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.axes import ShardingRules

SHAPES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((4,), ("stage",))]


class _FakeMesh:
    """The JAX side's mesh stand-in: only .shape is consulted."""

    def __init__(self, shape: dict):
        self.shape = shape


def _rules(cls):
    return [
        cls(),
        cls(seq="model"),
        cls(d="data"),  # fsdp
        cls(heads=None, ff=None, d=("data", "model"),
            batch=("pod", "data", "model")),  # flattened pure DP
        cls(kv_seq="model"),  # serve
    ]


def _meshes(i):
    shape, axes = SHAPES[i]
    return make_mesh(shape, axes, device="cpu"), _FakeMesh(dict(zip(axes, shape)))


def _names(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {_names(p): tuple(s) for p, s in flat}


def _port_specs(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tsh.P))
    return {_names(p): tuple(s) for p, s in flat}


@functools.cache
def _param_trees(arch):
    with FakeTensorMode():
        ours = Model(get_config(arch)).init(device="cpu")
    theirs = jax.eval_shape(JModel(jget_config(arch)).init,
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return ours, theirs


def test_the_archs_are_the_references():
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh_i", range(len(SHAPES)))
@pytest.mark.parametrize("rules_i", range(5))
def test_param_specs_equal_the_references(arch, mesh_i, rules_i):
    ours, theirs = _param_trees(arch)
    mesh, jmesh = _meshes(mesh_i)
    got = _port_specs(tsh.param_specs(ours, mesh, _rules(ShardingRules)[rules_i]))
    want = _jax_specs(jsh.param_specs(theirs, jmesh, _rules(JRules)[rules_i]))
    assert got == want
    if SHAPES[mesh_i][1] == ("stage",):  # no param axis there: replicated
        assert all(all(a is None for a in s) for s in got.values())


@pytest.mark.parametrize("arch", ["yi-34b", "mamba2-2.7b", "zamba2-1.2b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("batch,seqlen", [(128, 1024), (1, 4096)])
def test_cache_specs_equal_the_references(arch, batch, seqlen):
    with FakeTensorMode():
        ours = Model(get_config(arch)).init_cache(batch, seqlen, device="cpu")
    jm = JModel(jget_config(arch))
    theirs = jax.eval_shape(lambda: jm.init_cache(batch, seqlen))
    for i in range(len(SHAPES)):
        mesh, jmesh = _meshes(i)
        for r, jr in zip(_rules(ShardingRules), _rules(JRules)):
            got = _port_specs(tsh.cache_specs(ours, mesh, r))
            assert got == _jax_specs(jsh.cache_specs(theirs, jmesh, jr))


@pytest.mark.parametrize("lead", [10, 32])
def test_batch_specs_fallback_on_indivisible(lead):
    """10 rows do not split over 16 ranks (replicated, as in JAX); 32 do."""
    mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
    with FakeTensorMode():
        import torch
        batch = {"tokens": torch.empty((lead, 64), dtype=torch.int32)}
    got = tsh.batch_specs(batch, mesh, ShardingRules())
    want = jsh.batch_specs(
        {"tokens": jax.ShapeDtypeStruct((lead, 64), jnp.int32)},
        _FakeMesh({"data": 16, "model": 16}), JRules())
    assert tuple(got["tokens"]) == tuple(want["tokens"])
    assert got["tokens"] == (tsh.P() if lead == 10 else tsh.P("data", None))


@pytest.mark.parametrize("multi_pod,axes,size", [
    (False, ("data", "model"), 256), (True, ("pod", "data", "model"), 512)])
def test_production_mesh_axes_without_a_world(multi_pod, axes, size):
    """The reference's ``test_multipod_mesh_axes``: the production mesh's
    axes and size, with no world of its ranks; running over it raises and
    names the world it needs."""
    m = make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert m.axis_names == axes and m.size == size
    assert list(m.shape) == list(axes)
    with pytest.raises(RuntimeError, match=f"world of {size} ranks"):
        m.device_mesh()
