"""The port's grouped expert matmul and MoE layer against the JAX package's,
on the CPU.

The same numpy-seeded tokens, routing and weights go through the JAX
package's op (its Pallas ``gmm`` in interpret mode, as its own tests run
it), its ``sort_by_expert``, ``gmm_tiled_ref`` and ``_dispatch_combine``,
and through the port's counterparts, whose public op runs the plain version
of the CUDA kernel for a CPU tensor.  The tolerance is the reference's own
(``tests/test_kernels.py``): rtol and atol 1e-5.  The CUDA kernel itself is
held against the plain version on the card by ``test_torch_gpu.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.moe_gmm import ops as jops, ref as jref
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts
from repro_torch.kernels.moe_gmm import ops, ref
from repro_torch.models import moe

TOL = 1e-5
CASES = [(64, 16, 32, 4, 16), (200, 32, 64, 8, 16), (33, 8, 16, 2, 8)]


def _inputs(T, D, F, E, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    eo = rng.integers(0, E, T).astype(np.int32)
    w = (rng.normal(size=(E, D, F)) * scale).astype(np.float32)
    return x, eo, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------
# the op and its plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T,D,F,E,tile", CASES)
def test_moe_apply_matches_jax_pallas(T, D, F, E, tile):
    x, eo, w = _inputs(T, D, F, E)
    want = jops.moe_apply(jnp.asarray(x), jnp.asarray(eo), jnp.asarray(w),
                          tile_m=tile, tile_f=16, interpret=True)
    got = ops.moe_apply(*_t(x, eo, w), tile_m=tile)
    assert got.shape == (T, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_moe_apply_skewed_routing_matches_jax():
    """All tokens to one expert (the worst case of the padding)."""
    x, _, w = _inputs(32, 8, 16, 4, seed=1, scale=1.0)
    eo = np.full((32,), 2, np.int32)
    want = jops.moe_apply(jnp.asarray(x), jnp.asarray(eo), jnp.asarray(w),
                          tile_m=8, tile_f=16, interpret=True)
    got = ops.moe_apply(*_t(x, eo, w), tile_m=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), x @ w[2], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,D,F,E,tile", CASES + [(32, 8, 16, 4, 8)])
def test_sort_by_expert_equals_jax(T, D, F, E, tile):
    """Padded x, tile_expert, order, slot and the valid mask are the JAX
    package's exactly; tile_rows counts the valid rows of each tile."""
    x, eo, _ = _inputs(T, D, F, E, seed=T)
    if T == 32:
        eo[:] = 2  # skewed: one group, every other expert empty
    jx, jte, (jorder, jslot), jvalid = jops.sort_by_expert(
        jnp.asarray(x), jnp.asarray(eo), E, tile)
    x_p, te, (order, slot), valid, tile_rows = ops.sort_by_expert(
        *_t(x, eo), E, tile)
    np.testing.assert_array_equal(x_p.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert te.dtype == tile_rows.dtype == torch.int32
    np.testing.assert_array_equal(
        tile_rows.numpy(), valid.reshape(-1, tile).sum(1).numpy())
    # the valid rows of every tile sit at its head
    assert all(bool(row[:n].all()) and not bool(row[n:].any())
               for row, n in zip(valid.reshape(-1, tile), tile_rows.tolist()))


@pytest.mark.parametrize("T,D,F,E,tile", CASES)
def test_gmm_tiled_ref_matches_jax(T, D, F, E, tile):
    x, eo, w = _inputs(T, D, F, E, seed=2)
    jx, jte, _, _ = jops.sort_by_expert(jnp.asarray(x), jnp.asarray(eo), E,
                                        tile)
    want = jref.gmm_tiled_ref(jx, jte, jnp.asarray(w), tile)
    x_p, te, _, _, _ = ops.sort_by_expert(*_t(x, eo), E, tile)
    got = ref.gmm_tiled_ref(x_p, te, torch.from_numpy(w), tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("T,D,F,E,tile", CASES)
def test_padded_pipeline_equals_oracle(T, D, F, E, tile):
    """The kernel's route on the CPU: sort and pad, the tile contract, then
    the unsort's gather of the token rows, equals the oracle ``ref.gmm``
    (and the JAX oracle)."""
    x, eo, w = _inputs(T, D, F, E, seed=3)
    x_p, te, (order, slot), _, _ = ops.sort_by_expert(*_t(x, eo), E, tile)
    y_p = ref.gmm_tiled_ref(x_p, te, torch.from_numpy(w), tile)
    y = torch.empty((T, F)).index_copy_(0, order, y_p[slot])
    want = ref.gmm(*_t(x, eo, w))
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(jref.gmm(*map(jnp.asarray, (x, eo, w)))),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,D,F,E,tile", CASES)
def test_kernel_branch_routing_equals_oracle(T, D, F, E, tile):
    """The CUDA branch's routing on CPU tensors, with the tiled contract
    standing in for the launch: valid padded row i reads x's row
    ``row_src[i]`` and writes y's; the padding rows are neither read nor
    written (their ``row_src`` is never set), and every token's row of y is
    written once, with the oracle's numbers."""
    x, eo, w = _inputs(T, D, F, E)
    xt, et, wt = _t(x, eo, w)
    seen = []

    def launch(x_, tile_expert, tile_rows, row_src, w_, y, tile_m):
        valid = (torch.arange(row_src.shape[0]) % tile_m
                 < tile_rows.long().repeat_interleave(tile_m))
        src = row_src.long()[valid]
        seen.append(src)
        x_p = torch.full((row_src.shape[0], x_.shape[1]), float("nan"))
        x_p[valid] = x_[src]
        full = ref.gmm_tiled_ref(x_p, tile_expert, w_, tile_m)
        y.fill_(float("nan"))
        y[src] = full[valid]

    got = ops._routed_product(xt, et, wt, tile, launch)
    assert sorted(seen[0].tolist()) == list(range(T))  # each token once
    np.testing.assert_allclose(got.numpy(), ref.gmm(xt, et, wt).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,D,F,E,tile", CASES)
def test_moe_apply_rows_of_no_local_expert(T, D, F, E, tile):
    """A row whose expert is ≥ E (an expert another rank of the mesh
    holds) gives a zero row of y and zero gradients; the other rows equal
    the JAX package's Pallas op on them alone, and so do the gradients of
    their x rows and of w (through the op's plain version, the backward
    that the card's op recomputes)."""
    x, eo, w = _inputs(T, D, F, 2 * E, seed=1)  # half the ids are ≥ E
    w = w[:E]
    mine = eo < E
    xt, et, wt = (t.requires_grad_(t.is_floating_point())
                  for t in _t(x, eo, w))
    got = ops.moe_apply(xt, et, wt, tile_m=tile)
    assert 0 < int(mine.sum()) < T
    assert torch.equal(got[torch.from_numpy(~mine)], torch.zeros(
        (int((~mine).sum()), F)))
    want = jops.moe_apply(jnp.asarray(x[mine]), jnp.asarray(eo[mine]),
                          jnp.asarray(w), tile_m=tile, tile_f=16,
                          interpret=True)
    np.testing.assert_allclose(got[torch.from_numpy(mine)].detach().numpy(),
                               np.asarray(want), rtol=TOL, atol=TOL)
    cot = np.random.default_rng(2).normal(size=(T, F)).astype(np.float32)
    gx, gw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(cot))
    assert not gx[torch.from_numpy(~mine)].any()
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(
        jref.gmm(a, jnp.asarray(eo[mine]), b) * cot[mine]), (0, 1))(
        jnp.asarray(x[mine]), jnp.asarray(w))
    np.testing.assert_allclose(gx[torch.from_numpy(mine)].numpy(),
                               np.asarray(jgx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("T,D,F,E,tile", CASES)
def test_kernel_branch_skips_rows_of_no_local_expert(T, D, F, E, tile):
    """The CUDA branch's routing of ids ≥ E on CPU tensors, with a
    stand-in launch that does what the kernel does: a tile whose expert is
    ≥ E is skipped and writes nothing.  Those rows come back 0 (y starts
    zeroed), every other row as the oracle gives it."""
    x, eo, w = _inputs(T, D, F, 2 * E, seed=3)
    xt, et, wt = _t(x, eo, w[:E])
    skipped = []

    def launch(x_, tile_expert, tile_rows, row_src, w_, y, tile_m):
        for t, (e, n) in enumerate(zip(tile_expert.tolist(),
                                       tile_rows.tolist())):
            if n <= 0 or e >= w_.shape[0]:  # the kernel's early returns
                skipped.append(n)
                continue
            src = row_src[t * tile_m:t * tile_m + n].long()
            y[src] = (x_[src].float() @ w_[e].float()).to(y.dtype)

    got = ops._routed_product(xt, et, wt, tile, launch)
    assert sum(skipped) == int((et >= E).sum()) > 0
    assert not got[et >= E].any()
    np.testing.assert_allclose(got.numpy(), ref.gmm(xt, et, wt).numpy(),
                               rtol=TOL, atol=TOL)


def test_gmm_rounds_weights_to_x_dtype():
    """bf16 tokens with f32 weights give the numbers of casting the
    weights to bf16 first (what the kernel does in registers)."""
    x, eo, w = _inputs(40, 16, 24, 3, seed=4, scale=1.0)
    xb, eo_t, w_t = torch.from_numpy(x).bfloat16(), *_t(eo, w)
    got = ops.moe_apply(xb, eo_t, w_t)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.gmm(xb, eo_t, w_t.bfloat16()))
    # and each row is its expert's f32 product, rounded once
    want = torch.stack([(xb[i].float() @ w_t[e].bfloat16().float())
                        for i, e in enumerate(eo.tolist())]).bfloat16()
    assert torch.equal(got, want)


def test_moe_apply_checks_its_inputs():
    x, eo, w = _t(*_inputs(8, 4, 6, 2))
    with pytest.raises(ValueError, match="required"):
        ops.moe_apply(x, eo, w[:, :3])
    with pytest.raises(TypeError, match="integer"):
        ops.moe_apply(x, eo.float(), w)
    assert "moe_gmm" in launch_counts()


# --------------------------------------------------------------------------
# the MoE layer's pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [4.0, 1.25, 0.5])
def test_dispatch_combine_matches_jax(cf):
    """Dispatch, combine, the kept gates and the aux loss; below the
    reduced configs' capacity factor 4 choices are dropped (positions
    ≥ C)."""
    rng = np.random.default_rng(5)
    B, S, E, k = 2, 12, 4, 2
    logits = rng.normal(size=(B, S, E)).astype(np.float32) * 2
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    C = max(int(np.ceil(S * k / E * cf)), k)
    want = jmoe._dispatch_combine(jnp.asarray(probs), k, C)
    got = moe._dispatch_combine(torch.from_numpy(probs), k, C)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-6)
    dropped = B * S * k - float(got[0].sum())
    assert dropped == 0 if cf == 4.0 else dropped > 0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("ragged", [False, True])
def test_moe_layer_matches_jax(arch, ragged):
    """One reduced MoE layer (router, experts, shared experts), both paths:
    y and aux within 1e-5, on the JAX package's weights."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               moe_ragged=ragged, use_pallas=True)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              moe_ragged=ragged)
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    p = torch.utils._pytree.tree_map(
        lambda a: torch.from_numpy(np.array(a)),
        jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(6).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)


def test_moe_init_tree_matches_jax():
    """Key paths, shapes and dtypes of the port's MoE parameters (the
    router stays f32 under bf16 weights)."""
    import ml_dtypes
    cfg = get_config("deepseek-moe-16b", reduced=True)
    jcfg = jget_config("deepseek-moe-16b", reduced=True)
    flat = torch.utils._pytree.tree_flatten_with_path
    ours = moe.moe_init(torch.Generator().manual_seed(0), cfg,
                        torch.bfloat16, stack=3)
    theirs = jax.vmap(lambda k: jmoe.moe_init(k, jcfg, jnp.bfloat16))(
        jax.random.split(jax.random.PRNGKey(0), 3))
    got = {torch.utils._pytree.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
           for k, v in flat(ours)[0]}
    want = {torch.utils._pytree.keystr(k): (
        tuple(v.shape), "bfloat16" if v.dtype == ml_dtypes.bfloat16
        else np.dtype(v.dtype).name)
        for k, v in flat(jax.tree_util.tree_map(np.asarray, theirs))[0]}
    assert got == want


def test_capacity_matches_jax():
    for arch in ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"):
        for reduced in (False, True):
            m, jm = (get_config(arch, reduced=reduced).moe,
                     jget_config(arch, reduced=reduced).moe)
            for S in (1, 7, 2048):
                assert moe.capacity(m, S) == jmoe.capacity(jm, S)


@pytest.mark.parametrize("arch,n_params", [
    ("deepseek-moe-16b", 16_375_728_128),         # 61.0 GiB f32, 30.5 bf16
    ("phi3.5-moe-42b-a6.6b", 41_872_527_360)])    # 156.0 GiB f32, 78.0 bf16
def test_full_width_moe_parameter_counts(arch, n_params):
    """The full-width parameter trees, counted without allocating them
    (fake tensors; ``jax.eval_shape``), agree: deepseek-moe-16b's f32
    weights fit one 80 GB card, phi3.5-moe's do not, in f32 or bf16 beside
    any activations."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro.models import Model as JModel
    from repro_torch.models import Model
    with FakeTensorMode():
        model = Model(get_config(arch))
        ours = model.param_count(model.init(device="cpu"))
    shapes = jax.eval_shape(JModel(jget_config(arch)).init,
                            jax.random.PRNGKey(0))
    theirs = sum(int(np.prod(s.shape))
                 for s in jax.tree_util.tree_leaves(shapes))
    assert ours == theirs == n_params
    fits = n_params * 4 < 80e9
    assert fits == (arch == "deepseek-moe-16b")
