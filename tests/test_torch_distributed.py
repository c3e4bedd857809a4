"""The port's multi-device code, on the CPU, against one device and the
JAX package's multi-device results.

The port runs SPMD: each world of ranks (one thread a rank) is spawned
once per size by ``repro_torch.launch.mesh.run_world``, in a
module-scoped fixture that runs every check of that size
(``tests/_torch_dist_worlds.py``) and returns the results; each check is
then its own test.  The worlds run the card's ``hoststaged`` backend with
every tensor staged through its host buffers (``AlwaysStaged``), so its
copies are checked here; the launcher's world runs plain gloo.  The JAX package's multi-device outputs come from one
subprocess with 4 fake XLA devices (as ``tests/test_distributed.py`` runs
them), started first and read last, over the same numpy-seeded inputs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import _torch_dist_worlds as worlds
from repro_torch.launch.mesh import run_world

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")

_JAX_PROG = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{src!r}, {here!r}]
import jax, jax.numpy as jnp, numpy as np
import _torch_dist_worlds as worlds
from _torch_loss_pairs import pair
import repro.core as jcore
from repro.core.engine import Stencil
from repro.data import SyntheticLM
from repro.launch.mesh import make_mesh, train_rules
from repro.parallel import sharding as shlib
from repro.parallel.axes import shard_ctx
from repro.parallel.pipeline import pipeline_forward, split_stages
from repro_torch import workloads
out = {{}}

# GPipe over 4 stages
ws, x = worlds.pipeline_inputs()
def block_fn(lp, h):
    h, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), h, lp)
    return h
out["pipeline"] = np.asarray(pipeline_forward(
    block_fn, split_stages(jnp.asarray(ws), 4), jnp.asarray(x),
    mesh=make_mesh((4,), ("stage",)), n_stages=4, n_micro=4))

# EDGE5 with halos over 4 devices
mesh = make_mesh((4,), ("data",))
st = Stencil(kernel=jnp.asarray(workloads.EDGE5), axis="data", nodes=4)
out["edge5"] = np.stack([np.asarray(st.apply(jnp.asarray(g), mesh))
                         for g in worlds.grey_images()])

# Jacobi with its partitions over 4 devices
systems, _ = workloads.jacobi_systems(2, 64)
def partition(state, lo, size):
    return {{"A": jcore.rows(state["A"], lo, size),
             "b": jcore.rows(state["b"], lo, size),
             "x": state["x"], "lo": lo, "size": size}}
def calculation(part):
    idx = part["lo"] + jnp.arange(part["size"])
    diag = jax.vmap(lambda r, j: r[j])(part["A"], idx)
    return (part["b"] - part["A"] @ part["x"]
            + diag * jcore.rows(part["x"], part["lo"], part["size"])) / diag
net = jcore.Network("jacobi")
net.add(
    jcore.Emit(lambda i: {{k: jnp.asarray(v) for k, v in systems[i].items()}},
               name="emit"),
    jcore.MultiCoreEngine(
        nodes=4, n_rows=64, partitionMethod=partition,
        calculationMethod=calculation,
        updateMethod=lambda st, x: {{**st, "x": x}},
        errorMethod=lambda st, x: jnp.max(jnp.abs(x - st["x"])),
        tol=1e-6, axis="data", name="mcEngine"),
    jcore.Collect(lambda acc, st: acc + [np.asarray(st["x"])], init=[],
                  name="collector"))
out["jacobi"] = np.stack(jcore.build(net, mesh=mesh).run(
    instances=2)["collector"])

# reduced qwen2 and gemma (K = 1: its KV heads replicated), the port's
# seed-0 weights, loss and grads on (2, 2)
mesh = make_mesh((2, 2), ("data", "model"))
rules = train_rules()
for arch, pre in (("qwen2-0.5b", ""), ("gemma-2b", "gemma:"),
                  *((a, a + ":") for a in worlds.FAMILY_ARCHS)):
    jm, jp, _, _ = pair(arch)
    batch = SyntheticLM(batch=8, seq=16, vocab=jm.cfg.vocab).create(0)
    sh = shlib.to_shardings(shlib.param_specs(jp, mesh, rules), mesh)
    bsh = shlib.to_shardings(shlib.batch_specs(batch, mesh, rules), mesh)
    with shard_ctx(mesh, rules):
        (loss, _), grads = jax.jit(
            jax.value_and_grad(jm.loss_fn, has_aux=True),
            in_shardings=(sh, bsh))(
            jax.tree_util.tree_map(jax.device_put, jp, sh),
            jax.tree_util.tree_map(jax.device_put, batch, bsh))
    out[pre + "loss"] = np.asarray(loss)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    for path, g in flat:
        out[pre + "grad:" + "/".join(
            str(getattr(k, "key", getattr(k, "idx", k)))
            for k in path)] = np.asarray(g)

# attention with q's heads over a 4-way model axis and k, v replicated
from jax.sharding import NamedSharding, PartitionSpec
from repro.kernels.flash_attention import ref as jref
mesh = make_mesh((4,), ("model",))
heads = NamedSharding(mesh, PartitionSpec(None, "model"))
whole = NamedSharding(mesh, PartitionSpec())
for i, (H, K, causal) in enumerate(worlds.MHA_CASES):
    q, k, v, w = worlds.mha_inputs(H, K)
    attn = lambda q, k, v: jref.mha(q, k, v, causal=causal)
    loss = lambda q, k, v: jnp.sum(attn(q, k, v) * w)
    shard = dict(in_shardings=(heads, whole, whole))
    got = [jax.jit(attn, **shard)(q, k, v),
           *jax.jit(jax.grad(loss, (0, 1, 2)), **shard)(q, k, v)]
    for name, a in zip(("o", "dq", "dk", "dv"), got):
        out[f"mha{{i}}:{{name}}"] = np.asarray(a)

# decode on (1, 4) under serve_rules(): the caches placed by cache_specs
# (their positions over the model axis), prefill then single steps
from repro.launch.mesh import serve_rules
mesh = make_mesh((1, 4), ("data", "model"))
rules = serve_rules()
for arch in worlds.SERVE_ARCHS:
    jm, jp, _, _ = pair(arch)
    cache = jm.init_cache(2, worlds.SERVE_LEN)
    sh = shlib.to_shardings(shlib.param_specs(jp, mesh, rules), mesh)
    csh = shlib.to_shardings(shlib.cache_specs(cache, mesh, rules), mesh)
    jp = jax.tree_util.tree_map(jax.device_put, jp, sh)
    cache = jax.tree_util.tree_map(jax.device_put, cache, csh)
    with shard_ctx(mesh, rules):
        step = jax.jit(jm.decode_step)
        for i, tok in enumerate(worlds.serve_tokens(jm.cfg.vocab)):
            logits, cache = step(jp, cache, jnp.asarray(tok))
            out[f"serve:{{arch}}:{{i}}"] = np.asarray(logits)
np.savez({npz!r}, **out)
"""


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dist")


@pytest.fixture(scope="module")
def jax_run(tmp_dir):
    """The JAX package's outputs: its subprocess starts first and runs
    beside the port's worlds."""
    npz = str(tmp_dir / "jax.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_PROG).format(
            src=_SRC, here=_HERE, npz=npz)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result():
        if not hasattr(result, "data"):
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            result.data = dict(np.load(npz))
        return result.data

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def w8(tmp_dir, jax_run):
    return run_world(worlds.world8, 8, str(tmp_dir / "ckpt"),
                     device="cpu", backend=worlds.STAGED)


@pytest.fixture(scope="module")
def w4(tmp_dir, w8):
    return run_world(worlds.world4, 4, str(tmp_dir / "ckpt"),
                     device="cpu", backend=worlds.STAGED)


def _leaf_paths(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): v for p, v in flat}


# -- collectives ------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [((8, 1024), 256), ((3, 512), 128),
                                         ((1024,), 256)])
def test_quantize_int8_bit_exact_against_jax(shape, block):
    import jax.numpy as jnp
    from repro.parallel import collectives as jcol
    from repro_torch.parallel import collectives as tcol
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 0.01).astype(np.float32)
    x.reshape(-1)[:block] = 0.0  # an all-zero block: the 1e-12 floor
    q, s = tcol.quantize_int8(torch.from_numpy(x), block)
    jq, js = jcol.quantize_int8(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcol.dequantize_int8(q, s).numpy(),
        np.asarray(jcol.dequantize_int8(jq, js)))


def test_int8_ring_allreduce_and_error_feedback(w8):
    """The reference's two gates over 8 ranks, on every rank (a rank
    keeps its own reduced chunk unquantised, so the ranks' results differ
    by one quantisation)."""
    for r in w8:
        assert r["ring_rel1"] < 0.05
        assert r["ring_rel2"] < r["ring_rel1"]


def test_combine_psum_and_its_bf16_payload(w8):
    """The sum over 8 ranks, the same on each; the bf16 all-reduce sums
    the values rounded to bf16 and comes back in f32."""
    x = [torch.full((3,), 1.0 + r / 3) for r in range(8)]
    want = sum(x)
    want16 = sum(v.to(torch.bfloat16) for v in x)
    for r in w8:
        f32, bf16 = r["psum"]
        torch.testing.assert_close(f32, want)
        assert bf16.dtype == torch.float32
        # the order of gloo's bf16 sum may differ: one bf16 step at 16-32
        torch.testing.assert_close(bf16, want16.float(), atol=0.125, rtol=0)


def test_pipeline_parallel_exact(w4):
    assert all(r["pipeline_err"] == 0.0 for r in w4)


def test_pipeline_parallel_against_jax(w4, jax_run):
    np.testing.assert_allclose(w4[0]["pipeline"].numpy(),
                               jax_run()["pipeline"], atol=1e-6, rtol=0)


# -- networks and engines on a mesh --------------------------------------------

def test_compiled_farm_over_the_mesh(w4):
    """The reference's ``test_compiled_farm_uses_devices``: the exact sum
    of squares of 0..63, fused and streaming, on every rank."""
    want = float(sum(i * i for i in range(64)))
    for r in w4:
        assert r["farm_sum"] == r["farm_sum_streaming"] == want


def test_mandelbrot_farm_over_the_mesh_equals_one_device(w4):
    assert all(r["mandelbrot_equal"] for r in w4)


def test_image_pipeline_over_the_mesh_equals_one_device(w4):
    assert all(r["pipeline_equal"] for r in w4)


def test_jacobi_over_the_mesh_equals_one_device(w4):
    assert all(r["jacobi_equal"] for r in w4)


def test_jacobi_over_the_mesh_against_jax(w4, jax_run):
    """Within the slice's Jacobi tolerance of JAX's ``shard_map`` run (the
    two packages' matrix products sum in different orders)."""
    assert np.max(np.abs(w4[0]["jacobi"] - jax_run()["jacobi"])) < 1e-5


def test_stencil_halos_equal_one_device(w4):
    """EDGE5, k = 1 (no halo) and k = 3, every rank's block with its
    neighbours' rows, zeros at the first and last ranks."""
    assert all(r["stencil_equal"] for r in w4)


def test_edge5_over_the_mesh_bit_identical_to_jax(w4, jax_run):
    np.testing.assert_array_equal(w4[0]["edge5"].numpy(), jax_run()["edge5"])


# -- the model on a (2, 2) mesh -------------------------------------------------

def test_mesh_numerical_invariance(w4):
    """The reference's gate: the (2, 2) loss within 1e-4 of one device,
    and every gradient leaf too."""
    for r in w4:
        assert abs(r["loss_mesh"] - r["loss_one"]) < 1e-4
        assert r["grad_err"] < 1e-4


def test_mesh_loss_and_grads_against_jax(w4, jax_run):
    ref = jax_run()
    assert abs(w4[0]["loss_mesh"] - float(ref["loss"])) < 1e-4
    ours = _leaf_paths(w4[0]["grads"])
    assert set(ours) == {k[5:] for k in ref if k.startswith("grad:")}
    for path, g in ours.items():
        np.testing.assert_allclose(g.numpy(), ref["grad:" + path],
                                   atol=1e-4, rtol=0, err_msg=path)


def test_mesh_invariance_with_kv_heads_replicated(w4):
    """Reduced gemma-2b (K = 1, which the 2-way model axis does not
    divide: each rank takes its query groups' KV head) under the same
    gate."""
    for r in w4:
        g = r["gemma"]
        assert abs(g["loss_mesh"] - g["loss_one"]) < 1e-4
        assert g["grad_err"] < 1e-4


def test_mesh_loss_and_grads_against_jax_kv_heads_replicated(w4, jax_run):
    ref, got = jax_run(), w4[0]["gemma"]
    assert abs(got["loss_mesh"] - float(ref["gemma:loss"])) < 1e-4
    ours = _leaf_paths(got["grads"])
    assert set(ours) == {k[11:] for k in ref if k.startswith("gemma:grad:")}
    for path, g in ours.items():
        np.testing.assert_allclose(g.numpy(), ref["gemma:grad:" + path],
                                   atol=1e-4, rtol=0, err_msg=path)


@pytest.mark.parametrize("arch", worlds.FAMILY_ARCHS)
def test_family_mesh_invariance(w4, arch):
    """The MoE (capacity and ragged paths; the ragged one also with its
    experts whole on every rank), SSM, hybrid, encoder-decoder and VLM
    families on (2, 2) under the reference's gate: the loss within 1e-4
    of one device, and every gradient leaf too."""
    for r in w4:
        got = r[arch]
        assert abs(got["loss_mesh"] - got["loss_one"]) < 1e-4
        assert got["grad_err"] < 1e-4


@pytest.mark.parametrize("arch", worlds.FAMILY_ARCHS)
def test_family_loss_and_grads_against_jax(w4, jax_run, arch):
    ref, got = jax_run(), w4[0][arch]
    assert abs(got["loss_mesh"] - float(ref[arch + ":loss"])) < 1e-4
    pre = arch + ":grad:"
    ours = _leaf_paths(got["grads"])
    assert set(ours) == {k[len(pre):] for k in ref if k.startswith(pre)}
    for path, g in ours.items():
        np.testing.assert_allclose(g.numpy(), ref[pre + path], atol=1e-4,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("arch", worlds.SERVE_ARCHS)
def test_sharded_decode_equals_one_device(w4, arch):
    """Prefill and 4 decode steps on (1, 4) with the caches' positions
    split over the model axis (serve_rules' kv_seq: each rank writes and
    scores its own block, flash-decoding over the ranks), and the MoE's
    experts split over it on both paths: the f32 logits within 1e-5 of one
    device on every rank."""
    for r in w4:
        got = r["serve"][arch]
        assert got["positions_split"] and got["err"] < 1e-5


@pytest.mark.parametrize("arch", worlds.SERVE_ARCHS)
def test_sharded_decode_against_jax(w4, jax_run, arch):
    ref, got = jax_run(), w4[0]["serve"][arch]["logits"]
    assert len(got) == 1 + worlds.SERVE_STEPS
    for i, logits in enumerate(got):
        np.testing.assert_allclose(logits.numpy(), ref[f"serve:{arch}:{i}"],
                                   atol=1e-4, rtol=0, err_msg=str(i))


# -- vocab-parallel lookup and cross-entropy, expert-sharded routing ------------

def _jax_vocab(V: int, tied: bool):
    """The JAX package's loss of a vocab case on one device (its
    ``_nll_dense`` and ``embed``) and its gradients."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    from repro.models.transformer import _nll_dense
    a = worlds.vocab_inputs(V)
    cfg = worlds.vocab_cfg(tied)
    names = ["embed"] + ([] if tied else ["lm_head"])

    def loss(p, h):
        x = jlayers.embed(p, cfg, jnp.asarray(a["tokens"]))
        return (_nll_dense(cfg, {"embedding": p}, h,
                           jnp.asarray(a["labels"]))
                + jnp.sum(x * a["r"]))

    p = {k: jnp.asarray(a[k]) for k in names}
    val, (gp, gh) = jax.value_and_grad(loss, (0, 1))(p, jnp.asarray(
        a["hidden"]))
    return float(val), {**{k: np.asarray(v) for k, v in gp.items()},
                        "hidden": np.asarray(gh)}


@pytest.mark.parametrize("V,tied", worlds.VOCAB_CASES)
def test_vocab_parallel_loss_and_grads_equal_one_device(w4, V, tied):
    """The lookup and the cross-entropy on (2, 2), tied and untied, with
    ids on both sides of the table's shard boundary: the loss and every
    gradient within the mesh gate of one device on every rank.  A vocab
    the 2-way model axis splits keeps the logits split (``S(2)``) and
    gives the table a ``S(0)`` gradient; 7 rows stay whole (the
    replication fallback)."""
    for r in w4:
        got = r["vocab"][f"{V}:{tied}"]
        assert abs(got["loss_mesh"] - got["loss_one"]) < 1e-4
        assert got["grad_err"] < 1e-4
        if V % 2:
            assert got["logits"] == "R" and "S(0)" not in got["embed_grad"]
        else:
            assert got["logits"] == "S(2)" and got["embed_grad"] == [
                "P(sum)", "S(0)"]


@pytest.mark.parametrize("V,tied", worlds.VOCAB_CASES)
def test_vocab_parallel_loss_and_grads_against_jax(w4, V, tied):
    """The same against the JAX package's ``_nll_dense`` and ``embed`` on
    one device, within the mesh gate."""
    want, wgrads = _jax_vocab(V, tied)
    got = w4[0]["vocab"][f"{V}:{tied}"]
    assert abs(got["loss_mesh"] - want) < 1e-4
    assert set(got["grads"]) == set(wgrads)
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), wgrads[k], atol=1e-4, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)])
def test_expert_sharded_routing_equals_one_device(w4, dims):
    """Capacity routing with the 4 experts over the model axis, on (2, 2)
    (the rows over the data axis) and (1, 4): each rank builds dispatch
    and combine for its own rows and its own experts' columns only, and
    they and the gates' sum equal one device's there bit for bit (choices
    past the capacity dropped); the aux loss equals one device's (on
    (2, 2) within rounding of its mean over the data ways); the routing's
    gradient within 1e-5 of one device."""
    B, S, E, C = (worlds.ROUTE_B, worlds.ROUTE_S, worlds.ROUTE_E,
                  worlds.ROUTE_C)
    for r in w4:
        got = r["routing"][dims]
        assert got["same"] == [True] * 3
        assert got["aux_err"] == 0.0 if dims[0] == 1 else \
            got["aux_err"] < 1e-6
        assert got["dispatch"] == (["S(0)", "S(2)"],
                                   (B // dims[0], S, E // dims[1], C))
        assert got["grad_err"] < 1e-5
        assert r["routing"]["kept"] < B * S * worlds.ROUTE_K


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-vl-2b"])
def test_model_forward_on_the_mesh(w4, arch):
    """Reduced deepseek on the capacity path and qwen2-vl-2b fed
    ``input_embeds`` from the vocab-parallel lookup, on (2, 2): the logits
    split over the vocab, within 1e-5 of one device on every rank and
    within 1e-4 of the JAX package's forward."""
    import jax.numpy as jnp
    from _torch_loss_pairs import pair
    from repro.models import layers as jlayers
    for r in w4:
        assert r["forwards"][arch]["vocab_split"]
        assert r["forwards"][arch]["err"] < 1e-5
    got = w4[0]["forwards"][arch]
    jm, jp, _, _ = pair(arch)
    tokens = jnp.asarray(got["tokens"].numpy())
    kw = ({"input_embeds": jlayers.embed(jp["embedding"], jm.cfg, tokens)}
          if arch == "qwen2-vl-2b" else {})
    want = np.asarray(jm.forward(jp, tokens, **kw)[0])
    np.testing.assert_allclose(got["logits"].numpy(), want, atol=1e-4,
                               rtol=0)


@pytest.fixture(scope="module")
def fake_tp_step():
    """The dry-run's trace of the reduced qwen2 train step on (2, 2), in a
    fake world of 4 in this process (torn down on exit)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh, train_rules
    with fake_world(4):
        return dryrun._trace_variant(
            get_config("qwen2-0.5b", reduced=True),
            ShapeConfig("tp", 16, 8, "train"),
            make_mesh((2, 2), ("data", "model")), train_rules(),
            device="cpu")


def test_fake_world_counts_the_real_worlds_collectives(w4, fake_tp_step):
    """The same step in a real world of 4 (rank 0 counting with the
    dry-run's counter) and traced in a fake world of 4: the same calls
    and result bytes of each kind of collective, exactly, and argument
    bytes equal to the real rank's local shard bytes."""
    real = w4[0]["dryrun_step"]
    assert fake_tp_step.coll_calls == real["coll_calls"]
    assert fake_tp_step.coll_kinds == real["coll_kinds"]
    assert set(real["coll_calls"]) >= {"all-gather", "all-reduce"}
    assert fake_tp_step.argument_bytes == real["argument_bytes"]


@pytest.mark.parametrize("case", range(len(worlds.MHA_CASES)))
def test_mha_selects_kv_heads_per_rank(w4, case):
    """q's heads over a 4-way model axis that K does not divide: the
    output and the gradients of q, k and v within 1e-5 of one device on
    every rank (k's and v's summed over the ranks)."""
    for r in w4:
        assert r["mha_select"][case][1] < 1e-5


@pytest.mark.parametrize("case", range(len(worlds.MHA_CASES)))
def test_mha_selects_kv_heads_against_jax(w4, jax_run, case):
    got, _ = w4[0]["mha_select"][case]
    for name, a in zip(("o", "dq", "dk", "dv"), got):
        np.testing.assert_allclose(a.numpy(), jax_run()[f"mha{case}:{name}"],
                                   atol=1e-5, rtol=0, err_msg=name)


def test_train_loop_over_the_mesh(w4):
    """Two AdamW steps on (2, 2) against one device: the losses within
    1e-4, the weights within the reference's 5e-5 a step."""
    for r in w4:
        one, mesh = r["train_losses"]
        assert len(one) == len(mesh) == 2
        assert max(abs(a - b) for a, b in zip(one, mesh)) < 1e-4
        assert r["train_param_err"] < 1e-4


def test_donating_step_over_the_mesh_equals_the_pure_one(w4):
    """On (2, 2) the donating step writes the update into each rank's
    shards of the weights and moments, and every rank's shards equal the
    pure step's bit for bit."""
    for r in w4:
        assert r["donated_on_the_mesh"] == (True, True)


def test_prefetcher_shards_over_the_mesh(w4):
    steps, placements, same = w4[0]["prefetch"]
    assert steps == [0, 1] and same
    assert placements == ["S(0)", "R"]


def test_checkpoint_written_on_one_mesh_restores_onto_another(w8, w4):
    """Saved from (4, 2), restored onto (2, 2): the same weights, each
    leaf on the 4-rank mesh."""
    assert w8[0]["sharded_leaves"] > 0
    for r in w4:
        step, err, sizes = r["restore"]
        assert step == 5 and err == 0.0 and sizes == {4}


def test_remesh_onto_new_shardings(w4):
    """(2, 2) → (1, 4): the same weights, wq's heads now 4 ways."""
    for r in w4:
        err, placements, local = r["remesh"]
        assert err == 0.0 and placements == ["R", "S(2)"]
        assert local[2] * 4 == 128


def test_host_staged_group_carried_the_collectives(w4):
    """Every kind the networks, GPipe and ``DTensor`` use went through the
    staged group's host copies, each with its bytes counted."""
    got = w4[0]["stats"]
    for kind in ("all_gather", "all_reduce", "broadcast", "send", "recv"):
        s = got[f"staged:{kind}"]
        assert s["calls"] > 0 and s["staged_bytes"] >= s["bytes"] > 0, kind


# -- the launcher -------------------------------------------------------------

@pytest.mark.parametrize("mesh,need", [("single", 256), ("multi", 512)])
def test_train_cli_mesh_needs_its_world(mesh, need):
    from repro_torch.launch import train as launcher
    with pytest.raises(SystemExit, match=f"world of {need} ranks"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                       "cpu", "--virtual-devices", "4", "--mesh", mesh])


def test_train_cli_over_four_ranks(capsys):
    """``--virtual-devices 4``: one model trained by a world of 4 ranks
    over a ``data`` mesh, rank 0 printing."""
    from repro_torch.launch import train as launcher
    import multiprocessing
    res = launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                         "cpu", "--steps", "3", "--batch", "8", "--seq",
                         "16", "--virtual-devices", "4"])
    assert res["step"] == 3 and np.isfinite(res["history"][-1]["loss"])
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("rank")]  # no world left behind
