"""The rank bodies of ``tests/test_torch_distributed.py``: each runs in
every rank of a world started by ``repro_torch.launch.mesh.run_world`` and
returns what the tests check.  This module imports no JAX (each spawned
rank imports it), only torch and the port."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from repro_torch.launch.mesh import make_mesh, train_rules
from repro_torch.parallel.collectives import HostStagedGroup

CPU = "cpu"


class AlwaysStaged(HostStagedGroup):
    """The card's ``hoststaged`` group, copying CPU tensors through its
    host buffers too, so the CPU worlds run its staging."""

    @staticmethod
    def _staged(tensors: list) -> bool:
        return True


STAGED = "alwaysstaged"
if STAGED.upper() not in dist.Backend._plugins:  # in every spawned rank
    dist.Backend.register_backend(STAGED, AlwaysStaged, devices=["cpu"])


def variant(arch_id: str):
    """(arch, overrides) of an arch id: ``<arch>/ragged`` is the MoE arch
    on its ragged grouped-matmul path, ``/e<N>`` gives it N experts, and
    ``/chunk<N>`` takes the loss over sequence chunks of N."""
    arch, *path = arch_id.split("/")
    over: dict = {}
    for part in path:
        if part == "ragged":
            over["moe_ragged"] = True
        elif part.startswith("chunk"):
            over["loss_chunk"] = int(part.removeprefix("chunk"))
        else:
            over["n_experts"] = int(part.removeprefix("e"))
    return arch, over


def configure(cfg, overrides: dict):
    """``cfg`` (either package's) with ``overrides``; ``n_experts``
    replaces its MoE config's."""
    over = dict(overrides)
    if "n_experts" in over:
        over["moe"] = dataclasses.replace(cfg.moe,
                                          n_experts=over.pop("n_experts"))
    return dataclasses.replace(cfg, **over)


def reduced_model(arch_id: str = "qwen2-0.5b"):
    """(model, seed-0 params, an (8, 16) batch) on the CPU, f32, of an
    arch id (:func:`variant`)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    arch, over = variant(arch_id)
    cfg = configure(get_config(arch, reduced=True), over)
    model = Model(cfg)
    batch = SyntheticLM(batch=8, seq=16, vocab=cfg.vocab,
                        device=CPU).create(0)
    return model, model.init(seed=0, device=CPU), batch


def pipeline_inputs():
    rng = np.random.default_rng(0)
    L, D = 8, 16
    ws = (rng.normal(size=(L, D, D)) * 0.2).astype(np.float32)
    x = rng.normal(size=(8, 4, D)).astype(np.float32)
    return ws, x


def grey_images(n: int = 2, size: int = 32) -> np.ndarray:
    from repro_torch import workloads
    imgs = np.stack(workloads.synthetic_images(n, size))
    return (imgs @ np.asarray(workloads.GREY, np.float32)).astype(np.float32)


# (H, K, causal) of attention whose K does not divide a 4-way model axis:
# 3 query heads a rank across group borders, 2 heads of one group, 1 head
MHA_CASES = ((12, 3, True), (8, 2, False), (4, 1, True))


def mha_inputs(H: int, K: int) -> tuple:
    """q and w (2, H, 16, 8), k and v (2, K, 16, 8): attention's inputs
    and the weights of the loss sum(o * w)."""
    rng = np.random.default_rng(10 * H + K)
    shapes = ((2, H, 16, 8), (2, K, 16, 8), (2, K, 16, 8), (2, H, 16, 8))
    return tuple(rng.normal(size=s).astype(np.float32) for s in shapes)


def ring_inputs() -> np.ndarray:
    rng = np.random.default_rng(2)
    return (rng.normal(size=(8, 1000)) * 0.01).astype(np.float32)


def _whole(tree):
    return pytree.tree_map(
        lambda l: l.full_tensor() if hasattr(l, "full_tensor") else l, tree)


def _by_path(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(p): v for p, v in flat}


def _max_diff(a, b) -> float:
    """The largest difference between leaves at the same key path (a
    restored tree has its dicts' keys sorted)."""
    a, b = _by_path(a), _by_path(b)
    assert a.keys() == b.keys()
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


# --------------------------------------------------------------------------
# the world of 8 ranks
# --------------------------------------------------------------------------

def world8(rank: int, ckpt_dir: str) -> dict:
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.collectives import (combine_psum, psum_bf16,
                                                  ring_allreduce_int8)
    from repro_torch.train import Checkpointer
    out = {}
    # the int8 ring with error feedback (the reference's 8 devices)
    mesh = make_mesh((8,), ("dp",), device=CPU)
    g = torch.from_numpy(ring_inputs())
    exact = g.sum(0)
    r1, err = ring_allreduce_int8(g[rank], mesh, "dp", 8)
    r2, _ = ring_allreduce_int8(g[rank], mesh, "dp", 8, error=err)
    scale = float(exact.abs().max())
    out["ring_rel1"] = float((r1 - exact).abs().max()) / scale
    out["ring_rel2"] = float(((r1 + r2) / 2 - exact).abs().max()) / scale
    # the additive COMBINE, in f32 and with a bf16 payload
    x = torch.full((3,), 1.0 + rank / 3)
    out["psum"] = (combine_psum(x, mesh, "dp"), psum_bf16(x, mesh, "dp"))
    # a checkpoint written on a (4, 2) mesh
    model, params, _ = reduced_model()
    mesh_a = make_mesh((4, 2), ("data", "model"), device=CPU)
    placed = sh.place(params, sh.param_shardings(params, mesh_a,
                                                 train_rules()))
    out["sharded_leaves"] = sum(
        any(not p.is_replicate() for p in leaf.placements)
        for leaf in pytree.tree_leaves(placed))
    Checkpointer(ckpt_dir).save(5, {"params": placed})
    return out


# --------------------------------------------------------------------------
# the world of 4 ranks
# --------------------------------------------------------------------------

def _networks(rank: int, out: dict) -> None:
    from repro_torch import workloads
    from repro_torch.core import DataParallelCollect, build
    from repro_torch.interop import tree_from_numpy
    mesh = make_mesh((4,), ("data",), device=CPU)

    # the farm of tests/test_distributed.py: the Collect folds the
    # gathered blocks in item order
    net = DataParallelCollect(
        create=lambda i: torch.tensor(float(i)), function=lambda x: x * x,
        collector=lambda a, x: a + x, init=torch.tensor(0.0), workers=8,
        axis="data", jit_combine=True)
    cn = build(net, mesh)
    out["farm_sum"] = float(cn.run(instances=64)["collect"])
    out["farm_sum_streaming"] = float(
        cn.run_streaming(instances=64, microbatch_size=16)["collect"])

    # the Mandelbrot farm, its bands block-sharded over the ranks
    kw = dict(width=64, height=32, bands=8, iterations=50)
    one = workloads.assemble(build(workloads.mandelbrot_farm(**kw),
                                   device=CPU).run(instances=8)["collect"])
    cm = build(workloads.mandelbrot_farm(**kw, axis="data"), mesh)
    fused = workloads.assemble(cm.run(instances=8)["collect"])
    strm = workloads.assemble(
        cm.run_streaming(instances=8, microbatch_size=4)["collect"])
    out["mandelbrot_equal"] = bool(np.array_equal(fused, one)
                                   and np.array_equal(strm, one))

    # the image pipeline, its EDGE5 engine's rows over the ranks
    imgs = tree_from_numpy(workloads.synthetic_images(4, 32),
                           torch.device(CPU))
    one = build(workloads.image_pipeline(imgs), device=CPU).run(
        instances=4)["collector"]
    cp = build(workloads.image_pipeline(imgs, axis="data", nodes=4), mesh)
    got = cp.run(instances=4)["collector"] + cp.run_streaming(
        instances=4, microbatch_size=2)["collector"]
    out["pipeline_equal"] = all(np.array_equal(a, b)
                                for a, b in zip(got, one + one))

    # Jacobi, one partition a rank
    systems, _ = workloads.jacobi_systems(2, 64)
    systems = tree_from_numpy(systems, torch.device(CPU))
    one = build(workloads.jacobi(systems, n=64, nodes=4, tol=1e-6),
                device=CPU).run(instances=2)["collector"]
    cj = build(workloads.jacobi(systems, n=64, nodes=4, tol=1e-6,
                                axis="data"), mesh)
    got = cj.run(instances=2)["collector"]
    got_s = cj.run_streaming(instances=2, microbatch_size=1)["collector"]
    out["jacobi_equal"] = all(np.array_equal(a, b) and np.array_equal(a, c)
                              for a, b, c in zip(got, got_s, one))
    out["jacobi"] = np.stack(got)

    # EDGE5 (and k = 1, 3) with halos against one device
    from repro_torch.core.engine import Stencil
    grey = torch.from_numpy(grey_images())
    equal = True
    for taps in (workloads.EDGE5, ((2.0,),), workloads.EDGE3):
        for img in grey:
            a = Stencil(kernel=taps, axis="data", nodes=4).apply(img, mesh)
            b = Stencil(kernel=taps).apply(img)
            equal = equal and torch.equal(a, b)
    out["stencil_equal"] = equal
    out["edge5"] = torch.stack([Stencil(kernel=workloads.EDGE5, axis="data",
                                        nodes=4).apply(img, mesh)
                                for img in grey])


def _pipeline(rank: int, out: dict) -> None:
    from repro_torch.parallel.pipeline import pipeline_forward, split_stages
    mesh = make_mesh((4,), ("stage",), device=CPU)
    ws, x = (torch.from_numpy(a) for a in pipeline_inputs())

    def block_fn(lp, h):
        for w in lp:
            h = torch.tanh(h @ w)
        return h

    got = pipeline_forward(block_fn, split_stages(ws, 4), x, mesh=mesh,
                           n_stages=4, n_micro=4)
    out["pipeline_err"] = float((got - block_fn(ws, x)).abs().max())
    out["pipeline"] = got


def _train_step(rank: int, out: dict, arch: str = "qwen2-0.5b") -> None:
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.axes import shard_ctx
    from repro_torch.train.train_loop import _value_and_grad
    model, params, batch = reduced_model(arch)
    loss0, _, grads0 = _value_and_grad(model, params, batch)
    mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
    rules = train_rules()
    dp = sh.place(params, sh.param_shardings(params, mesh, rules))
    db = sh.place(batch, sh.to_shardings(sh.batch_specs(batch, mesh, rules),
                                         mesh))
    with shard_ctx(mesh, rules):
        loss, _, grads = _value_and_grad(model, dp, db)
    grads = _whole(grads)
    out["loss_one"], out["loss_mesh"] = float(loss0), float(_whole(loss))
    out["grad_err"] = _max_diff(grads, grads0)
    out["grads"] = grads


def mha_select(n: int, cases, dev) -> list:
    """``mha`` of q sharded on its heads over an n-way model axis on
    ``dev``, k and v whole on every rank (K does not divide the axis):
    for each (H, K, causal) of ``cases``, the output and the gradients of
    q, k and v of the loss sum(o * w), and their largest difference from
    one device's on the CPU."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.flash_attention.ops import mha
    dm = make_mesh((n,), ("model",), device=dev.type).device_mesh()
    res = []
    for H, K, causal in cases:
        inputs = [torch.from_numpy(a) for a in mha_inputs(H, K)]

        def run(q, k, v, w):
            live = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = mha(*live, causal=causal)
            return [o.detach(), *torch.autograd.grad((o * w).sum(), live)]

        one = run(*inputs)
        got = run(*(distribute_tensor(t.to(dev), dm, [pl],
                                      src_data_rank=None)
                    for t, pl in zip(inputs, (Shard(1), Replicate(),
                                              Replicate(), Shard(1)))))
        got = [t.full_tensor().cpu() for t in got]
        res.append((got, max(float((a - b).abs().max())
                             for a, b in zip(got, one))))
    return res


def _donated_step_on_the_mesh(model, params, batch, mesh) -> tuple:
    """One donating and one pure step from the same placed state on
    ``mesh``: (the donating step's trees equal the pure one's bit for bit,
    it wrote into the local shards the state had)."""
    from repro_torch.data import shard_batch
    from repro_torch.parallel.axes import shard_ctx
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.train.train_loop import place_state
    opt, rules = AdamW(lr=1e-2), train_rules()
    batch = shard_batch(batch, mesh, rules.batch)
    placed = [place_state(params, opt.init(params), mesh, rules)
              for _ in range(2)]
    local = [t.to_local().data_ptr() for t in pytree.tree_leaves(
        (placed[1][0], placed[1][1]["m"]))]
    with shard_ctx(mesh, rules):
        want = make_train_step(model, opt)(*placed[0], batch)
        got = make_train_step(model, opt, donate=True)(*placed[1], batch)
    same = all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(
        pytree.tree_leaves(got[:2]), pytree.tree_leaves(want[:2])))
    kept = local == [t.to_local().data_ptr() for t in pytree.tree_leaves(
        (got[0], got[1]["m"]))]
    return same, kept


def _train_loop(rank: int, out: dict) -> None:
    from repro_torch.data import Prefetcher, SyntheticLM
    from repro_torch.train import train
    model, params, _ = reduced_model()
    src = SyntheticLM(batch=8, seq=16, vocab=model.cfg.vocab, device=CPU)
    one = train(model, src, steps=2, device=CPU, params=params, log_every=1)
    mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
    res = train(model, src, steps=2, mesh=mesh, params=params, log_every=1)
    out["train_losses"] = ([h["loss"] for h in one["history"]],
                           [h["loss"] for h in res["history"]])
    out["train_param_err"] = _max_diff(_whole(res["params"]), one["params"])
    out["donated_on_the_mesh"] = _donated_step_on_the_mesh(
        model, params, src.create(0), mesh)
    pf = Prefetcher(src, mesh=mesh, n_steps=2)
    got = list(pf)
    tok = got[1][1]["tokens"]
    out["prefetch"] = ([s for s, _ in got], [str(p) for p in tok.placements],
                       bool(torch.equal(tok.full_tensor(),
                                        src.create(1)["tokens"])))


def _checkpoint_remesh(rank: int, out: dict, ckpt_dir: str) -> None:
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import Checkpointer, remesh
    _, params, _ = reduced_model()
    mesh_b = make_mesh((2, 2), ("data", "model"), device=CPU)
    sh_b = sh.param_shardings(params, mesh_b, train_rules())
    step, back = Checkpointer(ckpt_dir).restore({"params": params},
                                                shardings={"params": sh_b})
    leaves = pytree.tree_leaves(back["params"])
    out["restore"] = (step, _max_diff(_whole(back["params"]), params),
                      {leaf.device_mesh.size() for leaf in leaves})
    # re-place onto a (1, 4) mesh: the model axis now 4 wide
    mesh_c = make_mesh((1, 4), ("data", "model"), device=CPU)
    sh_c = sh.param_shardings(params, mesh_c, train_rules())
    moved = remesh(back["params"], sh_c)
    wq = moved["segments"][0]["attn"]["wq"]
    out["remesh"] = (_max_diff(_whole(moved), params),
                     [str(p) for p in wq.placements],
                     tuple(wq.to_local().shape))


# the families the mesh slice left: MoE (capacity and ragged), SSM,
# hybrid, the encoder-decoder and the VLM, each a (2, 2) train step against
# one device; the ragged path also with 3 experts, which the 2-way model
# axis does not divide (the rules leave them whole on every rank); and
# qwen2 with its vocab-parallel loss over two checkpointed sequence chunks
FAMILY_ARCHS = ("deepseek-moe-16b", "mamba2-2.7b", "zamba2-1.2b",
                "whisper-tiny", "qwen2-vl-2b", "deepseek-moe-16b/ragged",
                "phi3.5-moe-42b-a6.6b/ragged", "deepseek-moe-16b/ragged/e3",
                "qwen2-0.5b/chunk8")
# sharded serving: decode on a (1, 4) mesh with the caches' positions over
# the model axis (serve_rules' kv_seq), and the MoE's experts too
SERVE_ARCHS = ("qwen2-0.5b", "zamba2-1.2b", "deepseek-moe-16b",
               "deepseek-moe-16b/ragged")
SERVE_LEN, SERVE_PROMPT, SERVE_STEPS = 8, 3, 4


def serve_tokens(vocab: int) -> list:
    """The prompt (2, SERVE_PROMPT) and SERVE_STEPS single-token steps
    (2, 1) of the decode checks, as numpy int32."""
    rng = np.random.default_rng(7)
    return ([rng.integers(0, vocab, (2, SERVE_PROMPT), dtype=np.int32)]
            + [rng.integers(0, vocab, (2, 1), dtype=np.int32)
               for _ in range(SERVE_STEPS)])


def _decode_logits(model, params, cache, steps) -> list:
    out = []
    for tok in steps:
        logits, cache = model.decode_step(params, cache, tok)
        out.append(_whole(logits).float())
    return out


def sharded_decode(arch: str, mesh, dev) -> tuple:
    """Prefill and 4 decode steps of ``arch`` (f32): the logits on one
    CPU device, and on ``mesh`` (its ranks on ``dev``) with the caches
    placed by ``cache_specs`` under ``serve_rules()`` (their positions
    split over the model axis); and the placed cache."""
    from repro_torch.device import to_device
    from repro_torch.launch.mesh import serve_rules
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.axes import shard_ctx
    rules = serve_rules()
    model, params, _ = reduced_model(arch)
    steps = [torch.from_numpy(t) for t in serve_tokens(model.cfg.vocab)]
    one = _decode_logits(model, params, model.init_cache(
        2, SERVE_LEN, device=CPU), steps)
    cache = model.init_cache(2, SERVE_LEN, device=dev)
    dc = sh.place(cache, sh.to_shardings(sh.cache_specs(cache, mesh, rules),
                                         mesh))
    dp = sh.place(to_device(params, dev),
                  sh.param_shardings(params, mesh, rules))
    ds = [sh.place(t.to(dev), sh.to_shardings(sh.batch_specs(t, mesh, rules),
                                              mesh)) for t in steps]
    with shard_ctx(mesh, rules):
        got = [t.cpu() for t in _decode_logits(model, dp, dc, ds)]
    return got, one, dc


def _serve(rank: int, out: dict) -> None:
    """Prefill and 4 decode steps of each serve arch on one device and on
    a (1, 4) mesh (:func:`sharded_decode`)."""
    mesh = make_mesh((1, 4), ("data", "model"), device=CPU)
    for arch in SERVE_ARCHS:
        got, one, dc = sharded_decode(arch, mesh, CPU)
        k = next(seg["k"] for seg in dc["segments"] if "k" in seg)
        out[arch] = {"logits": got,
                     "err": max(float((a - b).abs().max())
                                for a, b in zip(got, one)),
                     # (…, B, T, K, hd): T split over the model axis
                     "positions_split": str(k.placements[-1])
                     == f"S({k.ndim - 3})"}


def _dryrun_step(rank: int, out: dict) -> None:
    """The dry-run's reduced qwen2 train step (``launch.dryrun.step_args``
    and ``run_step``, real tensors) on (2, 2), rank 0 counting its
    collectives with the dry-run's counter; the local bytes of its
    arguments."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.parallel.axes import shard_ctx
    model, params, _ = reduced_model()
    mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
    rules = train_rules()
    shape = ShapeConfig("tp", 16, 8, "train")
    args = dryrun.step_args(model, shape, mesh, rules, torch.device(CPU),
                            params=params)
    counter = dryrun.CostCounter()
    counter.known(args)
    with shard_ctx(mesh, rules), counter:
        dryrun.run_step(model, shape, args)
    out["argument_bytes"] = dryrun.tree_bytes(args)
    out["coll_calls"], out["coll_kinds"] = counter.calls, counter.coll


# vocab-parallel lookup and cross-entropy: (vocab, tied) — 10 rows split
# 5 | 5 over the 2-way model axis, 7 left whole (the replication fallback)
VOCAB_CASES = ((10, True), (10, False), (7, True), (7, False))
VOCAB_D, VOCAB_B, VOCAB_S = 8, 4, 6


def vocab_inputs(V: int) -> dict:
    """The table, head, hidden states, lookup weights, tokens and labels
    (numpy) of a vocab case; the ids include both sides of the shard
    boundary V // 2 and both ends of the vocab."""
    rng = np.random.default_rng(V)
    D, B, S = VOCAB_D, VOCAB_B, VOCAB_S
    ids = rng.integers(0, V, (2, B, S)).astype(np.int32)
    ids[:, 0, :4] = [V // 2 - 1, V // 2, 0, V - 1]
    ids[1, 1, :4] = [V // 2, V // 2 - 1, V - 1, 0]
    f32 = np.float32
    return {"embed": (rng.normal(size=(V, D)) * 0.5).astype(f32),
            "lm_head": (rng.normal(size=(D, V)) * 0.5).astype(f32),
            "hidden": rng.normal(size=(B, S, D)).astype(f32),
            "r": rng.normal(size=(B, S, D)).astype(f32),
            "tokens": ids[0], "labels": ids[1]}


def vocab_cfg(tied: bool):
    """The fields of a config that embed, unembed and the loss read (the
    tied case scales the embeddings, as gemma-2b does)."""
    import types
    return types.SimpleNamespace(compute_dtype="float32", d_model=VOCAB_D,
                                 tied_embeddings=tied, embed_scale=tied)


def vocab_loss(cfg, params, hidden, r, tokens, labels):
    """nll_sum of the unembedded hidden states plus Σ lookup · r."""
    from repro_torch.models import layers
    logits = layers.unembed(params, cfg, hidden).float()
    x = layers.embed(params, cfg, tokens)
    return layers.nll_sum(logits, labels) + (x * r).sum(), logits


def _vocab_case(V: int, tied: bool) -> dict:
    """One vocab case on one device and on a (2, 2) mesh under
    ``train_rules()``: the loss, the gradients of the table (and head) and
    hidden states, the placements of the logits and the table's
    gradient."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.axes import shard_ctx
    cfg = vocab_cfg(tied)
    a = {k: torch.from_numpy(v) for k, v in vocab_inputs(V).items()}
    params = {"embed": a["embed"]}
    if not tied:
        params["lm_head"] = a["lm_head"]
    data = {k: a[k] for k in ("hidden", "r", "tokens", "labels")}

    def run(p, d):
        live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        h = d["hidden"].detach().requires_grad_(True)
        loss, logits = vocab_loss(cfg, live, h, d["r"], d["tokens"],
                                  d["labels"])
        grads = torch.autograd.grad(loss, [*live.values(), h])
        return loss, logits, dict(zip([*live, "hidden"], grads))

    loss1, _, g1 = run(params, data)
    mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
    rules = train_rules()
    dp = sh.place(params, sh.param_shardings(params, mesh, rules))
    dd = sh.place(data, sh.to_shardings(sh.batch_specs(data, mesh, rules),
                                        mesh))
    with shard_ctx(mesh, rules):
        loss, logits, g = run(dp, dd)
    return {"loss_one": float(loss1), "loss_mesh": float(_whole(loss)),
            "grads": {k: _whole(v) for k, v in g.items()},
            "grad_err": max(float((_whole(v) - g1[k]).abs().max())
                            for k, v in g.items()),
            "logits": str(logits.placements[-1]),
            "embed_grad": [str(pl) for pl in g["embed"].placements]}


def _vocab_parallel(rank: int, out: dict) -> None:
    for V, tied in VOCAB_CASES:
        out[f"{V}:{tied}"] = _vocab_case(V, tied)


# capacity-path routing of (B, S, E) probabilities, k choices, capacity C
# (below the choices' need: some are dropped)
ROUTE_B, ROUTE_S, ROUTE_E, ROUTE_K, ROUTE_C = 4, 12, 4, 2, 4


def route_probs() -> np.ndarray:
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(ROUTE_B, ROUTE_S, ROUTE_E)) * 2
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _expert_routing(rank: int, out: dict) -> None:
    """``_dispatch_combine`` on one device and on two meshes with the
    experts over the model axis: (2, 2) (2 of the 4 experts a rank, the
    batch rows over the data axis) and (1, 4) (one expert a rank, the rows
    whole).  Each rank's shards of dispatch, combine and the gates' sum
    against one device's (its rows and experts' columns) bit for bit, and
    the aux loss whole (on (2, 2) its mean over the data ways sums in
    another order); the routing's gradient (through combine, the gates'
    sum and aux) against one device's."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.axes import shard_ctx
    probs = torch.from_numpy(route_probs())
    w = torch.from_numpy(np.random.default_rng(12).normal(
        size=(ROUTE_B, ROUTE_S, ROUTE_E, ROUTE_C)).astype(np.float32))

    def run(pr, wt):
        pr = pr.detach().requires_grad_(True)
        got = moe._dispatch_combine(pr, ROUTE_K, ROUTE_C)
        loss = (got[1] * wt).sum() + got[2].sum() + got[3]
        return [t.detach() for t in got], torch.autograd.grad(loss, pr)[0]

    one, g1 = run(probs, w)
    out["kept"] = float(one[0].sum())
    rules = train_rules()
    for dims in ((2, 2), (1, 4)):
        mesh = make_mesh(dims, ("data", "model"), device=CPU)
        rows = sh.NamedSharding(mesh, sh.P("data"))
        with shard_ctx(mesh, rules):
            got, g = run(rows.place(probs), rows.place(w))
        same = [bool(torch.equal(a.to_local(), distribute_tensor(
            b, a.device_mesh, a.placements, src_data_rank=None).to_local()))
            for a, b in zip(got[:3], one)]
        out[dims] = {"same": same,
                     "aux_err": float((_whole(got[3]) - one[3]).abs()),
                     "dispatch": ([str(pl) for pl in got[0].placements],
                                  tuple(got[0].to_local().shape)),
                     "grad_err": float((_whole(g) - g1).abs().max())}


def _model_forwards(rank: int, out: dict) -> None:
    """Two whole forwards on (2, 2) against one device: reduced deepseek on
    the capacity path (its experts split over the model axis), and reduced
    qwen2-vl-2b fed ``input_embeds`` from the vocab-parallel lookup."""
    from repro_torch.models import layers
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.axes import shard_ctx
    mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
    rules = train_rules()
    for arch in ("deepseek-moe-16b", "qwen2-vl-2b"):
        model, params, batch = reduced_model(arch)
        tokens = batch["tokens"]
        embeds = arch == "qwen2-vl-2b"

        def fwd(p, t):
            kw = ({"input_embeds": layers.embed(p["embedding"], model.cfg,
                                                t)} if embeds else {})
            return model.forward(p, t, **kw)[0]

        with torch.no_grad():
            one = fwd(params, tokens)
            dp = sh.place(params, sh.param_shardings(params, mesh, rules))
            dt = sh.place(tokens, sh.to_shardings(
                sh.batch_specs(tokens, mesh, rules), mesh))
            with shard_ctx(mesh, rules):
                got = fwd(dp, dt)
        out[arch] = {"logits": _whole(got), "tokens": tokens,
                     "err": float((_whole(got) - one).abs().max()),
                     "vocab_split": str(got.placements[-1]) == "S(2)"}


def world4(rank: int, ckpt_dir: str) -> dict:
    from repro_torch.parallel.collectives import reset_stats, stats
    out: dict = {}
    reset_stats()
    _networks(rank, out)
    _pipeline(rank, out)
    _train_step(rank, out)
    out["gemma"] = {}
    _train_step(rank, out["gemma"], "gemma-2b")  # K = 1 on a 2-way axis
    out["mha_select"] = mha_select(4, MHA_CASES, torch.device(CPU))
    _train_loop(rank, out)
    _checkpoint_remesh(rank, out, ckpt_dir)
    out["stats"] = stats()
    for arch in FAMILY_ARCHS:
        out[arch] = {}
        _train_step(rank, out[arch], arch)
    out["serve"] = {}
    _serve(rank, out["serve"])
    out["dryrun_step"] = {}
    _dryrun_step(rank, out["dryrun_step"])
    for key, body in (("vocab", _vocab_parallel),
                      ("routing", _expert_routing),
                      ("forwards", _model_forwards)):
        out[key] = {}
        body(rank, out[key])
    return out


# --------------------------------------------------------------------------
# the card's world of 2 ranks (tests/test_torch_gpu.py)
# --------------------------------------------------------------------------

def gpu_world(rank: int) -> dict:
    """Two ranks sharing the card: the farm, EDGE5 with halos, a reduced
    qwen2 TP step, the reduced deepseek's ragged MoE path in a train step
    and in sharded decode, attention with 3 KV heads over 2 ranks, the
    int8 ring and GPipe, each with the kernel launches of its mesh run."""
    from repro_torch import workloads
    from repro_torch.core import build
    from repro_torch.core.engine import Stencil
    from repro_torch.device import to_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.axes import shard_ctx
    from repro_torch.parallel.collectives import ring_allreduce_int8
    from repro_torch.parallel.pipeline import pipeline_forward, split_stages
    from repro_torch.train.train_loop import _value_and_grad
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2,), ("data",))
    out = {}

    kw = dict(width=256, height=64, bands=8, iterations=200)
    one = workloads.assemble(build(workloads.mandelbrot_farm(**kw),
                                   device=dev).run(instances=8)["collect"])
    reset_launch_counts()
    got = workloads.assemble(build(workloads.mandelbrot_farm(
        **kw, axis="data"), mesh).run(instances=8)["collect"])
    out["farm"] = (bool(np.array_equal(one, got)),
                   launch_counts()["mandelbrot"])

    grey = torch.from_numpy(grey_images(2, 64)).to(dev)
    reset_launch_counts()
    a = [Stencil(kernel=workloads.EDGE5, axis="data", nodes=2).apply(g, mesh)
         for g in grey]
    n = launch_counts()["stencil"]
    b = [Stencil(kernel=workloads.EDGE5).apply(g) for g in grey]
    out["stencil"] = (all(torch.equal(x, y) for x, y in zip(a, b)), n)

    model, params, batch = reduced_model()
    loss_cpu, _, grads_cpu = _value_and_grad(model, params, batch)
    mesh2 = make_mesh((1, 2), ("data", "model"))
    rules = train_rules()
    dp = sh.place(to_device(params, dev),
                  sh.param_shardings(params, mesh2, rules))
    db = sh.place(to_device(batch, dev), sh.to_shardings(
        sh.batch_specs(batch, mesh2, rules), mesh2))
    reset_launch_counts()
    with shard_ctx(mesh2, rules):
        loss, _, grads = _value_and_grad(model, dp, db)
    out["tp"] = (abs(float(_whole(loss)) - float(loss_cpu)),
                 _max_diff(to_device(_whole(grads), torch.device(CPU)),
                           grads_cpu),
                 launch_counts()["flash_attention"], model.cfg.n_layers)

    # the ragged MoE path: the reduced deepseek's 4 experts split over
    # the model axis, 2 a rank, in a train step and in sharded decode
    model, params, batch = reduced_model("deepseek-moe-16b/ragged")
    gmm_per_forward = 3 * (model.cfg.n_layers - 1)
    loss_cpu, _, grads_cpu = _value_and_grad(model, params, batch)
    dp = sh.place(to_device(params, dev),
                  sh.param_shardings(params, mesh2, rules))
    db = sh.place(to_device(batch, dev), sh.to_shardings(
        sh.batch_specs(batch, mesh2, rules), mesh2))
    reset_launch_counts()
    with shard_ctx(mesh2, rules):
        loss, _, grads = _value_and_grad(model, dp, db)
    out["ragged_train"] = (
        abs(float(_whole(loss)) - float(loss_cpu)),
        _max_diff(to_device(_whole(grads), torch.device(CPU)), grads_cpu),
        launch_counts()["moe_gmm"], gmm_per_forward)
    reset_launch_counts()
    got, one, _ = sharded_decode("deepseek-moe-16b/ragged", mesh2, dev)
    out["ragged_decode"] = (
        max(float((a - b).abs().max()) for a, b in zip(got, one)),
        launch_counts()["moe_gmm"], gmm_per_forward * len(got))

    reset_launch_counts()
    errs = [e for _, e in mha_select(2, [(6, 3, True)], dev)]
    out["mha_select"] = (errs, launch_counts()["flash_attention"])

    g = torch.from_numpy(ring_inputs()[:2]).to(dev)
    exact = g.sum(0)
    r1, err = ring_allreduce_int8(g[rank], mesh, "data", 2)
    r2, _ = ring_allreduce_int8(g[rank], mesh, "data", 2, error=err)
    scale = float(exact.abs().max())
    out["ring"] = (float((r1 - exact).abs().max()) / scale,
                   float(((r1 + r2) / 2 - exact).abs().max()) / scale)

    stage_mesh = make_mesh((2,), ("stage",))
    ws, x = (torch.from_numpy(v).to(dev) for v in pipeline_inputs())

    def block_fn(lp, h):
        for w in lp:
            h = torch.tanh(h @ w)
        return h

    got = pipeline_forward(block_fn, split_stages(ws, 2), x,
                           mesh=stage_mesh, n_stages=2, n_micro=4)
    # the layers in order on each microbatch: cuBLAS picks its kernel by
    # the row count, so the whole batch at once differs by rounding
    seq = torch.cat([block_fn(ws, m) for m in x.chunk(4)])
    out["pipeline_err"] = float((got - seq).abs().max())
    return out
