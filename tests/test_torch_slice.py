"""The whole first slice of the port against the JAX package, on the CPU.

The paper's four main-path workloads, built at small sizes from the same
numpy seeds, run through the port in its three modes (sequential oracle,
fused, streaming) and through the JAX package:

* the Mandelbrot farm image: at least 99.9% of pixels equal to JAX's;
* the image pipeline (grey, then EDGE5): within atol 1e-3 of JAX's, as
  ``examples/image_pipeline.py`` checks;
* Jacobi on the MultiCoreEngine: x within 1e-5 of JAX's and within 1e-3 of
  the truth, as ``examples/jacobi.py`` checks;
* Monte-Carlo pi: identical across the port's modes, and within 4 sigma of
  sampling error of JAX's estimate (``torch.Generator`` cannot reproduce
  threefry's bits).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as jcore
from repro.kernels.mandelbrot import ref as jmb_ref
from repro_torch import workloads
from repro_torch.core import build, run_sequential
from repro_torch.interop import tree_from_numpy
from repro_torch.kernels import launch_counts

CPU = torch.device("cpu")


def _three_modes(net, n, mb):
    seq = run_sequential(net, n, device=CPU)
    cn = build(net, device=CPU)
    return seq, cn.run(instances=n), cn.run_streaming(instances=n,
                                                      microbatch_size=mb)


def test_mandelbrot_farm_vs_jax():
    W, H, bands, iters = 96, 48, 8, 60
    band_h, delta = H // bands, 3.0 / W
    before = launch_counts()
    net = workloads.mandelbrot_farm(width=W, height=H, bands=bands,
                                    iterations=iters)
    seq, fused, strm = (workloads.assemble(r["collect"])
                        for r in _three_modes(net, bands, 2))
    assert np.array_equal(seq, fused) and np.array_equal(seq, strm)
    assert seq.shape == (H, W) and seq.dtype == np.int32
    assert launch_counts() == before  # the CPU runs the plain version

    def render(row0):  # the launcher's band worker (launch/cluster.py)
        return row0, jmb_ref.mandelbrot(band_h, W, x0=-2.2,
                                        y0=-1.15 + delta * row0,
                                        pixel_delta=delta,
                                        max_iterations=iters)

    def collector(acc, item):
        acc[int(item[0])] = np.asarray(item[1])
        return acc

    jnet = jcore.DataParallelCollect(
        create=lambda i: jnp.asarray(i * band_h, jnp.int32), function=render,
        collector=collector, init={}, workers=bands)
    theirs = workloads.assemble(jcore.build(jnet).run(instances=bands)
                                ["collect"])
    same = seq == theirs
    assert same.mean() >= 0.999, f"{(~same).sum()} pixels differ"


def test_image_pipeline_vs_jax():
    size, n = 48, 3
    imgs = workloads.synthetic_images(n, size)
    net = workloads.image_pipeline(tree_from_numpy(imgs, CPU))
    seq, fused, strm = (r["collector"] for r in _three_modes(net, n, 2))
    for a, b, c in zip(seq, fused, strm):
        assert np.array_equal(a, b) and np.array_equal(a, c)

    jimgs = [jnp.asarray(im) for im in imgs]
    jnet = jcore.Network("image")
    jnet.add(
        jcore.Emit(lambda i: jimgs[i], name="emit"),
        jcore.StencilEngine(functionMethod=lambda im: im @ jnp.asarray(
            workloads.GREY, jnp.float32), name="engine1"),
        jcore.StencilEngine(convolutionData=jnp.asarray(workloads.EDGE5),
                            name="engine2"),
        jcore.Collect(lambda acc, x: acc + [np.asarray(x)], init=[],
                      name="collector"))
    theirs = jcore.build(jnet).run(instances=n)["collector"]
    for ours, ref in zip(seq, theirs):
        np.testing.assert_allclose(ours, ref, atol=1e-3)
    assert (np.abs(seq[0]) > 1.0).sum() > 0  # edges of the bright square


def test_jacobi_vs_jax():
    n, nodes, tol = 64, 4, 1e-6
    systems, truths = workloads.jacobi_systems(2, n)
    net = workloads.jacobi(tree_from_numpy(systems, CPU), n=n, nodes=nodes,
                           tol=tol)
    seq, fused, strm = (r["collector"] for r in _three_modes(net, 2, 1))
    for a, b, c in zip(seq, fused, strm):
        assert np.array_equal(a, b) and np.array_equal(a, c)

    def partition(state, lo, size):
        return {"A": jcore.rows(state["A"], lo, size),
                "b": jcore.rows(state["b"], lo, size),
                "x": state["x"], "lo": lo, "size": size}

    def calculation(part):
        idx = part["lo"] + jnp.arange(part["size"])
        diag = jax.vmap(lambda r, j: r[j])(part["A"], idx)
        return (part["b"] - part["A"] @ part["x"]
                + diag * jcore.rows(part["x"], part["lo"], part["size"])) \
            / diag

    jnet = jcore.Network("jacobi")
    jnet.add(
        jcore.Emit(lambda i: {k: jnp.asarray(v) for k, v in
                              systems[i].items()}, name="emit"),
        jcore.MultiCoreEngine(
            nodes=nodes, n_rows=n, partitionMethod=partition,
            calculationMethod=calculation,
            updateMethod=lambda st, x: {**st, "x": x},
            errorMethod=lambda st, x: jnp.max(jnp.abs(x - st["x"])),
            tol=tol, name="mcEngine"),
        jcore.Collect(lambda acc, st: acc + [np.asarray(st["x"])], init=[],
                      name="collector"))
    theirs = jcore.build(jnet).run(instances=2)["collector"]
    for ours, ref, truth in zip(seq, theirs, truths):
        assert np.max(np.abs(ours - ref)) < 1e-5
        assert np.max(np.abs(ours - truth)) < 1e-3


def test_monte_carlo_pi_vs_jax():
    instances, points = 16, 4000
    net = workloads.monte_carlo_pi(instances=instances, points=points,
                                   workers=4)
    seq, fused, strm = (float(r["collect"])
                        for r in _three_modes(net, instances, 5))
    assert seq == fused == strm

    def get_within(seed):  # examples/quickstart.py
        pts = jax.random.uniform(jax.random.PRNGKey(seed), (points, 2))
        return jnp.sum((pts ** 2).sum(-1) <= 1.0).astype(jnp.int32)

    jnet = jcore.DataParallelCollect(
        create=lambda i: jnp.asarray(i, jnp.uint32), function=get_within,
        collector=lambda a, x: a + x, init=jnp.asarray(0, jnp.int32),
        finalise=lambda t: 4.0 * t / (instances * points), workers=4,
        jit_combine=True)
    theirs = float(jcore.build(jnet).run(instances=instances)["collect"])
    p = math.pi / 4
    sigma = 4.0 * math.sqrt(p * (1 - p) / (instances * points))
    # two independent estimates: their difference has sigma * sqrt(2)
    assert abs(seq - theirs) < 4 * sigma * math.sqrt(2)
    assert abs(seq - math.pi) < 4 * sigma


def test_tree_from_numpy_carries_inputs_across():
    tree = {"img": np.arange(6, dtype=np.float32).reshape(2, 3),
            "seed": np.int64(3), "taps": (np.ones((3, 3), np.float32), 2)}
    out = tree_from_numpy(tree, CPU, dtype_map={np.float32: torch.bfloat16})
    assert out["img"].dtype == torch.bfloat16
    assert torch.equal(out["img"].float(), torch.arange(6.0).reshape(2, 3))
    assert out["seed"].dtype == torch.int64 and int(out["seed"]) == 3
    assert out["taps"][1] == 2  # non-array leaves stay as they are
    plain = tree_from_numpy(tree, CPU)
    assert plain["img"].dtype == torch.float32
