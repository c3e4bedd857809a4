"""The paper's workloads as port networks: the main path's four users.

Each factory builds the same network as its JAX counterpart, with the user
methods written on tensors:

* :func:`mandelbrot_farm` — the row-band farm of ``examples/mandelbrot.py``
  (§6.6), each band rendered by the Mandelbrot kernel with the band's top
  edge ``y0 + delta * row0`` formed on the device, as the cluster launcher
  forms it (``repro.launch.cluster.make_mandelbrot``);
* :func:`image_pipeline` — Emit → StencilEngine(grey) →
  StencilEngine(edge) → Collect of ``examples/image_pipeline.py`` (§6.4),
  the convolution on the stencil kernel;
* :func:`jacobi` — the MultiCoreEngine solver of ``examples/jacobi.py``
  (§6.2);
* :func:`monte_carlo_pi` — the farm of ``examples/quickstart.py`` (§3),
  each item drawing its points from its own seeded ``torch.Generator``.

Inputs are made with numpy from a seed (:func:`synthetic_images`,
:func:`jacobi_systems`), so the JAX package can be fed the same ones.

:func:`mandelbrot_factory` and :func:`image_pipeline_factory` are the
picklable, positional recipes a cluster deployment's spawned host processes
rebuild the farm and the pipeline from (``factory=(fn, args)``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import (Collect, DataParallelCollect, Emit, MultiCoreEngine,
                   Network, StencilEngine, narrow)
from .device import resolve_device
from .interop import tree_from_numpy
from .kernels.mandelbrot.ops import mandelbrot

__all__ = ["EDGE3", "EDGE5", "GREY", "mandelbrot_farm", "mandelbrot_factory",
           "assemble", "synthetic_images", "image_pipeline",
           "image_pipeline_factory", "jacobi_systems", "jacobi",
           "monte_carlo_pi"]

EDGE3 = ((-1.0,) * 3, (-1.0, 8.0, -1.0), (-1.0,) * 3)

EDGE5 = ((-1.0,) * 5, (-1.0,) * 5, (-1.0, -1.0, 24.0, -1.0, -1.0),
         (-1.0,) * 5, (-1.0,) * 5)
GREY = (0.299, 0.587, 0.114)


# -- Mandelbrot farm (§6.6) ---------------------------------------------------

def mandelbrot_farm(*, width: int, height: int, bands: int,
                    iterations: int, axis=None) -> Network:
    """Row bands of the window x0 = -2.2, y0 = -1.15, delta = 3 / width
    (``examples/mandelbrot.py``) fanned over ``bands`` workers (block-sharded
    over the mesh ``axis`` when built over a mesh); the Collect gathers
    ``{row0: counts}`` on the host."""
    if height % bands:
        raise ValueError(f"height={height} not divisible by bands={bands}")
    band_h = height // bands
    delta = 3.0 / width

    def create(i):
        """band i: its top row index."""
        return torch.tensor(i * band_h, dtype=torch.int32)

    def render_band(row0):
        return row0, mandelbrot(band_h, width, x0=-2.2, y0=-1.15,
                                pixel_delta=delta, max_iterations=iterations,
                                row0=row0)

    def collector(acc, item):
        row0, cnt = item
        acc[int(row0)] = cnt.cpu().numpy()
        return acc

    return DataParallelCollect(
        create=create, function=render_band, collector=collector, init={},
        workers=bands, axis=axis, name="mandelbrot")


def mandelbrot_factory(width: int, height: int, bands: int,
                       iterations: int) -> Network:
    """:func:`mandelbrot_farm` from positional arguments: the recipe a
    spawned cluster host rebuilds the farm from."""
    return mandelbrot_farm(width=width, height=height, bands=bands,
                           iterations=iterations)


def assemble(bands: dict) -> np.ndarray:
    """The farm's image from its ``{row0: band}`` collection."""
    return np.concatenate([bands[k] for k in sorted(bands)], axis=0)


# -- image pipeline (§6.4) ----------------------------------------------------

def synthetic_images(n: int, size: int) -> list[np.ndarray]:
    """The synthetic "photos" of ``examples/image_pipeline.py``: smooth
    gradients plus a bright square to edge-detect, (size, size, 3) float32."""
    imgs = []
    for i in range(n):
        img = np.linspace(0, 1, size)[:, None] * np.ones(size)
        s = size // 4
        img[s * (i % 2 + 1):s * (i % 2 + 2), s:2 * s] += 2.0
        imgs.append(np.stack([img, img * 0.5, img * 0.25],
                             -1).astype(np.float32))
    return imgs


def image_pipeline(images: list, taps=EDGE5, *, axis=None,
                   nodes: int = 1) -> Network:
    """Emit → StencilEngine(greyscale) → StencilEngine(``taps``, EDGE5 by
    default; its rows split over the ``nodes`` ranks of the mesh ``axis``
    when built over a mesh) → Collect; ``images`` are (H, W, 3) float32
    tensors, all on one device.  The Collect gathers the edge maps as numpy
    arrays."""
    weights = torch.tensor(GREY, dtype=torch.float32,
                           device=images[0].device)

    def grey(img):  # the user's greyScaleMethod
        return img @ weights

    net = Network("image")
    net.add(
        Emit(lambda i: images[i], name="emit"),
        StencilEngine(functionMethod=grey, name="engine1"),
        StencilEngine(convolutionData=taps, axis=axis, nodes=nodes,
                      name="engine2"),
        Collect(lambda acc, x: acc + [x.cpu().numpy()], init=[],
                name="collector"),
    )
    return net


def image_pipeline_factory(n: int, size: int, device=None) -> Network:
    """:func:`image_pipeline` over :func:`synthetic_images` ``(n, size)``
    on ``device`` (``None``: the card): the recipe a spawned cluster host
    rebuilds the pipeline from (the images are deterministic, so every host
    regenerates the same ones)."""
    return image_pipeline(tree_from_numpy(synthetic_images(n, size),
                                          resolve_device(device)))


# -- Jacobi on the MultiCoreEngine (§6.2) -------------------------------------

def jacobi_systems(n_systems: int, n: int):
    """Diagonally dominant systems as in ``examples/jacobi.py`` (numpy seed
    0): a list of ``{"A", "b", "x"}`` numpy pytrees and the list of true
    solutions."""
    rng = np.random.default_rng(0)
    systems, truths = [], []
    for _ in range(n_systems):
        A = rng.normal(size=(n, n)).astype(np.float32) \
            + n * np.eye(n, dtype=np.float32)
        x_true = rng.normal(size=n).astype(np.float32)
        systems.append({"A": A, "b": A @ x_true,
                        "x": np.zeros(n, np.float32)})
        truths.append(x_true)
    return systems, truths


def jacobi(systems: list, *, n: int, nodes: int, tol: float,
           axis=None) -> Network:
    """Emit → MultiCoreEngine(Jacobi, ``nodes`` partitions, tolerance loop;
    one partition a rank of the mesh ``axis`` when built over a mesh) →
    Collect of the solutions (numpy); ``systems`` hold tensors."""

    # -- the user's sequential methods (paper Listing 15 names) -----------
    def partitionMethod(state, lo, size):
        return {"A": narrow(state["A"], lo, size),
                "b": narrow(state["b"], lo, size),
                "x": state["x"], "lo": lo, "size": size}

    def calculationMethod(part):
        A, size = part["A"], part["size"]
        rows = torch.arange(size, device=A.device)
        diag = A[rows, part["lo"] + rows]
        return (part["b"] - A @ part["x"]
                + diag * narrow(part["x"], part["lo"], size)) / diag

    def updateMethod(state, new_x):
        return {**state, "x": new_x}

    def errorMethod(state, new_x):
        return (new_x - state["x"]).abs().max()

    net = Network("jacobi")
    net.add(
        Emit(lambda i: systems[i], name="emit"),
        MultiCoreEngine(nodes=nodes, n_rows=n,
                        partitionMethod=partitionMethod,
                        calculationMethod=calculationMethod,
                        updateMethod=updateMethod, errorMethod=errorMethod,
                        tol=tol, axis=axis, name="mcEngine"),
        Collect(lambda acc, st: acc + [st["x"].cpu().numpy()], init=[],
                name="collector"),
    )
    return net


# -- Monte-Carlo pi (§3) ------------------------------------------------------

def monte_carlo_pi(*, instances: int, points: int, workers: int,
                   explicit: bool = False) -> Network:
    """The quickstart farm: item i counts which of ``points`` uniform points
    of the unit square, drawn from a generator seeded with i on the item's
    device, fall in the quarter circle; the Collect sums the counts and
    finalises to the estimate of pi."""

    def create(i):
        """piData.createInstance: the i-th work item (its RNG seed)."""
        return torch.tensor(i, dtype=torch.int64)

    def get_within(seed):
        """piData.getWithin: count points inside the unit quadrant."""
        gen = torch.Generator(device=seed.device)
        gen.manual_seed(int(seed))
        pts = torch.rand((points, 2), generator=gen, device=seed.device)
        return ((pts ** 2).sum(-1) <= 1.0).sum().to(torch.int32)

    def collector(acc, within):
        return acc + within

    def finalise(total_within):
        return 4.0 * total_within / (instances * points)

    return DataParallelCollect(
        create=create, function=get_within, collector=collector,
        init=torch.tensor(0, dtype=torch.int32), finalise=finalise,
        workers=workers, jit_combine=True, explicit=explicit, name="mcpi")
