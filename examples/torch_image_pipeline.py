"""Image-processing pipeline (paper §6.4, Listing 17) on the PyTorch port:
a stream of images flows Emit → StencilEngine(greyscale) →
StencilEngine(edge-detect 3×3 or 5×5) → Collect, the convolution on the
port's stencil kernel (its plain version on the CPU).

    PYTHONPATH=src python examples/torch_image_pipeline.py [--kernel 5]

The counterpart of ``examples/image_pipeline.py``, on the card unless
``--device cpu``.  The reference's ``--pallas`` has no counterpart: on the
card the kernel always runs.
"""

import argparse

import numpy as np

from repro_torch import workloads
from repro_torch.core import build, run_sequential, verify
from repro_torch.device import resolve_device
from repro_torch.interop import tree_from_numpy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", type=int, choices=(3, 5), default=5)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--images", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card)")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the reference's sake; no effect "
                         "(on the card the kernel always runs)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    imgs = tree_from_numpy(workloads.synthetic_images(args.images, args.size),
                           dev)
    taps = workloads.EDGE5 if args.kernel == 5 else workloads.EDGE3
    net = workloads.image_pipeline(imgs, taps)
    verify(net)
    seq = run_sequential(net, args.images, device=dev)["collector"]
    cn = build(net, device=dev)
    par = cn.run(instances=args.images)["collector"]
    same = all(np.array_equal(a, b) for a, b in zip(seq, par))
    print(f"sequential == parallel ({args.images} images, {args.kernel}x"
          f"{args.kernel} kernel, {dev.type}): {same}")
    strm = cn.run_streaming(instances=args.images,
                            microbatch_size=2)["collector"]
    same_s = all(np.array_equal(a, b) for a, b in zip(seq, strm))
    print(f"sequential == streaming: {same_s}  [{cn.stream_stats.summary()}]")
    edges = np.abs(par[0]) > 1.0
    print(f"edge pixels detected: {int(edges.sum())} "
          f"({'OK' if edges.sum() > 0 else 'FAIL'})")
    if not (same and same_s and edges.sum() > 0):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
