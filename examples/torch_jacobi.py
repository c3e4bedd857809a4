"""Jacobi solver on the MultiCoreEngine (paper §6.2, Listing 15), on the
PyTorch port.

A stream of equation systems flows Emit → MultiCoreEngine → Collect; the
engine iterates the partitioned update until the error margin is met (the
root's sequential error/update phase between BSP supersteps).

    PYTHONPATH=src python examples/torch_jacobi.py [--n 256] [--nodes 4]

The counterpart of ``examples/jacobi.py`` (the same numpy-seeded systems),
on the card unless ``--device cpu``; it also prints the sequential ==
parallel == streaming lines the other examples print.
"""

import argparse

import numpy as np

from repro_torch import workloads
from repro_torch.core import build, run_sequential, verify
from repro_torch.device import resolve_device
from repro_torch.interop import tree_from_numpy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--systems", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    systems, truths = workloads.jacobi_systems(args.systems, args.n)
    net = workloads.jacobi(tree_from_numpy(systems, dev), n=args.n,
                           nodes=args.nodes, tol=args.tol)
    verify(net)
    seq = run_sequential(net, args.systems, device=dev)["collector"]
    cn = build(net, device=dev)
    out = cn.run(instances=args.systems)["collector"]
    strm = cn.run_streaming(instances=args.systems,
                            microbatch_size=1)["collector"]
    same = all(np.array_equal(a, b) for a, b in zip(seq, out))
    same_s = all(np.array_equal(a, b) for a, b in zip(seq, strm))
    print(f"sequential == parallel: {same}")
    print(f"sequential == streaming: {same_s}  [{cn.stream_stats.summary()}]")
    ok = same and same_s
    for i, (x, x_true) in enumerate(zip(out, truths)):
        err = float(np.max(np.abs(x - x_true)))
        ok &= err < 1e-3
        print(f"system {i}: max|x - x_true| = {err:.2e} "
              f"({'OK' if err < 1e-3 else 'FAIL'})")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
