"""Mandelbrot farm (paper §6.6) on the PyTorch port: row bands fanned over
workers, each band rendered by the port's Mandelbrot kernel (its plain
version on the CPU).

    PYTHONPATH=src python examples/torch_mandelbrot.py [--width 192]
    PYTHONPATH=src python examples/torch_mandelbrot.py --hosts 2 \\
        --transport pipe --batches 3       # cluster mode

The counterpart of ``examples/mandelbrot.py``, on the card unless
``--device cpu``.  ``--hosts N`` reruns the paper's capstone: the *same*
declarative network is partitioned over N hosts (real OS processes with
``--transport pipe``, threads whose tensors stay on the card with
``device``, plain threads with ``inprocess``) and must produce results
bit-identical to the sequential oracle, with the CSP checker confirming the
partitioned network trace-refines the unpartitioned one.  The reference's
flags map as follows: ``--transport jaxmesh`` is ``device``; ``--pallas``
has no counterpart (on the card the kernel always runs); ``--transport
shm`` and ``--kill-host`` are refused until the port's shared-memory and
elastic cluster slices.
"""

import argparse
import sys
import time

import numpy as np

from repro_torch import workloads
from repro_torch.core import build, run_sequential

CHARS = " .:-=+*#%@"


def run_cluster_mode(args, net, factory, seq_img, device):
    from repro_torch.cluster import (ClusterDeployment, ClusterError,
                                     check_refinement, partition)
    from repro_torch.core import netlog
    transport = "device" if args.transport == "jaxmesh" else args.transport
    if transport == "shm" or args.kill_host >= 0:
        what = "--transport shm" if transport == "shm" else "--kill-host"
        print(f"{what}: not in the port yet (the shared-memory ring and "
              "elastic recovery come with later cluster slices)",
              file=sys.stderr)
        raise SystemExit(2)
    plan = partition(net, hosts=args.hosts)
    print(plan.describe())
    refines = check_refinement(net, plan)
    print(f"partitioned [T= unpartitioned (CSP, both directions): "
          f"{refines}")
    if not refines:
        raise SystemExit(1)
    # one warm deployment serves every batch: spawn and stage building are
    # paid once (batch 0), the rest is steady state
    img, same = None, False
    with ClusterDeployment(net, plan=plan, transport=transport,
                           microbatch_size=max(args.bands // 4, 1),
                           factory=factory, device=device,
                           timeout_s=args.timeout_s) as dep:
        for b in range(max(args.batches, 1)):
            t0 = time.perf_counter()
            try:
                out = dep.run(instances=args.bands)
            except ClusterError as e:
                print(e)
                raise SystemExit(1)
            wall = time.perf_counter() - t0
            img = workloads.assemble(out["collect"])
            same = bool(np.array_equal(img, seq_img))
            if args.batches > 1:
                state = "cold" if b == 0 else "warm"
                print(f"batch {b} ({state}, {wall * 1e3:.1f}ms): "
                      f"identical={same}")
            if not same:
                break
    print(f"sequential == cluster({transport}, {args.hosts} hosts): {same}")
    print(netlog.cluster_report(dep.plan, out.reports, events=dep.events))
    if not same:
        raise SystemExit(1)
    return img


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--bands", type=int, default=8)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card; 'cpu' runs the "
                         "kernel's plain version)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="partition the farm over N hosts "
                         "(cluster runtime; 0 = single host)")
    ap.add_argument("--transport", default="pipe",
                    choices=["inprocess", "pipe", "device", "jaxmesh",
                             "shm"],
                    help="cluster channel transport (with --hosts); "
                         "jaxmesh means device, shm is refused")
    ap.add_argument("--batches", type=int, default=1,
                    help="batches to stream through ONE warm deployment "
                         "(with --hosts): batch 0 pays spawn and build, "
                         "the rest run at steady-state speed")
    ap.add_argument("--timeout-s", type=float, default=300.0,
                    help="a batch that takes longer fails (with --hosts)")
    ap.add_argument("--kill-host", type=int, default=-1, metavar="N",
                    help="refused: elastic recovery is a later slice")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the reference's sake; no effect "
                         "(on the card the kernel always runs)")
    ap.add_argument("--ascii", action=argparse.BooleanOptionalAction,
                    default=True, help="print the image as text "
                    "(--no-ascii at full width)")
    args = ap.parse_args()

    H, W = args.height, args.width
    factory = (workloads.mandelbrot_factory, (W, H, args.bands, args.iters))
    net = workloads.mandelbrot_factory(*factory[1])

    # sequential oracle — every mode below must match it bit for bit
    seq_img = workloads.assemble(
        run_sequential(net, args.bands, device=args.device)["collect"])

    if args.hosts:
        img = run_cluster_mode(args, net, factory, seq_img, args.device)
    else:
        cn = build(net, device=args.device)
        img = workloads.assemble(cn.run(instances=args.bands)["collect"])
        print(f"sequential == parallel: {bool(np.array_equal(img, seq_img))}")
        strm = workloads.assemble(cn.run_streaming(
            instances=args.bands,
            microbatch_size=max(args.bands // 4, 1))["collect"])
        print(f"sequential == streaming: "
              f"{bool(np.array_equal(strm, seq_img))}  "
              f"[{cn.stream_stats.summary()}]")

    if args.ascii:
        step = max(args.iters // (len(CHARS) - 1), 1)
        for r in range(0, H, 2):
            print("".join(CHARS[min(img[r, c] // step, len(CHARS) - 1)]
                          for c in range(W)))

    if not args.hosts:
        # the whole image in one kernel call against the farm's bands
        from repro_torch.device import resolve_device
        from repro_torch.kernels.mandelbrot import ops as mb_ops
        full = mb_ops.mandelbrot(H, W, x0=-2.2, y0=-1.15,
                                 pixel_delta=3.0 / W,
                                 max_iterations=args.iters,
                                 device=resolve_device(args.device))
        print(f"kernel == farm image: "
              f"{bool(np.array_equal(full.cpu().numpy(), img))}")


if __name__ == "__main__":
    main()
