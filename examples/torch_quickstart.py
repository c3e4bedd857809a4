"""Quickstart: Monte-Carlo π as a GPP farm (paper §3, Listings 1–4), on the
PyTorch port.

The user writes three sequential methods (create / getWithin / collector) —
the library provides the parallel architecture, formal verification, the
sequential oracle, and integrated logging.

    PYTHONPATH=src python examples/torch_quickstart.py

The counterpart of ``examples/quickstart.py``, on the card unless
``--device cpu``.  Each item draws its points from a ``torch.Generator``
seeded with its index, so the estimate is identical across the port's
modes but not bit-equal to the reference's (threefry's bits cannot be
reproduced).  The same network deploys across hosts unchanged: see
``examples/torch_mandelbrot.py --hosts 2``.
"""

import argparse

from repro_torch import workloads
from repro_torch.core import build, csp, netlog, run_sequential
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=256)
    ap.add_argument("--points", type=int, default=10_000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # the declarative network (paper Listing 2 — one pattern invocation)
    net = workloads.monte_carlo_pi(instances=args.instances,
                                   points=args.points, workers=args.workers)

    # 1. formal verification of the explicit process network (FDR4-lite)
    explicit = workloads.monte_carlo_pi(instances=args.instances,
                                        points=args.points, workers=2,
                                        explicit=True)
    r = csp.check(explicit, instances=3)
    print(f"[csp] states={r.n_states} deadlock_free={r.deadlock_free} "
          f"deterministic={r.deterministic} "
          f"terminates={r.all_paths_terminate}")

    # 2. sequential oracle (paper Listing 4 — same methods, plain loop)
    pi_seq = float(run_sequential(net, args.instances, device=dev)["collect"])
    print(f"[seq] pi = {pi_seq:.5f}")

    # 3. the fused network
    cn = build(net, device=dev)
    pi_par = float(cn.run(instances=args.instances)["collect"])
    print(f"[par] pi = {pi_par:.5f}  (identical: {pi_seq == pi_par})")

    # 4. streaming microbatch execution (process-oriented throughput mode)
    pi_strm = float(cn.run_streaming(instances=args.instances,
                                     microbatch_size=32)["collect"])
    print(f"[stream] pi = {pi_strm:.5f}  (identical: {pi_seq == pi_strm})  "
          f"[{cn.stream_stats.summary()}]")

    # 5. integrated logging (paper §8) + visualisation (paper §13)
    cn.run(instances=args.instances, logged=True)
    print(netlog.report(cn))
    if not (pi_seq == pi_par == pi_strm):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
