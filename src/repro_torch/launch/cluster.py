"""Cluster launcher: one GPP network, many hosts (paper §7), on the card.

    python -m repro_torch.launch.cluster --hosts 2 --transport pipe
    python -m repro_torch.launch.cluster --device cpu --hosts 3 \\
        --transport device --workload pipeline

Partitions the demo workload (a Mandelbrot row-band farm, each band
rendered by the Mandelbrot kernel, or a two-stage pipeline) over
``--hosts`` hosts, proves via the CSP checker that the partitioned network
trace-refines the unpartitioned one, streams the work through one executor
per host, verifies the result bit-identical to the sequential oracle, and
prints the cross-host netlog report.  Exits 1 on a divergence.

Durable deployments: ``--snapshot-every N --snapshot-dir DIR`` snapshots
each host's fold state every N chunks and the controller's meta at batch
boundaries; ``--resume-from DIR`` adopts a previous run's deployment from
DIR after its controller died (SIGKILLed mid-batch included), replays the
pending batch from the fold snapshots, then serves ``--batches`` more.

The flags and printed lines are the JAX package's launcher's, with
``device`` for its ``jaxmesh`` transport, plus ``--device``.  ``--cut
cost`` and ``--calibrate`` come with the cost model, and the autoscale
flags with the autoscaler; both refuse here.
"""

from __future__ import annotations

import argparse

from ._common import add_cluster_flags, apply_runtime_env

COSTS_SLICE = ("cost calibration (cluster/costs.py) comes with a later "
               "slice of the port")


# module-level factories: the process transports spawn fresh interpreters
# that rebuild the network from a picklable (callable, args) recipe

def make_mandelbrot(bands: int, height: int, width: int, iters: int):
    """The row-band farm whose fold is one int32 escape-count total: band
    i's top edge is ``-1.15 + delta * (i * band_h)``, rendered by the
    Mandelbrot kernel on the card (its plain version on the CPU) and
    folded as ``acc + cnt.sum()`` on the device (``jit_combine``)."""
    import torch

    from ..core import DataParallelCollect
    from ..kernels.mandelbrot.ops import mandelbrot

    band_h = height // bands
    delta = 3.0 / width

    def create(i):
        return torch.tensor(i * band_h, dtype=torch.int32)

    def render(row0):
        return mandelbrot(band_h, width, x0=-2.2, y0=-1.15,
                          pixel_delta=delta, max_iterations=iters,
                          row0=row0)

    return DataParallelCollect(
        create=create, function=render,
        collector=lambda acc, cnt: acc + cnt.sum(dtype=torch.int32),
        init=torch.tensor(0, dtype=torch.int32), workers=bands,
        jit_combine=True, name="mandelbrot")


def make_pipeline(scale: float):
    import torch

    from ..core import OnePipelineCollect
    return OnePipelineCollect(
        create=lambda i: torch.tensor(float(i)),
        stage_ops=[lambda x: x * x, lambda x: x * scale + 1.0],
        collector=lambda a, x: a + x, init=torch.tensor(0.0),
        jit_combine=True, name="pipeline")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_cluster_flags(ap, default_hosts=2, default_transport="pipe")
    ap.add_argument("--device", default=None,
                    help="torch device the hosts run on (default: the "
                         "card; 'cpu' on request)")
    ap.add_argument("--workload", default="mandelbrot",
                    choices=["mandelbrot", "pipeline"])
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--bands", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--batches", type=int, default=1,
                    help="batches through ONE warm deployment (batch 0 "
                         "pays spawn and build; the rest are steady-state)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record per-host trace rings, merge them on the "
                         "controller and export Chrome trace-event JSON "
                         "to PATH (open in chrome://tracing or Perfetto)")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="durable deployment: snapshot each host's fold "
                         "state every N chunks and the controller meta at "
                         "batch boundaries (needs --snapshot-dir)")
    ap.add_argument("--snapshot-dir", metavar="DIR", default=None,
                    help="where the durable deployment state lives")
    ap.add_argument("--resume-from", metavar="DIR", default=None,
                    help="ADOPT a previous run's durable state from DIR "
                         "instead of deploying fresh: bump the epoch, "
                         "re-prove the refinement, replay any pending "
                         "batch from the fold snapshots, then serve "
                         "--batches more")
    ap.add_argument("--cut", default="count", choices=["count", "cost"],
                    help="partition objective: 'count' balances process "
                         "counts per host; 'cost' (measured times) is "
                         "refused until the cost model is ported")
    ap.add_argument("--calibrate", action="store_true",
                    help="print the measured per-process cost profile; "
                         "refused until the cost model is ported")
    ap.add_argument("--coalesce-bytes", type=int, default=0, metavar="B",
                    help="transport fast path: coalesce small records into "
                         "one queue put / ring slot, up to B bytes per "
                         "flush (0 = per-record sends, the default)")
    args = ap.parse_args(argv)
    if args.cut == "cost" or args.calibrate:
        raise SystemExit(f"--cut cost / --calibrate: {COSTS_SLICE}")
    apply_runtime_env(args)
    return args


def _same(out, seq) -> bool:
    """Every Collect of ``out`` equal to the oracle's (compared on the
    CPU: a process host's result comes back there)."""
    return all(bool((out[k].cpu() == seq[k].cpu()).all()) for k in seq)


def main(argv=None) -> None:
    args = parse_args(argv)

    import time

    from ..cluster import ClusterDeployment, check_refinement, partition
    from ..core import netlog, run_sequential

    if args.workload == "mandelbrot":
        factory = (make_mandelbrot,
                   (args.bands, args.size, args.size, args.iters))
        instances = args.bands
    else:
        factory = (make_pipeline, (2.0,))
        instances = args.instances
    net = factory[0](*factory[1])
    seq = run_sequential(net, instances, device=args.device)
    same = True

    if args.resume_from:
        dep = ClusterDeployment.adopt(args.resume_from, factory=factory,
                                      transport=args.transport,
                                      trace=bool(args.trace))
        plan = dep.plan
        ev = dep.events[-1]
        print(plan.describe())
        print(f"[cluster] adopted durable deployment from "
              f"{args.resume_from}: epoch {dep.epoch}, "
              f"refined={ev.refined}", flush=True)
        if ev.refined is not True:
            dep.close()
            raise SystemExit(1)
    else:
        plan = partition(net, hosts=args.hosts)
        print(plan.describe())
        print(f"[cluster] CSP refinement (partitioned [T= unpartitioned, "
              f"both directions): {check_refinement(net, plan)}")
        dep = ClusterDeployment(net, plan=plan, transport=args.transport,
                                microbatch_size=args.microbatch,
                                factory=factory, trace=bool(args.trace),
                                snapshot_every=args.snapshot_every,
                                snapshot_dir=args.snapshot_dir,
                                coalesce_bytes=args.coalesce_bytes,
                                device=args.device)
    with dep:
        if args.resume_from and dep.controller._needs_recovery:
            t0 = time.perf_counter()
            rec = dep.recover()
            same = same and _same(rec, seq)
            ev = dep.events[-1]
            print(f"[cluster] replayed the pending batch from the fold "
                  f"snapshots in {(time.perf_counter() - t0) * 1e3:.1f}ms: "
                  f"identical={same} replay_from="
                  f"{dict(sorted(ev.replay_from.items()))}", flush=True)
        for b in range(max(args.batches, 1)):
            t0 = time.perf_counter()
            out = dep.run(instances=instances)
            wall = time.perf_counter() - t0
            same = same and _same(out, seq)
            if args.batches > 1:
                print(f"[cluster] batch {b} "
                      f"({'cold' if b == 0 else 'warm'}): "
                      f"{wall * 1e3:.1f}ms identical={same}", flush=True)
        depths = {f"{s}->{d}": n for (s, d), n
                  in dep.transport.channel_depths().items()}
        if args.trace:
            dep.export_trace(args.trace)
            merged = dep.merged_trace()
            print(f"[cluster] trace: {len(merged)} events from "
                  f"{len({e.host for e in merged})} host(s) -> {args.trace}")
            print(dep.metrics().describe())
    print(f"[cluster] {args.transport} over {len(plan.hosts())} hosts == "
          f"sequential oracle: {same}")
    print(netlog.cluster_report(plan, out.reports, depths=depths,
                                durability=dep.durable_events or None))
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
