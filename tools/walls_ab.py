"""Host walls of the Mandelbrot farm and the image pipeline for one or more
checkouts of this repository, on one CUDA card, so that two versions can be
compared within one run.

    python3 tools/walls_ab.py [--reps N] TREE [TREE ...]

Each TREE is the root of a checkout.  Each runs in a process of its own, in
the order given (for an A/B: parent, change, change, parent), with
``TREE/src`` first on the import path, so its ``repro_torch`` and its
kernels run (built into ``TREE/build/kernels``).  A process measures the
workloads of ``chip_smoke.py``'s phases 2 and 3 (the 64-band farm of a
(2048, 4096) image at 1000 iterations; 16 images of 2048 x 2048 through
greyscale and EDGE5): for each mode (sequential, fused, streaming) the
median host wall of ``--reps`` runs after one warm-up, ending at a device
sync; and the host microseconds a band's ``mandelbrot`` call and a
``stencil2d`` call take while the device sleeps (median of ``--reps``
sweeps of 64 calls).  It prints one JSON line;
this script prints each line as it comes, then each tree's median, least
and greatest over its processes, beside the card's name and power limit.  Exits nonzero without a
card or if a process fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLEEP_CYCLES = 200_000_000  # ~100 ms at the H100's ~2 GHz clock


def measure(tree: Path, reps: int) -> dict:
    """One tree's walls (ms) and host costs (us a call)."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch import workloads
    from repro_torch.core import build, run_sequential
    from repro_torch.interop import tree_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels.mandelbrot import ops as mb
    from repro_torch.kernels.stencil import ops as st

    _build.build_all(["mandelbrot", "stencil"])
    dev = torch.device("cuda", 0)
    W, H, bands, iters, n_images, size = 4096, 2048, 64, 1000, 16, 2048
    farm = workloads.mandelbrot_farm(width=W, height=H, bands=bands,
                                     iterations=iters)
    images = tree_from_numpy(workloads.synthetic_images(n_images, size), dev)
    pipeline = workloads.image_pipeline(images)
    result = {"tree": str(tree)}
    for name, net, n, micro in (("farm", farm, bands, 16),
                                ("pipeline", pipeline, n_images, 4)):
        compiled = build(net)
        modes = {"sequential": lambda: run_sequential(net, n),
                 "fused": lambda: compiled.run(instances=n),
                 "streaming": lambda: compiled.run_streaming(
                     instances=n, microbatch_size=micro)}
        for mode, run in modes.items():
            run()  # warm-up
            torch.cuda.synchronize()
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            result[f"{name} {mode} ms"] = statistics.median(walls)

    band_h = H // bands
    rows0 = [torch.tensor(b * band_h, dtype=torch.int32, device=dev)
             for b in range(bands)]
    grey = images[0] @ torch.tensor(workloads.GREY, device=dev)
    calls = {"mandelbrot band": lambda r0: mb.mandelbrot(
                 band_h, W, x0=-2.2, y0=-1.15, pixel_delta=3.0 / W,
                 max_iterations=iters, row0=r0),
             "stencil2d": lambda r0: st.stencil2d(grey, workloads.EDGE5)}
    for name, call in calls.items():
        call(rows0[0])
        sweeps = []
        for _ in range(reps):
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)  # no launch waits on a full queue
            t0 = time.perf_counter()
            for r0 in rows0:
                call(r0)
            sweeps.append((time.perf_counter() - t0) / len(rows0) * 1e6)
        torch.cuda.synchronize()
        result[f"{name} host us"] = statistics.median(sweeps)
    return result


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("walls_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(measure(args.trees[0].resolve(), args.reps)))
        return 0
    print(f"gpu: {card()}")
    runs: dict = {}
    for tree in args.trees:
        proc = subprocess.run([sys.executable, __file__, "--one",
                               "--reps", str(args.reps), str(tree)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line)
        runs.setdefault(str(tree), []).append(json.loads(line))
    for tree, results in runs.items():
        keys = [k for k in results[0] if k != "tree"]
        print(f"{tree}, median [min, max] of {len(results)} processes: "
              + "; ".join(f"{k} {statistics.median(r[k] for r in results):.2f}"
                          f" [{min(r[k] for r in results):.2f}, "
                          f"{max(r[k] for r in results):.2f}]" for k in keys))
    return 0


if __name__ == "__main__":
    sys.exit(main())
