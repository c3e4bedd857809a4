"""Serving demo on the PyTorch port: a continuous-batching farm over a
batched decode step.

Mixed-length requests stream through a fixed slot pool (OneFanAny at the
request layer); the output equals independent per-request generation.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2-0.5b

The counterpart of ``examples/serve_lm.py`` (the same requests, the reduced
config, weights from seed 0), on the card unless ``--device cpu``; it also
prints a sequential == farm line: each request decoded alone in a one-slot
engine gives the farm's tokens.
"""

import argparse
import time
import warnings

from repro_torch.serve import (FarmScheduler, LocalDecodeBackend, Request,
                               ServeEngine, build_decode_model)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card)")
    args = ap.parse_args()

    model, params = build_decode_model(("model", args.arch, True),
                                       device=args.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        sched = FarmScheduler(model, params, n_slots=args.slots, max_len=96)
    reqs = [Request(rid=i,
                    prompt=[(13 * i + j) % 200 + 1 for j in range(2 + i % 4)],
                    max_new=4 + (i * 3) % 9)
            for i in range(args.requests)]
    for r in reqs:
        sched.submit(r)
    t0 = time.monotonic()
    done = sched.run()
    dt = time.monotonic() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"[serve_lm] {args.arch}: {len(done)} reqs, {toks} tokens, "
          f"{dt:.2f}s → {toks / dt:.1f} tok/s; "
          f"{sched.steps_run} farm steps, mean occupancy "
          f"{toks / max(sched.steps_run, 1):.2f}/{args.slots}")
    for r in sorted(done, key=lambda r: r.rid)[:5]:
        print(f"  req {r.rid}: {list(r.prompt)} → {r.generated}")

    same = True
    for r in reqs:  # each request alone in a one-slot engine
        eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=1,
                                             max_len=96))
        eng.submit(r)
        eng.run_until_drained()
        same &= list(eng.poll(r.rid).tokens) == r.generated
    print(f"sequential == farm: {same}")
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
