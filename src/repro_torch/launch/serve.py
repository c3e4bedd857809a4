"""Serving launcher: a :class:`~repro_torch.serve.ServeEngine` over the
local decode backend, on the card by default.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 8
    python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced \\
        --device cpu --requests 4 --slots 2 --max-new 4

The flags and report lines are those of the JAX package's serve launcher
for its in-process backend (``--hosts 0``), plus ``--device``.
``--arrival-rate R`` replays an open-loop Poisson arrival trace at R
requests/s instead of submitting everything up front; the report adds TTFT
and per-token latency percentiles over the completed responses.  A decode
farm across hosts (``--hosts N``) comes with the cluster slice.
"""

from __future__ import annotations

import argparse
import random
import sys
import time


def _pct(xs: list, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(len(ys) * q / 100.0))]


def requests(n: int, vocab: int, max_new: int) -> list:
    """The launcher's request set: request i has a prompt of 3 + i % 5
    tokens ``(7 i + j) % (vocab - 1) + 1`` and ``max_new // 2 +
    (i % max_new) // 2 + 1`` new tokens."""
    from ..serve import Request
    return [Request(
        rid=i,
        prompt=tuple((7 * i + j) % (vocab - 1) + 1 for j in range(3 + i % 5)),
        max_new=max_new // 2 + (i % max_new) // 2 + 1)
        for i in range(n)]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="model architecture name (see repro_torch.configs)")
    ap.add_argument("--reduced", action="store_true",
                    help="CI-sized config: same wiring, tiny dims")
    ap.add_argument("--hosts", type=int, default=0,
                    help="simulated host count (0 = stay in-process; the "
                         "only value ported so far)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--n-slots", "--slots", dest="n_slots", type=int,
                    default=4, help="decode slot-batch width")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrivals per second "
                         "(0 = submit everything up front)")
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival-trace seed")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Serve the request set; prints the report and returns the responses
    in completion order."""
    args = parse_args(argv)
    if args.hosts > 0:
        raise SystemExit("--hosts > 0: the clustered decode farm comes with "
                         "the port's cluster slice; use --hosts 0")

    from ..serve import LocalDecodeBackend, ServeEngine, build_decode_model

    model, params = build_decode_model(("model", args.arch, args.reduced),
                                       device=args.device)
    backend = LocalDecodeBackend(model, params, n_slots=args.n_slots,
                                 max_len=args.max_len)
    where = f"local {backend.device}"
    reqs = requests(args.requests, model.cfg.vocab, args.max_new)
    rng = random.Random(args.seed)
    due, t = [], 0.0
    for _ in reqs:
        if args.arrival_rate > 0:
            t += rng.expovariate(args.arrival_rate)
        due.append(t)

    t0 = time.monotonic()
    with ServeEngine(backend) as eng:
        i = 0
        while i < len(reqs) or eng.pending or eng._live:
            now = time.monotonic() - t0
            while i < len(reqs) and due[i] <= now:
                eng.submit(reqs[i])
                i += 1
            if eng.pending or eng._live:
                eng.step()
            elif i < len(reqs):
                time.sleep(max(0.0, due[i] - (time.monotonic() - t0)))
        done = list(eng.completed)
        dt = time.monotonic() - t0
        toks = sum(len(r.tokens) for r in done)
        steps = eng.steps_run
    print(f"[serve] {args.arch} ({where}): {len(done)} requests, {toks} "
          f"tokens in {dt:.2f}s ({toks / max(dt, 1e-9):.1f} tok/s) over "
          f"{steps} farm steps "
          f"(mean occupancy {toks / max(steps, 1):.2f}/{args.n_slots})")
    ttfts = [r.ttft * 1e3 for r in done]
    tpots = [r.tpot * 1e3 for r in done if len(r.tokens) > 1]
    if ttfts:
        line = (f"[serve] ttft p50 {_pct(ttfts, 50):.1f}ms "
                f"p99 {_pct(ttfts, 99):.1f}ms")
        if tpots:
            line += (f" | tpot p50 {_pct(tpots, 50):.2f}ms "
                     f"p99 {_pct(tpots, 99):.2f}ms")
        print(line)
    for r in done[:4]:
        print(f"  req {r.rid}: prompt {list(r.prompt)} -> {list(r.tokens)} "
              f"[{r.finish_reason}]")
    return done


if __name__ == "__main__":
    main(sys.argv[1:])
