"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the training loop, which is the GPP network ``Emit(data) →
OneFanAny(batch axes) → Worker(train_step) → AnyFanOne → Collect(metrics)``,
with checkpointing, on the card unless ``--device`` says otherwise:

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 8 \\
        --batch 4 --seq 1024
    python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
        --device cpu --steps 8 --batch 4 --seq 32

The flags are those of the JAX package's training launcher, plus
``--device`` and ``--seed`` (the weights' seed).  ``--mesh single|multi``
parses and is refused: the production mesh comes with the port's
multi-device slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from ._common import add_model_flags, refuse_later_flags


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(ap)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="none",
                    choices=("none", "single", "multi"),
                    help="production mesh of the JAX package's launcher; "
                         "refused here (multi-device comes last, ROADMAP "
                         "§1 item 12)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel activations (a mesh lever; "
                         "nothing to shard on one device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights (the data's is 0)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; prints the verified network, the history and the loss line,
    and returns what :func:`repro_torch.train.train` returns."""
    args = parse_args(argv)
    refuse_later_flags(args)
    if args.mesh != "none":
        raise SystemExit(
            f"--mesh {args.mesh}: the production mesh shards over several "
            "devices; the port's multi-device path comes last (ROADMAP §1 "
            "item 12)")

    from ..configs import get_config
    from ..core import verify
    from ..data import SyntheticLM
    from ..device import resolve_device
    from ..models import Model
    from ..train import AdamW, Checkpointer, cosine_warmup, train
    from ..train.train_loop import as_network

    cfg = get_config(args.arch, reduced=args.reduced)
    cfg = dataclasses.replace(cfg, seq_shard=args.seq_shard)
    model = Model(cfg)
    opt = AdamW(lr=cosine_warmup(args.lr, warmup=max(args.steps // 20, 1),
                                 total=args.steps))
    # the network formulation is verified before anything runs (gppBuilder)
    net = as_network(model, opt, grad_accum=args.grad_accum)
    report = verify(net)
    print(f"[train] network {net.name} verified: {report.checks}")

    dev = resolve_device(args.device)
    source = SyntheticLM(batch=args.batch, seq=args.seq, vocab=cfg.vocab,
                         device=dev)
    ckpt = Checkpointer(args.ckpt_dir, async_save=True) \
        if args.ckpt_dir else None
    res = train(model, source, steps=args.steps, opt=opt,
                grad_accum=args.grad_accum, seed=args.seed, device=dev,
                checkpointer=ckpt,
                ckpt_every=args.ckpt_every if ckpt else 0)
    if ckpt:
        ckpt.wait()
    print(json.dumps(res["history"], indent=1))
    first, last = res["history"][0]["loss"], res["history"][-1]["loss"]
    print(f"[train] {args.arch}: loss {first:.4f} -> {last:.4f} in "
          f"{res['step']} steps")
    return res


if __name__ == "__main__":
    main()
