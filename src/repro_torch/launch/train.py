"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the training loop, which is the GPP network ``Emit(data) →
OneFanAny(batch axes) → Worker(train_step) → AnyFanOne → Collect(metrics)``,
with checkpointing, on the card unless ``--device`` says otherwise:

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 8 \\
        --batch 4 --seq 1024
    python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
        --device cpu --steps 8 --batch 4 --seq 32

The flags are those of the JAX package's training launcher, plus
``--device`` and ``--seed`` (the weights' seed).  ``--virtual-devices N``
runs the launcher as a world of N local ranks (every rank on the CPU or,
sharing it, on the card): the ranks train one model SPMD over a mesh of
the world, the production mesh of ``--mesh single|multi`` (16×16 or
2×16×16, so a world of 256 or 512 ranks; another world is refused, naming
the size it needs) or, with ``--mesh none``, a ``data`` axis over every
rank.  Rank 0 prints.

    python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \
        --device cpu --steps 4 --batch 8 --seq 16 --virtual-devices 4
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

from ._common import add_model_flags


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(ap)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="none",
                    choices=("none", "single", "multi"),
                    help="production mesh (16x16 data x model, or "
                         "2x16x16 pod x data x model) over a world of "
                         "256 or 512 ranks")
    ap.add_argument("--virtual-devices", type=int, default=0, metavar="N",
                    help="run as a world of N local ranks (the JAX "
                         "package fakes N XLA host devices)")
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
    if args.virtual_devices:
        from .mesh import run_world
        _mesh(args, world=args.virtual_devices)  # refuse before spawning
        argv = list(sys.argv[1:] if argv is None else argv)
        i = argv.index("--virtual-devices")
        rest = argv[:i] + argv[i + 2:]
        return run_world(_rank_main, args.virtual_devices, rest,
                         device=args.device,
                         join_timeout=3600.0)[0]
    return _train(args)


def _rank_main(rank: int, argv: list) -> dict:
    """One rank of ``--virtual-devices``: the launcher inside the world
    (rank 0 prints); returns rank 0's result without its trees."""
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(
            sys.stdout if rank == 0 else quiet):
        res = _train(parse_args(argv))
    return {"history": res["history"], "step": res["step"]}


def _mesh(args, world: int = 0):
    """The mesh the flags ask for over the running world (or one of
    ``world`` ranks), or None."""
    import torch.distributed as dist

    from .mesh import make_mesh, make_production_mesh
    if not world:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if args.mesh != "none":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=args.device)
        if world != mesh.size:
            raise SystemExit(
                f"--mesh {args.mesh}: the production mesh {mesh.shape} needs "
                f"a world of {mesh.size} ranks, this is one of {world} "
                "(--virtual-devices N runs one)")
        return mesh
    return make_mesh((world,), ("data",), device=args.device) \
        if world > 1 else None


def _train(args) -> dict:
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

    mesh = _mesh(args)
    dev = resolve_device(args.device)
    source = SyntheticLM(batch=args.batch, seq=args.seq, vocab=cfg.vocab,
                         device=dev)
    ckpt = Checkpointer(args.ckpt_dir, async_save=True) \
        if args.ckpt_dir else None
    if mesh is not None:
        print(f"[train] mesh {mesh.shape} over {mesh.size} ranks")
    res = train(model, source, steps=args.steps, opt=opt, mesh=mesh,
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
