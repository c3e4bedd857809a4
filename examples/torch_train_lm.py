"""End-to-end LM training on the PyTorch port, with an injected failure.

Trains a decoder LM on the synthetic stream with the whole training
substrate engaged: the train step as a verified GPP network, AdamW with a
cosine schedule, gradient accumulation, async atomic checkpoints, and a
failure injected at mid-run that ``FaultTolerantRunner`` recovers from the
last checkpoint.  On the card unless ``--device`` says otherwise.

Sizes:
  --size tiny   ~4M params (4 layers, d=256, vocab 2048)
  --size 100m   ~100M params (12 layers, d=640, vocab 32000)

    PYTHONPATH=src python examples/torch_train_lm.py --size tiny --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --steps 20 --batch 2 --seq 32
"""

import argparse
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.core import verify
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.train import (AdamW, Checkpointer, FaultInjector,
                               FaultTolerantRunner, cosine_warmup,
                               make_train_step)
from repro_torch.train.train_loop import as_network

SIZES = {
    "tiny": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                 d_ff=1024, vocab=2048),
    "100m": dict(n_layers=12, d_model=640, n_heads=10, n_kv_heads=2,
                 d_ff=2560, vocab=32_000),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=SIZES, default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--no-failure", dest="inject_failure",
                    action="store_false",
                    help="run without the mid-run failure")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ModelConfig(name=f"lm-{args.size}", family="dense",
                      qkv_bias=False, tied_embeddings=True,
                      param_dtype="float32", compute_dtype="float32",
                      remat="none", **SIZES[args.size])
    model = Model(cfg)
    params = model.init(seed=args.seed, device=dev)
    print(f"[train_lm] {cfg.name}: {model.param_count(params) / 1e6:.1f}M "
          f"params on {dev}, {args.steps} steps of batch "
          f"{args.batch}×{args.seq}")

    opt = AdamW(lr=cosine_warmup(args.lr, warmup=args.steps // 10,
                                 total=args.steps))
    verify(as_network(model, opt, grad_accum=args.grad_accum))
    src = SyntheticLM(batch=args.batch, seq=args.seq, vocab=cfg.vocab,
                      device=dev)
    step = make_train_step(model, opt, grad_accum=args.grad_accum)
    state = {"params": params, "opt_state": opt.init(params)}
    losses = []

    def step_fn(i, st):
        p, o, metrics = step(st["params"], st["opt_state"], src.create(i))
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"  step {i:>5}  loss {float(metrics['loss']):.4f}  "
                  f"ppl {float(metrics['perplexity']):.1f}  "
                  f"|g| {float(metrics['grad_norm']):.2f}  "
                  f"lr {float(metrics['lr']):.2e}")
        losses.append(float(metrics["loss"]))
        return {"params": p, "opt_state": o}

    with tempfile.TemporaryDirectory() as ckdir:
        runner = FaultTolerantRunner(Checkpointer(ckdir, async_save=True),
                                     max_restarts=3)
        injector = FaultInjector(
            fail_at=(args.steps // 2,) if args.inject_failure else ())
        runner.run(total_steps=args.steps, state=state, step_fn=step_fn,
                   save_every=max(args.steps // 10, 1), injector=injector)
        runner.ckpt.wait()
    print(f"[train_lm] done. restarts survived: {runner.restarts}; "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f}")
    if args.inject_failure and runner.restarts != 1:
        raise SystemExit("the injected failure was not recovered")
    if not losses[-1] < losses[0]:
        raise SystemExit("no learning happened")


if __name__ == "__main__":
    main()
