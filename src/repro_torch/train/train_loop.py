"""Training step and loop.

``make_train_step`` builds the step function (gradient accumulation over
microbatches, mixed precision per config); ``as_network`` exposes the same
step as a GPP network, the paper's fundamental pattern with training
stages as processes: Emit(data) → OneFanAny(batch axes) → Worker(fwd/bwd
and update) → AnyFanOne → Collect(metrics).  The JAX package's
``train/train_loop.py``: where it takes ``jax.value_and_grad`` of the loss,
the step takes ``torch.autograd.grad`` over the parameter leaves; where it
jits the step with donated buffers, the step runs eagerly, and
``make_train_step(..., donate=True)`` writes the new weights and moments
into the old ones (:meth:`~repro_torch.train.AdamW.update_`), which
``train`` does with every tree it owns.

On the card every full-sequence attention, SSD scan and ragged MoE product
of the forward runs its hand-written kernel, and the backward goes through
the kernel ops' plain versions (:mod:`repro_torch.kernels._autograd`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree

from ..core import (AnyFanOne, Collect, Emit, Network, OneFanAny, Worker)
from ..core.stream import stack_microbatches
from ..data.pipeline import shard_batch
from ..device import resolve_device
from ..models import Model
from ..parallel.axes import ShardingRules, is_dtensor, shard_ctx
from ..parallel.sharding import P, NamedSharding, param_shardings, place
from .optimizer import AdamW

__all__ = ["TrainState", "make_train_step", "as_network", "train",
           "place_state"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads): the loss and its gradient with respect to
    every parameter leaf (zeros for a leaf the loss does not reach)."""
    leaves, spec = pytree.tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss_fn(pytree.tree_unflatten(live, spec),
                                      batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else
             # a sharded leaf's gradient takes the leaf's own placements
             # (a DTensor's gradient comes back as its backward left it)
             g.redistribute(p.device_mesh, p.placements) if is_dtensor(g)
             else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, pytree.tree_unflatten(grads, spec)


def make_train_step(model: Model, opt: AdamW, *, grad_accum: int = 1,
                    donate: bool = False) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  Nothing is written into the arguments, unless ``donate``:
    then the step consumes ``params`` and ``opt_state``, as the
    reference's ``donate_argnums=(0, 1)`` does, writing the update into
    them (:meth:`AdamW.update_`, the same bits) and dropping each gradient
    once applied, so the update adds two leaf chunks of temporaries to the
    weights, moments and gradients, not three more trees.

    ``grad_accum > 1`` splits the global batch into microbatches along the
    leading axis (:func:`repro_torch.core.stream.stack_microbatches`, the
    streaming runtime's splitter) and sums their gradients in float32;
    the loss is their mean and the other metrics are the last
    microbatch's, as the reference's scan gives them."""

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = _value_and_grad(model, params, batch)
        else:
            mb = stack_microbatches(batch, grad_accum)
            g_sum, l_sum = None, 0.0
            for i in range(grad_accum):
                l, metrics, g = _value_and_grad(
                    model, params, {k: v[i] for k, v in mb.items()})
                g = pytree.tree_map(lambda x: x.float(), g)
                g_sum = g if g_sum is None else pytree.tree_map(
                    torch.add, g_sum, g)
                l_sum = l_sum + l
            grads = pytree.tree_map(lambda x: x / grad_accum, g_sum)
            loss = l_sum / grad_accum
            del g, g_sum
        with torch.no_grad():
            if donate:  # the list is the only reference to the gradients
                grads = pytree.tree_leaves(grads)
                new_params, new_opt, stats = opt.update_(grads, opt_state,
                                                         params)
            else:
                new_params, new_opt, stats = opt.update(grads, opt_state,
                                                        params)
        return new_params, new_opt, dict(metrics, loss=loss, **stats)

    return step


def as_network(model: Model, opt: AdamW, *, grad_accum: int = 1,
               batch_axis: Any = ("pod", "data")) -> Network:
    """The training step as a GPP network (the declaration mirrors the
    paper's Listing 3).  The Worker carries (params, opt_state, batch)
    packed as the item; the Collect keeps the latest metrics."""
    step = make_train_step(model, opt, grad_accum=grad_accum)

    def worker_fn(item):
        params, opt_state, batch = item
        return step(params, opt_state, batch)

    net = Network(f"train[{model.cfg.name}]")
    net.add(
        Emit(lambda i: None, name="emit"),
        OneFanAny(axis=batch_axis, name="spread"),
        Worker(worker_fn, batched=True, name="train_step"),
        AnyFanOne(name="merge"),
        Collect(lambda acc, item: item[2], init=None, jit_combine=False,
                name="collect"),
    )
    return net


def place_state(params, opt_state, mesh, rules: ShardingRules):
    """(params, opt_state) as DTensors on ``mesh``: each parameter and its
    two moments by ``param_specs``, the step count replicated."""
    sh = param_shardings(params, mesh, rules)
    opt_sh = {"m": sh, "v": sh, "step": NamedSharding(mesh, P())}
    return place(params, sh), place(opt_state, opt_sh)


def _scalar(v) -> float:
    return float(v.full_tensor() if is_dtensor(v) else v)


def train(model: Model, source, *, steps: int, opt: Optional[AdamW] = None,
          mesh=None, grad_accum: int = 1, seed: int = 0, device=None,
          checkpointer=None, ckpt_every: int = 0, params=None,
          opt_state: Any = None, start_step: int = 0,
          log_every: int = 10, on_step=None) -> dict:
    """The end-to-end loop of the examples and ``launch/train.py``, on
    ``device`` (``None``: the card).  Without ``params`` the model's
    weights are drawn from ``seed``.  Returns {"params", "opt_state",
    "history", "step"}; each history entry holds the step's metrics as
    floats, its ``step`` and the ``wall_s`` since the loop started (a
    logged step waits for the device).

    Given a ``mesh`` (every rank of its world runs this loop), the weights
    and moments are placed by ``param_specs`` and each batch by
    ``batch_specs`` under ``train_rules(model.cfg.seq_shard)``, and every
    step runs under ``shard_ctx`` with those rules.

    A step donates the trees the loop owns (``donate=True``): weights it
    drew, moments it initialised, and whatever an earlier step returned.
    A caller's ``params`` or ``opt_state`` are never written: the first
    step from them is the pure one.  So ``on_step`` and a checkpointer see
    trees that the next step overwrites (``Checkpointer.save`` copies
    every leaf before it returns)."""
    opt = opt or AdamW()
    dev = resolve_device(device if mesh is None else mesh.device)
    owned = params is None and opt_state is None
    if params is None:
        params = model.init(seed=seed, device=dev)
    if opt_state is None:
        opt_state = opt.init(params)
    if mesh is not None:
        from ..launch.mesh import train_rules
        rules = train_rules(model.cfg.seq_shard)
        params, opt_state = place_state(params, opt_state, mesh, rules)
    pure_step = make_train_step(model, opt, grad_accum=grad_accum)
    donating_step = make_train_step(model, opt, grad_accum=grad_accum,
                                    donate=True)
    history = []
    t0 = time.monotonic()
    for i in range(start_step, start_step + steps):
        batch = source.create(i)
        batch = (shard_batch(batch, mesh, rules.batch) if mesh is not None
                 else {k: v.to(dev) for k, v in batch.items()})
        with (shard_ctx(mesh, rules) if mesh is not None
              else contextlib.nullcontext()):
            step_fn = donating_step if owned else pure_step
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        owned = True
        if on_step is not None:
            on_step(i, params, opt_state, metrics)
        if ckpt_every and checkpointer is not None \
                and (i + 1) % ckpt_every == 0:
            checkpointer.save(i + 1, {"params": params,
                                      "opt_state": opt_state})
        if (i - start_step) % log_every == 0 or i == start_step + steps - 1:
            m = {k: _scalar(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = time.monotonic() - t0
            history.append(m)
    return {"params": params, "opt_state": opt_state, "history": history,
            "step": start_step + steps}
