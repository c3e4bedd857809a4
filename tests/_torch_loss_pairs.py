"""Shared by the loss and gradient parity files: one reduced architecture
in both packages on the same weights, and the loss with its gradient
through each (``jax.value_and_grad``; ``torch.autograd.grad`` over the
port's leaves)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.utils._pytree as pytree

from _torch_dist_worlds import configure, variant
from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model


def pair(arch_id, **overrides):
    """(JAX model, JAX params, port model, port params) on the same
    weights: the port's seed-0 draw (the reference's distributions) as a
    numpy tree, carried to the port by ``params_from_numpy`` and to the JAX
    package as arrays of the same nesting (drawing the reference's own
    ``PRNGKey(0)`` weights takes seconds a model on one core).  The JAX
    side trains on its plain paths (``use_pallas=False``), as its configs
    do."""
    arch, extra = variant(arch_id)
    overrides = {**extra, **overrides}
    jm = JModel(configure(jget_config(arch, reduced=True), overrides))
    m = Model(configure(get_config(arch, reduced=True), overrides))
    like = m.init(seed=0, device="cpu")
    weights = pytree.tree_map(lambda t: t.numpy(), like)
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    return jm, jp, m, params_from_numpy(weights, "cpu", like=like)


def batch(shape=(2, 24), vocab=200, seed=0):
    """A numpy {"tokens", "labels"} batch of int32 ids below ``vocab``."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, shape, dtype=np.int32),
            "labels": rng.integers(0, vocab, shape, dtype=np.int32)}


def jax_loss_grads(jm, jp, nb):
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb), has_aux=True))(jp)
    return float(loss), grads


def torch_loss_grads(m, p, nb):
    """(loss, metrics, grads) of the port; a leaf the loss does not reach
    gets a zero gradient, as ``jax.grad`` gives it."""
    leaves, spec = pytree.tree_flatten(p)
    live = [x.detach().requires_grad_(True) for x in leaves]
    loss, metrics = m.loss_fn(pytree.tree_unflatten(live, spec),
                              {k: torch.from_numpy(v) for k, v in nb.items()})
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return float(loss.detach()), metrics, pytree.tree_unflatten(grads, spec)


def max_grad_diff(grads, jgrads) -> float:
    theirs = params_from_numpy(jax.tree_util.tree_map(np.asarray, jgrads),
                               "cpu", like=grads)
    return max(float((a - b).abs().max()) for a, b in
               zip(pytree.tree_leaves(grads), pytree.tree_leaves(theirs)))
