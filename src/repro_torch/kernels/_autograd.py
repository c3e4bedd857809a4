"""A gradient for every kernel op: the launch forward, the plain version
backward.

A CUDA kernel writes into a fresh tensor that carries no ``grad_fn``, so a
bare launch would cut the autograd graph and drop, without an error, every
gradient term that passes through it.  :func:`launch` puts the launch
inside a ``torch.autograd.Function`` whenever a gradient can be asked for:
its forward is the launch itself, unchanged (the same launches, the same
count); its backward recomputes the op's plain version (``ref``) on
detached copies of the saved inputs under grad mode and differentiates it.
The JAX package's kernels have no backward of their own (there is no
``custom_vjp`` in it), so the gradient is that of the function the kernel
computes, through its plain version.

Under ``torch.no_grad()`` or ``torch.inference_mode()``, or when no input
requires grad, the kernel runs as a bare call and builds no graph.  The
ops' CPU branches run the plain versions, which are differentiable, and do
not come here.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["launch", "PROFILE_LABEL"]

# the profiler range around each backward, so a trace can give the plain
# backwards' share of a training step
PROFILE_LABEL = "kernel_op_plain_backward"


def launch(kernel: Callable, plain: Callable, *args, **kw):
    """``kernel(*args, **kw)``.  When grad mode is on and a tensor of
    ``args`` requires grad, the call runs inside a Function whose backward
    is that of ``plain(*args, **kw)``: ``plain`` must compute what
    ``kernel`` computes, with the same outputs (one tensor or a tuple).
    ``kw`` holds no tensor."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return _KernelOp.apply(kernel, plain, kw, *args)
    return kernel(*args, **kw)


class _KernelOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, kw, *args):
        ctx.plain, ctx.kw = plain, kw
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a, t in zip(args, ctx.is_tensor) if t))
        return kernel(*args, **kw)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        saved = iter(ctx.saved_tensors)
        inputs = [next(saved).detach().requires_grad_(n) if t else other
                  for t, other, n in zip(ctx.is_tensor, ctx.others, need)]
        wanted = [x for x, t, n in zip(inputs, ctx.is_tensor, need)
                  if t and n]
        with torch.profiler.record_function(PROFILE_LABEL), \
                torch.enable_grad():
            outs = ctx.plain(*inputs, **ctx.kw)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            got = (torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and wanted else [None] * len(wanted))
        it = iter(got)
        return (None, None, None) + tuple(
            next(it) if t and n else None
            for t, n in zip(ctx.is_tensor, need))
