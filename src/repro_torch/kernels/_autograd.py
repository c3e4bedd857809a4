"""The kernel ops' guard against a silent cut of the autograd graph.

A CUDA kernel writes into a fresh tensor that carries no ``grad_fn``, so a
``backward()`` through a launch would drop every gradient term that passes
through it, without an error.  Until each op has a
``torch.autograd.Function`` with a backward, its CUDA branch refuses to run
where a gradient is asked for.  The CPU branch runs the plain versions,
which are differentiable, and needs no guard.
"""

from __future__ import annotations

import torch


def refuse_grad(op: str, *tensors) -> None:
    """Raise before a launch when grad mode is on and an input requires
    grad (``None`` entries are skipped)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: an input requires grad, but the CUDA kernel has no "
            "backward yet, so the launch would cut the autograd graph; run "
            "under torch.no_grad() / torch.inference_mode(), detach the "
            "inputs, or take the gradient on the CPU")
