"""Gradients through the kernel ops on the CPU, against ``jax.grad``.

On a CUDA tensor every kernel op refuses an input that requires grad while
grad mode is on, because its kernel has no backward yet
(``test_torch_gpu.py::test_kernel_ops_refuse_grad_on_card``).  The refusal
is confined to the card: on a CPU tensor the ops run their plain versions,
which carry gradients.  Here the same numpy-seeded inputs and cotangent go
through the port's op (``torch.autograd``) and through the JAX package's
plain op (``jax.grad`` of the same scalar, the sum of output times
cotangent), and the gradients of every floating input must agree.

Tolerances: float32 throughout; rtol 2e-4 / atol 2e-5 for attention, the
grouped matmul and the stencil (sums of tens of products taken in another
order), rtol 1e-3 / atol 1e-4 for the SSD scan, whose gradient runs through
exp of cumulative decays in both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.moe_gmm import ref as jgmm_ref
from repro.kernels.ssd_scan import ops as jssd_ops
from repro.kernels.stencil import ref as jst_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.stencil import ops as st_ops


def _torch_grads(fn, arrays, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    assert out.grad_fn is not None  # the CPU path stays in the graph
    (out * torch.from_numpy(cot)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _jax_grads(fn, arrays, cot):
    def loss(*xs):
        return jnp.sum(fn(*xs) * jnp.asarray(cot))
    grads = jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    return [np.asarray(g) for g in grads]


def _check(fn_torch, fn_jax, arrays, out_shape, rtol, atol, seed=0):
    cot = np.random.default_rng(seed + 100).normal(
        size=out_shape).astype(np.float32)
    before = launch_counts()
    ours = _torch_grads(fn_torch, arrays, cot)
    assert launch_counts() == before  # the plain version, no launch
    theirs = _jax_grads(fn_jax, arrays, cot)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert np.abs(a).max() > 0, f"input {i}: zero gradient"
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"input {i}")


@pytest.mark.parametrize("shape,causal", [
    ((2, 4, 2, 12, 12, 8), True),    # GQA, causal
    ((1, 2, 1, 5, 9, 8), True),      # Sq < Sk: the diagonal at the end
    ((2, 4, 4, 7, 7, 16), False),    # an encoder
    ((1, 4, 2, 3, 11, 8), False),    # cross-attention, Sq < Sk
], ids=["gqa-causal", "decode-causal", "encoder", "cross"])
def test_mha_grads_match_jax(shape, causal):
    B, H, K, Sq, Sk, D = shape
    rng = np.random.default_rng(Sq * 10 + Sk)
    q = (rng.normal(size=(B, H, Sq, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, K, Sk, D)) * 0.5).astype(np.float32)
    v = rng.normal(size=(B, K, Sk, D)).astype(np.float32)
    _check(lambda *t: fa_ops.mha(*t, causal=causal),
           lambda *t: jfa_ref.mha(*t, causal=causal),
           [q, k, v], (B, H, Sq, D), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("groups", ["G1", "GH"])
def test_ssd_grads_match_jax(groups):
    b, S, H, P, N = 2, 32, 4, 8, 8
    G = 1 if groups == "G1" else H
    rng = np.random.default_rng(G)
    x = rng.normal(size=(b, S, H, P)).astype(np.float32)
    dt = (rng.random((b, S, H)) * 0.2).astype(np.float32)
    A = (-rng.random(H) - 0.1).astype(np.float32)
    B = (rng.normal(size=(b, S, G, N)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, S, G, N)) * 0.3).astype(np.float32)
    _check(lambda *t: ssd_ops.ssd(*t, chunk=16),
           lambda *t: jssd_ops.ssd(*t, chunk=16),
           [x, dt, A, B, C], (b, S, H, P), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("T,D,F,E", [(40, 16, 24, 4), (33, 8, 16, 2)])
def test_moe_apply_grads_match_jax(T, D, F, E):
    rng = np.random.default_rng(T)
    x = rng.normal(size=(T, D)).astype(np.float32)
    eo = rng.integers(0, E, T).astype(np.int32)
    w = (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32)
    _check(lambda xt, wt: gmm_ops.moe_apply(xt, torch.from_numpy(eo), wt),
           lambda xj, wj: jgmm_ref.gmm(xj, jnp.asarray(eo), wj),
           [x, w], (T, F), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_stencil_grads_match_jax(k):
    rng = np.random.default_rng(k)
    img = rng.normal(size=(20, 18)).astype(np.float32)
    kern = rng.normal(size=(k, k)).astype(np.float32)
    taps = st_ops.taps_of(kern)
    _check(lambda t: st_ops.stencil2d(t, taps),
           lambda j: jst_ref.stencil2d(j, jnp.asarray(kern)),
           [img], (20, 18), rtol=2e-4, atol=2e-5)
