"""The port's flash attention against the JAX package's, on the CPU.

The same numpy-seeded q, k, v go through the JAX op (its Pallas kernel in
interpret mode, and its jnp oracle) and through the port's wrapper, which on
a CPU tensor runs the plain PyTorch version of the CUDA kernel.  Shapes and
tolerances are those of ``tests/test_kernels.py``: 2e-4 in float32, 5e-2 in
bfloat16, 1e-5 for chunked against dense.  The CUDA kernel itself is held
against the plain version on the card by ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

SHAPES = [
    (1, 4, 2, 64, 32),   # GQA
    (2, 8, 1, 96, 64),   # MQA
    (2, 4, 4, 128, 32),  # MHA
    (1, 2, 2, 33, 16),   # ragged seq (the TPU wrapper's padding path)
]


def _qkv(rng, B, H, K, Sq, Sk, D, q_scale=0.3, k_scale=0.3):
    q = (rng.normal(size=(B, H, Sq, D)) * q_scale).astype(np.float32)
    k = (rng.normal(size=(B, K, Sk, D)) * k_scale).astype(np.float32)
    v = rng.normal(size=(B, K, Sk, D)).astype(np.float32)
    return q, k, v


def _jax(fn, q, k, v, dtype=jnp.float32, **kw):
    out = fn(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
             jnp.asarray(v, dtype), causal=True, **kw)
    return np.asarray(out, np.float32)


def _ours(fn, q, k, v, dtype=torch.float32, **kw):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
             causal=True, **kw)
    return out.float().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=["gqa", "mqa", "mha",
                                               "ragged33"])
def test_causal_vs_jax(shape):
    B, H, K, S, D = shape
    q, k, v = _qkv(np.random.default_rng(S), B, H, K, S, S, D)
    ours = _ours(fa_ops.mha, q, k, v)
    for theirs in (_jax(jfa_ops.mha, q, k, v, block_q=32, block_k=32,
                        interpret=True),
                   _jax(jfa_ref.mha, q, k, v)):
        np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)


def test_decode_shape_vs_jax():
    """Sq = 1 against a kv sequence of 80: the causal diagonal sits at the
    end, so the one query attends everywhere."""
    q, k, v = _qkv(np.random.default_rng(1), 2, 4, 2, 1, 80, 32, 1.0, 1.0)
    ours = _ours(fa_ops.mha, q, k, v)
    for theirs in (_jax(jfa_ops.mha, q, k, v, block_q=32, block_k=32,
                        interpret=True),
                   _jax(jfa_ref.mha, q, k, v)):
        np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)


def test_bf16_vs_jax():
    q, k, v = _qkv(np.random.default_rng(2), 1, 2, 2, 64, 64, 32, 1.0, 1.0)
    ours = _ours(fa_ops.mha, q, k, v, dtype=torch.bfloat16)
    for theirs in (_jax(jfa_ops.mha, q, k, v, dtype=jnp.bfloat16,
                        block_q=32, block_k=32, interpret=True),
                   _jax(jfa_ref.mha, q, k, v, dtype=jnp.bfloat16)):
        np.testing.assert_allclose(ours, theirs, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("shape", [
    (1, 4, 2, 64, 64, 16, 16), (2, 2, 1, 96, 96, 8, 32),
    (1, 2, 2, 40, 80, 16, 8)])
def test_chunked_equals_dense_and_jax(shape):
    B, H, K, Sq, Sk, D, ck = shape
    q, k, v = _qkv(np.random.default_rng(Sq + Sk), B, H, K, Sq, Sk, D,
                   1.0, 1.0)
    dense = _ours(fa_ref.mha, q, k, v)
    chunked = _ours(fa_ref.mha_chunked, q, k, v, chunk=ck)
    np.testing.assert_allclose(dense, chunked, rtol=1e-5, atol=1e-5)
    theirs = _jax(jfa_ref.mha_chunked, q, k, v, chunk=ck)
    np.testing.assert_allclose(chunked, theirs, rtol=2e-4, atol=2e-4)


@settings(max_examples=10, deadline=None)
@given(sq=st.integers(1, 40), extra=st.integers(0, 40))
def test_causality_property(sq, extra):
    """Changing future keys never changes the output (the causal contract
    that the KV cache relies on)."""
    rng = np.random.default_rng(sq * 100 + extra)
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(rng, 1, 2, 1, sq, sq + extra, 16, 1.0, 1.0))
    out1 = fa_ops.mha(q, k, v, causal=True)
    if extra > 0:
        k2, v2 = k.clone(), v.clone()
        k2[:, :, -1] += 10.0
        v2[:, :, -1] += 10.0
        out2 = fa_ops.mha(q, k2, v2, causal=True)
        torch.testing.assert_close(out1[:, :, :sq - 1], out2[:, :, :sq - 1],
                                   rtol=1e-5, atol=1e-5)


def test_plain_version_keeps_jax_rounding_of_probs():
    """In bf16 the plain version rounds the probabilities to v's type before
    the PV product, as the JAX oracle does (``probs.astype(v.dtype)``)."""
    q, k, v = _qkv(np.random.default_rng(3), 1, 2, 1, 16, 16, 16, 1.0, 1.0)
    ours = _ours(fa_ref.mha, q, k, v, dtype=torch.bfloat16)
    theirs = _jax(jfa_ref.mha, q, k, v, dtype=jnp.bfloat16)
    np.testing.assert_allclose(ours, theirs, rtol=1e-2, atol=1e-2)


def test_wrapper_validates_and_counts_no_cpu_launch():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    before = fa_ops.mha.launches
    assert fa_ops.mha(q, k, k).shape == (1, 4, 8, 16)
    assert fa_ops.mha.launches == before  # the CPU runs the plain version
    with pytest.raises(ValueError, match="Sq <= Sk"):
        fa_ops.mha(q, k[:, :, :4], k[:, :, :4], causal=True)
    with pytest.raises(ValueError, match="does not fit"):
        fa_ops.mha(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    noncausal = fa_ops.mha(q[:, :, :8], k[:, :, :4], k[:, :, :4],
                           causal=False)
    assert noncausal.shape == (1, 4, 8, 16)
