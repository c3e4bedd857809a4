"""The training loss's levers on the CPU: chunked cross-entropy, chunked
attention, activation checkpointing (remat) and the MoE's ragged path each
leave the loss and its gradients as they were, as in the JAX package's
``test_loss_chunk_equivalence`` and ``test_grads_identical``; the chunked
loss also equals the reference's.  Weights: the port's seed-0 draw, as in
``test_torch_loss_grads.py``; float32 throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from _torch_loss_pairs import (batch, jax_loss_grads, max_grad_diff, pair,
                               torch_loss_grads)
from repro_torch.models import Model, encdec, transformer


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def _variant(m, **overrides):
    return Model(dataclasses.replace(m.cfg, **overrides))


def test_loss_chunk_equivalence():
    """Chunked CE (the memory lever) is numerically the dense one, and the
    reference's chunked loss."""
    jm, jp, m, p = pair("qwen2-0.5b", loss_chunk=8)
    nb = batch((4, 32), seed=3)
    l_chunk, _, g_chunk = torch_loss_grads(m, p, nb)
    l_dense, _, g_dense = torch_loss_grads(_variant(m, loss_chunk=0), p, nb)
    assert abs(l_chunk - l_dense) < 1e-5
    assert _max_diff(g_chunk, g_dense) < 1e-5
    jloss, jgrads = jax_loss_grads(jm, jp, nb)
    assert abs(l_chunk - jloss) < 1e-5
    assert max_grad_diff(g_chunk, jgrads) < 1e-4


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-vl-2b"])
def test_loss_chunk_equals_the_dense_loss(arch):
    """The reference's chunked-CE gates (1e-5 on the loss and every
    gradient) on reduced gemma-2b, whose tied table's gradient sums the
    four chunks' recomputed unembeddings with the scaled lookup's, and
    qwen2-vl-2b, whose M-RoPE positions the backward goes through."""
    _, _, m, p = pair(arch, loss_chunk=8)
    nb = batch((4, 32), seed=3)
    l_chunk, _, g_chunk = torch_loss_grads(m, p, nb)
    l_dense, _, g_dense = torch_loss_grads(_variant(m, loss_chunk=0), p, nb)
    assert abs(l_chunk - l_dense) < 1e-5
    assert _max_diff(g_chunk, g_dense) < 1e-5


def test_loss_chunk_that_does_not_divide_is_one_chunk():
    _, _, m, p = pair("qwen2-0.5b", loss_chunk=10)
    nb = batch((2, 24), seed=4)
    l_chunk, _, g_chunk = torch_loss_grads(m, p, nb)
    l_dense, _, g_dense = torch_loss_grads(_variant(m, loss_chunk=0), p, nb)
    assert abs(l_chunk - l_dense) < 1e-6
    assert _max_diff(g_chunk, g_dense) < 1e-6


def test_grads_identical():
    """Query-chunked attention (``attn_chunk=8``) gives the dense path's
    gradients (the reference's gate, 1e-5)."""
    _, _, m, p = pair("qwen2-0.5b")
    nb = batch((2, 24))
    _, _, g1 = torch_loss_grads(m, p, nb)
    _, _, g2 = torch_loss_grads(_variant(m, attn_chunk=8), p, nb)
    assert _max_diff(g1, g2) < 1e-5


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b",
                                  "deepseek-moe-16b/ragged"])
def test_remat_full_equals_none_and_recomputes(monkeypatch, arch):
    """``remat="full"`` recomputes each stacked layer in the backward (its
    block runs twice, zamba2's shared block once: it runs outside the
    checkpoint, as in the reference) and changes no number."""
    _, _, m, p = pair(arch)
    nb = batch((2, 16), seed=5)
    l0, _, g0 = torch_loss_grads(m, p, nb)
    calls = _count_calls(monkeypatch, transformer, "_block_apply")
    l1, _, g1 = torch_loss_grads(_variant(m, remat="full"), p, nb)
    stacked = sum(n for kind, n in transformer.structure(m.cfg)
                  if kind != "shared_attn")
    shared = sum(1 for kind, _ in transformer.structure(m.cfg)
                 if kind == "shared_attn")
    assert len(calls) == 2 * stacked + shared
    assert l0 == l1
    assert _max_diff(g0, g1) == 0.0


def test_encdec_remat_full_equals_none_and_recomputes(monkeypatch):
    _, _, m, p = pair("whisper-tiny")
    nb = batch((2, 16), seed=6)
    l0, _, g0 = torch_loss_grads(m, p, nb)
    dec = _count_calls(monkeypatch, encdec, "_dec_block")
    l1, _, g1 = torch_loss_grads(_variant(m, remat="full"), p, nb)
    assert len(dec) == 2 * m.cfg.n_layers
    assert l0 == l1
    assert _max_diff(g0, g1) == 0.0


def test_no_remat_without_grad_mode(monkeypatch):
    """A forward without grad mode (serving) is never checkpointed."""
    _, _, m, p = pair("qwen2-0.5b", remat="full")
    seen = []
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: seen.append(1))
    with torch.no_grad():
        logits, _ = m.forward(p, torch.zeros((1, 8), dtype=torch.int32))
    assert not seen
    assert logits.shape == (1, 8, m.cfg.vocab)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_ragged_equals_capacity(arch):
    """At reduced width the capacity path is dropless (capacity factor 4),
    so the ragged path gives its NLL and gradients.  The aux losses differ
    by definition (per batch row on the capacity path, over all tokens on
    the ragged one), so the comparison leaves them out."""
    _, _, m, p = pair(arch)
    nb = batch((2, 16), seed=7)
    ragged = _variant(m, moe_ragged=True)
    nb_t = {k: torch.from_numpy(v) for k, v in nb.items()}
    out = []
    for model in (m, ragged):
        leaves, spec = pytree.tree_flatten(p)
        live = [x.detach().requires_grad_(True) for x in leaves]
        loss, _ = model.loss_fn(pytree.tree_unflatten(live, spec), nb_t,
                                aux_weight=0.0)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        out.append((float(loss), [np.zeros(1) if g is None else g.numpy()
                                  for g in grads]))
    (l_cap, g_cap), (l_rag, g_rag) = out
    assert abs(l_cap - l_rag) < 1e-5
    for a, b in zip(g_cap, g_rag):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
