"""``Model.loss_fn`` and its gradients against ``jax.grad``, on the CPU:
the dense, VLM, SSM and encoder-decoder architectures at reduced width
(the MoE and hybrid ones are in ``test_torch_loss_grads_moe.py``), and,
as ``<arch>/chunk8``, gemma-2b (tied table, embedding scale, GeGLU, one KV
head) and qwen2-vl-2b (M-RoPE) with the loss over chunks of 8 positions
(``loss_chunk``), against the reference's chunked loss.

The JAX package's ``PRNGKey(0)`` weights cross with ``params_from_numpy``
and the same numpy-seeded batch goes through both; the reference trains on
its plain paths.  Float32: the loss within 1e-5, every gradient leaf within
1e-4 (absolute), and no gradient is all zero.
"""

import pytest
import torch.utils._pytree as pytree

from _torch_loss_pairs import (batch, jax_loss_grads, max_grad_diff, pair,
                               torch_loss_grads)

ARCHS = ["gemma-2b", "glm4-9b", "qwen2-0.5b", "qwen2-vl-2b", "yi-34b",
         "mamba2-2.7b", "whisper-tiny", "gemma-2b/chunk8",
         "qwen2-vl-2b/chunk8"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jm, jp, m, p = pair(arch)
    nb = batch()
    jloss, jgrads = jax_loss_grads(jm, jp, nb)
    loss, metrics, grads = torch_loss_grads(m, p, nb)
    assert abs(loss - jloss) <= 1e-5 * max(1.0, abs(jloss))
    assert set(metrics) == {"nll", "aux", "perplexity"}
    assert max_grad_diff(grads, jgrads) < 1e-4
    assert any(float(g.abs().max()) > 0 for g in pytree.tree_leaves(grads))
