"""``Model.loss_fn`` and its gradients against ``jax.grad``, on the CPU:
the MoE architectures on both paths (the capacity path, their default, and
``/ragged``, the grouped-matmul op's plain version) and the zamba2 hybrid,
whose shared attention block runs between Mamba2 segments.  The MoE loss
adds 0.01 times the load-balancing aux loss.

As ``test_torch_loss_grads.py``: the JAX package's weights, one
numpy-seeded batch, the loss within 1e-5 and every gradient leaf within
1e-4 of the reference's.
"""

import pytest
import torch.utils._pytree as pytree

from _torch_loss_pairs import (batch, jax_loss_grads, max_grad_diff, pair,
                               torch_loss_grads)

ARCHS = ["deepseek-moe-16b", "deepseek-moe-16b/ragged",
         "phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b/ragged",
         "zamba2-1.2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jm, jp, m, p = pair(arch)
    nb = batch()
    jloss, jgrads = jax_loss_grads(jm, jp, nb)
    loss, metrics, grads = torch_loss_grads(m, p, nb)
    assert abs(loss - jloss) <= 1e-5 * max(1.0, abs(jloss))
    if m.cfg.moe is not None:
        assert float(metrics["aux"]) > 0
    assert max_grad_diff(grads, jgrads) < 1e-4
    assert any(float(g.abs().max()) > 0 for g in pytree.tree_leaves(grads))
