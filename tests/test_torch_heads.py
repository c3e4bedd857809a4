"""The port's dense and VLM models at their published head geometry, against
the JAX package's, on the CPU.

The reduced configs cut every arch to head_dim 16, so they never reach the
head layouts the card runs: gemma-2b's 8 query heads of 256 over one KV
head (MQA) with GeGLU and the scaled, tied embedding; glm4-9b's 32 heads of
128 over 2 with half the head dim rotated; qwen2-vl-2b's 12 heads of 128
over 2 with QKV bias and M-RoPE sections (16, 24, 24).  Here each keeps its
published heads, KV heads, head dim, rotary fraction and sections at 2
layers, d_model 256, d_ff 128 and vocab 256 (f32), so a case takes a few
seconds.  The JAX package's weights, drawn from ``PRNGKey(0)``, cross to
the port through ``params_from_numpy``; the JAX forward runs its flash
kernel in interpret mode (``use_pallas=True``), as the models' tests do.
Logits and caches must agree within 1e-4, as in ``test_torch_models.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.models.transformer import mrope_positions

ARCHS = ["gemma-2b", "glm4-9b", "qwen2-vl-2b"]
TOL = 1e-4


def _heads(cfg, full):
    """``cfg`` (reduced) with ``full``'s head layout at 2 layers and
    d_model 256."""
    return dataclasses.replace(
        cfg, n_layers=2, d_model=256, n_heads=full.n_heads,
        n_kv_heads=full.n_kv_heads, head_dim=full.hd,
        rope_fraction=full.rope_fraction,
        mrope_sections=full.mrope_sections)


def _config(arch):
    return _heads(get_config(arch, reduced=True), get_config(arch))


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX model, JAX params, port model, port params) on the same
    weights, at ``arch``'s published head layout; built once per arch (no
    test changes the weights)."""
    jcfg = dataclasses.replace(
        _heads(jget_config(arch, reduced=True), jget_config(arch)),
        use_pallas=True)
    jm, m = JModel(jcfg), Model(_config(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                          like=m.init(device="cpu"))
    return jm, jp, m, p


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.int32)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _cache_close(jcache, cache):
    ours = params_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                             "cpu", like=cache)
    for a, b in zip(torch.utils._pytree.tree_leaves(ours),
                    torch.utils._pytree.tree_leaves(cache)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_head_layout_is_the_published_one(arch):
    cfg, full = _config(arch), get_config(arch)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == \
        (full.n_heads, full.n_kv_heads, full.hd)
    assert (cfg.act, cfg.embed_scale, cfg.rope_fraction, cfg.mrope,
            cfg.mrope_sections, cfg.qkv_bias) == \
        (full.act, full.embed_scale, full.rope_fraction, full.mrope,
         full.mrope_sections, full.qkv_bias)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_pallas(arch):
    jm, jp, m, p = _pair(arch)
    toks = _tokens((2, 24))
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    logits, _ = m.forward(p, torch.from_numpy(toks))
    assert logits.shape == (2, 24, 256)
    np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jm, jp, m, p = _pair(arch)
    toks = _tokens((2, 16), seed=1)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :12]), max_len=24)
    logits, cache = m.prefill(p, torch.from_numpy(toks[:, :12]), max_len=24)
    np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
    _cache_close(jc, cache)
    for t in range(12, 16):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        logits, cache = m.decode_step(p, cache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
    _cache_close(jc, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's own gate at the published heads: prefill + one
    decode step reproduce the full-sequence forward within 3e-3."""
    _, _, m, p = _pair(arch)
    toks = torch.from_numpy(_tokens((2, 24), seed=2))
    full, _ = m.forward(p, toks)
    logits_p, cache = m.prefill(p, toks[:, :12], max_len=32)
    assert float((logits_p[:, -1] - full[:, 11]).abs().max()) < 3e-3
    logits_d, _ = m.decode_step(p, cache, toks[:, 12:13])
    assert float((logits_d[:, -1] - full[:, 12]).abs().max()) < 3e-3


def test_mrope_positions_differ_by_stream():
    pos = mrope_positions(1, 12, 2, (2, 3))[0]
    assert pos.dtype == torch.int32
    assert pos[:2].tolist() == [[0, 0, 0], [1, 1, 1]]
    assert pos[2:8].tolist() == [[2, 2, 2], [2, 2, 3], [2, 2, 4],
                                 [2, 3, 2], [2, 3, 3], [2, 3, 4]]
    assert pos[8:].tolist() == [[5, 5, 5], [6, 6, 6], [7, 7, 7], [8, 8, 8]]


def test_vlm_input_embeds_and_3d_positions_match_jax():
    """qwen2-vl-2b fed ``input_embeds`` (the text's embeddings with a block
    of 16 seeded patch embeddings, a 4 x 4 image) and 3-D positions whose
    t, h and w streams differ over the image: the three M-RoPE sections
    rotate by different positions, and the logits agree with the JAX
    package's."""
    jm, jp, m, p = _pair("qwen2-vl-2b")
    toks = _tokens((2, 24), seed=4)
    embeds = np.array(jlayers.embed(jp["embedding"], jm.cfg,
                                    jnp.asarray(toks)), np.float32)
    rng = np.random.default_rng(5)
    embeds[:, 3:19] = rng.standard_normal((2, 16, 256)).astype(np.float32)
    pos = mrope_positions(2, 24, 3, (4, 4)).numpy()
    assert (pos[:, 3:19, 0] != pos[:, 3:19, 1]).any()
    assert (pos[:, 3:19, 1] != pos[:, 3:19, 2]).any()
    jl, _ = jm.forward(jp, jnp.asarray(toks), positions=jnp.asarray(pos),
                       input_embeds=jnp.asarray(embeds))
    logits, _ = m.forward(p, torch.from_numpy(toks),
                          positions=torch.from_numpy(pos),
                          input_embeds=torch.from_numpy(embeds))
    np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
    text, _ = m.forward(p, torch.from_numpy(toks))
    assert float((logits - text).abs().max()) > 1e-2  # the image counted
