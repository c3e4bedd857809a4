"""bf16 weights: yi-34b and phi3.5-moe as the JAX package serves them, on
the CPU.

The JAX package builds yi-34b with ``param_dtype="bfloat16"``
(``tests/test_models.py``) and its dry-run sets bf16 weights for every
serving cell.  Here the reduced yi-34b and phi3.5-moe with bf16 weights
have the JAX package's parameter and cache trees (key paths, shapes,
dtypes; phi's router stays f32), and with the JAX package's bf16 weights
carried across (``params_from_numpy`` reads ``ml_dtypes`` bf16) the port's
f32-compute forward, prefill and decode match the JAX package's, its
flash and gmm kernels in interpret mode, within 1e-4: both sides widen the
same bf16 weights to f32 exactly, so only the f32 sums' order differs, as
in ``test_torch_models.py``.  phi runs both MoE paths.

The port's own draw: an f32 leaf keeps its bits (the digests of the f32
``init(seed=0)`` of three reduced archs were recorded before the
initialiser was changed to draw each leaf in its own dtype), and a bf16
leaf has the reference's spread.
"""

import dataclasses
import functools
import hashlib
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model

ARCHS = ["yi-34b", "phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b/ragged"]
TOL = 1e-4
BF16 = {"param_dtype": "bfloat16"}
# sha256 of the f32 init(seed=0, device="cpu") of each reduced arch, taken
# on the tree before ``layers.normal`` (torch 2.13 on the CPU): every leaf's
# key path, dtype, shape and bytes, in the tree's order
F32_INIT_DIGESTS = {
    "qwen2-0.5b":
        "c42e988faef541906217b41b653f67cb052afc0b72c2ec848980084378b2f0bd",
    "deepseek-moe-16b":
        "2e85e53fb02263d71a5f90f0eff2c2c87dcb6ce35513f67eb0fc94eaa382a921",
    "mamba2-2.7b":
        "417fd0af6e96a089cd40090cd74d48811ca903703d6897f42bbca417f78445fe",
}


def _overrides(arch_id):
    arch, _, path = arch_id.partition("/")
    return arch, {**BF16, **({"moe_ragged": True} if path == "ragged"
                             else {})}


@functools.lru_cache(maxsize=None)
def _pair(arch_id):
    """(JAX model, JAX params, port model, port params): the JAX package's
    bf16 weights from ``PRNGKey(0)`` carried to the port; built once per
    arch id (no test changes the weights)."""
    arch, over = _overrides(arch_id)
    jm = JModel(dataclasses.replace(jget_config(arch, reduced=True),
                                    use_pallas=True, **over))
    m = Model(dataclasses.replace(get_config(arch, reduced=True), **over))
    jp = jm.init(jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                          like=m.init(device="cpu"))
    return jm, jp, m, p


def _tokens(shape, seed=0, vocab=200):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _tree(tree):
    """{key path: (shape, dtype name)} of a port tree."""
    flat = torch.utils._pytree.tree_flatten_with_path(tree)[0]
    return {torch.utils._pytree.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
            for k, v in flat}


def _jtree(tree):
    """The same of a JAX tree (bf16 named as the port names it)."""
    flat = torch.utils._pytree.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, tree))[0]
    return {torch.utils._pytree.keystr(k): (
        tuple(v.shape), "bfloat16" if v.dtype == ml_dtypes.bfloat16
        else np.dtype(v.dtype).name) for k, v in flat}


@pytest.mark.parametrize("arch", ["yi-34b", "phi3.5-moe-42b-a6.6b"])
def test_trees_match_reference_dtypes(arch):
    """The port's bf16 parameter and cache trees have the JAX package's key
    paths, shapes and dtypes; the cache is in the compute dtype (f32) and
    phi's router stays f32."""
    jm, _, m, _ = _pair(arch)
    params = m.init(device="cpu")
    assert _tree(params) == _jtree(jm.init(jax.random.PRNGKey(0)))
    assert _tree(m.init_cache(2, 8, device="cpu")) == \
        _jtree(jm.init_cache(2, 8))
    dtypes = {v[1] for v in _tree(params).values()}
    if m.cfg.moe is None:
        assert dtypes == {"bfloat16"}
    else:
        assert dtypes == {"bfloat16", "float32"}
        assert params["segments"][0]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_pallas(arch):
    jm, jp, m, p = _pair(arch)
    toks = _tokens((2, 24))
    jl, jaux = jm.forward(jp, jnp.asarray(toks))
    logits, aux = m.forward(p, torch.from_numpy(toks))
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 24, m.cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jm, jp, m, p = _pair(arch)
    toks = _tokens((2, 14), seed=1)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :12]), max_len=16)
    logits, cache = m.prefill(p, torch.from_numpy(toks[:, :12]), max_len=16)
    np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
    for t in (12, 13):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        logits, cache = m.decode_step(p, cache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
    ours = params_from_numpy(jax.tree_util.tree_map(np.asarray, jc), "cpu",
                             like=cache)
    for a, b in zip(torch.utils._pytree.tree_leaves(ours),
                    torch.utils._pytree.tree_leaves(cache)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=TOL, atol=TOL)


def _digest(params) -> str:
    h = hashlib.sha256()
    for path, leaf in torch.utils._pytree.tree_flatten_with_path(params)[0]:
        h.update(torch.utils._pytree.keystr(path).encode())
        h.update(str(leaf.dtype).encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("arch", sorted(F32_INIT_DIGESTS))
def test_f32_init_keeps_its_bits(arch):
    params = Model(get_config(arch, reduced=True)).init(seed=0, device="cpu")
    assert _digest(params) == F32_INIT_DIGESTS[arch]


def test_bf16_init_is_scaled_as_the_reference():
    """The port's own bf16 draw of the reduced yi-34b: each projection's
    spread is its 1/sqrt(fan-in) scale (0.02 for the embedding), as the
    JAX package draws it."""
    cfg = dataclasses.replace(get_config("yi-34b", reduced=True), **BF16)
    params = Model(cfg).init(seed=0, device="cpu")
    emb = params["embedding"]
    seg = params["segments"][0]
    for leaf, scale in ((emb["embed"], 0.02),
                        (emb["lm_head"], 1 / math.sqrt(cfg.d_model)),
                        (seg["attn"]["wq"], 1 / math.sqrt(cfg.d_model)),
                        (seg["mlp"]["gate"], 1 / math.sqrt(cfg.d_model)),
                        (seg["mlp"]["down"], 1 / math.sqrt(cfg.d_ff))):
        assert leaf.dtype == torch.bfloat16
        std = float(leaf.float().std())
        assert abs(std / scale - 1) < 0.05, (tuple(leaf.shape), std, scale)
