"""The port's decoder LMs against the JAX package's, on the CPU.

For each reduced architecture of the families the port carries (gemma-2b:
GeGLU and embedding scale; glm4-9b: partial rotary; qwen2-0.5b: QKV bias
and GQA; qwen2-vl-2b: M-RoPE; yi-34b: untied head; mamba2-2.7b: the SSD
trunk; zamba2-1.2b: mamba segments around a shared attention block;
deepseek-moe-16b: a dense layer 0, then fine-grained routed experts beside
shared experts, with normalised top-k gates; phi3.5-moe: top-2 routing and
GQA), the JAX package's weights, drawn from ``PRNGKey(0)``, cross to the
port through ``params_from_numpy``, and the same numpy-seeded tokens go
through both.  The MoE archs run both paths: the capacity path (their
default) and, with ``/ragged``, the grouped-matmul path.  The JAX forward
runs with ``use_pallas=True``, its flash, SSD and gmm kernels in
interpret mode.  The reduced configs are float32, so logits and caches must
agree within 1e-4; ``decode_matches_forward`` keeps the reference's own
3e-3 gate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, get_config as jget_config
from repro.models import Model as JModel
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCHS, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.models import transformer

MOE = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"]
PORTED = ["gemma-2b", "glm4-9b", "qwen2-0.5b", "qwen2-vl-2b", "yi-34b",
          "mamba2-2.7b", "zamba2-1.2b", *MOE, *(f"{a}/ragged" for a in MOE)]
TOL = 1e-4


def _variant(arch_id):
    """(arch, config overrides) of a ``PORTED`` id: ``<arch>/ragged`` is the
    MoE arch on its ragged grouped-matmul path."""
    arch, _, path = arch_id.partition("/")
    return arch, ({"moe_ragged": True} if path == "ragged" else {})


def _config(arch_id):
    arch, overrides = _variant(arch_id)
    return dataclasses.replace(get_config(arch, reduced=True), **overrides)


def _pair(arch_id, **overrides):
    """(JAX model, JAX params, port model, port params) on the same
    weights."""
    arch, variant = _variant(arch_id)
    overrides = {**variant, **overrides}
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               use_pallas=True, **overrides)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **overrides)
    jm, m = JModel(jcfg), Model(cfg)
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


def _rows(cfg, cache, slot):
    """(name, batch row ``slot``) of every cache leaf: the batch axis is 1
    for a stacked segment and 0 for an application of the shared block."""
    return [(name, leaf[slot] if kind == "shared_attn" else leaf[:, slot])
            for (kind, _), seg in zip(transformer.structure(cfg),
                                      cache["segments"])
            for name, leaf in seg.items()]


def _cache_close(jcache, cache):
    ours = params_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                             "cpu", like=cache)
    for a, b in zip(torch.utils._pytree.tree_leaves(ours),
                    torch.utils._pytree.tree_leaves(cache)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# configs: the port's copy is the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_configs_and_structure_match_reference(arch):
    assert sorted(ARCHS) == sorted(JARCHS)
    for reduced in (False, True):
        ours = dataclasses.asdict(get_config(arch, reduced=reduced))
        theirs = dataclasses.asdict(jget_config(arch, reduced=reduced))
        assert ours == theirs
    cfg, jcfg = get_config(arch), jget_config(arch)
    if cfg.family != "audio":  # the encoder-decoder has no segments
        assert transformer.structure(cfg) == jtransformer.structure(jcfg)


# --------------------------------------------------------------------------
# the same weights, the same logits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
class TestAgainstJax:
    def test_forward_matches_jax_pallas(self, arch):
        jm, jp, m, p = _pair(arch)
        toks = _tokens((2, 24))
        jl, jaux = jm.forward(jp, jnp.asarray(toks))
        logits, aux = m.forward(p, torch.from_numpy(toks))
        assert logits.shape == (2, 24, m.cfg.vocab)
        assert aux.dtype == torch.float32 and aux.ndim == 0
        assert (float(aux) > 0) == (m.cfg.family == "moe")
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL,
                                   atol=TOL)

    def test_prefill_and_decode_match_jax(self, arch):
        jm, jp, m, p = _pair(arch)
        toks = _tokens((2, 16), seed=1)
        jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :12]), max_len=24)
        logits, cache = m.prefill(p, torch.from_numpy(toks[:, :12]),
                                  max_len=24)
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
        _cache_close(jc, cache)
        for t in range(12, 16):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
            logits, cache = m.decode_step(p, cache,
                                          torch.from_numpy(toks[:, t:t + 1]))
            np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL,
                                       atol=TOL)
        _cache_close(jc, cache)

    def test_chunked_forward_and_prefill_match_jax(self, arch):
        """S = 32, a multiple of the reduced SSD chunk (16): the scan
        carries its state across chunks, and prefill hands the final state
        to decode."""
        jm, jp, m, p = _pair(arch)
        toks = _tokens((2, 34), seed=6)
        jl, _ = jm.forward(jp, jnp.asarray(toks[:, :32]))
        logits, _ = m.forward(p, torch.from_numpy(toks[:, :32]))
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
        jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :32]), max_len=40)
        logits, cache = m.prefill(p, torch.from_numpy(toks[:, :32]),
                                  max_len=40)
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
        _cache_close(jc, cache)
        for t in (32, 33):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
            logits, cache = m.decode_step(p, cache,
                                          torch.from_numpy(toks[:, t:t + 1]))
            np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL,
                                       atol=TOL)
        _cache_close(jc, cache)

    def test_decode_matches_forward(self, arch):
        """The reference's own gate, inside the port: prefill + one decode
        step reproduce the full-sequence forward."""
        m = Model(_config(arch))
        params = m.init(seed=0, device="cpu")
        toks = torch.from_numpy(_tokens((2, 24), seed=2))
        full, _ = m.forward(params, toks)
        logits_p, cache = m.prefill(params, toks[:, :12], max_len=32)
        err = float((logits_p[:, -1] - full[:, 11]).abs().max())
        assert err < 3e-3, f"prefill diverges from forward: {err}"
        logits_d, cache = m.decode_step(params, cache, toks[:, 12:13])
        err = float((logits_d[:, -1] - full[:, 12]).abs().max())
        assert err < 3e-3, f"decode diverges from forward: {err}"

    def test_frozen_row_unchanged(self, arch):
        """Continuous-batching contract: advance=False freezes a row's step
        and index; decoding that row later equals decoding it from the
        untouched cache."""
        m = Model(_config(arch))
        params = m.init(seed=0, device="cpu")
        t = torch.tensor([[3], [5]], dtype=torch.int32)
        _, c1 = m.decode_step(params, m.init_cache(2, 16, device="cpu"), t,
                              advance=torch.tensor([True, False]))
        assert c1["step"].tolist() == [1, 0]
        # the frozen row's index and mamba state stay put (its k/v are
        # rewritten in place at the unmoved index)
        assert all(row.eq(0).all() for name, row in _rows(m.cfg, c1, 1)
                   if name in ("index", "conv", "h"))
        l_after, _ = m.decode_step(params, c1, t,
                                   advance=torch.tensor([False, True]))
        l_ref, _ = m.decode_step(params, m.init_cache(2, 16, device="cpu"),
                                 t, advance=torch.tensor([False, True]))
        np.testing.assert_allclose(_np(l_after[1]), _np(l_ref[1]),
                                   rtol=2e-4, atol=2e-4)

    def test_frozen_rows_match_jax(self, arch):
        """Per-row offsets and advance masks give the JAX package's logits
        and cache, step after step."""
        jm, jp, m, p = _pair(arch)
        jc, cache = jm.init_cache(3, 16), m.init_cache(3, 16, device="cpu")
        masks = [[True, False, True], [False, True, True],
                 [True, True, False]]
        for i, mask in enumerate(masks):
            toks = _tokens((3, 1), seed=10 + i)
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks),
                                    advance=jnp.asarray(mask))
            logits, cache = m.decode_step(p, cache, torch.from_numpy(toks),
                                          advance=torch.tensor(mask))
            np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL,
                                       atol=TOL)
        _cache_close(jc, cache)

    def test_reset_slot_matches_jax(self, arch):
        jm, jp, m, p = _pair(arch)
        toks = _tokens((2, 5), seed=3)
        _, jc = jm.prefill(jp, jnp.asarray(toks), max_len=8)
        _, cache = m.prefill(p, torch.from_numpy(toks), max_len=8)
        jc = jm.reset_slot(jc, 1)
        cache = m.reset_slot(cache, 1)
        assert cache["step"].tolist() == [5, 0]
        assert all(row.eq(0).all() for _, row in _rows(m.cfg, cache, 1))
        _cache_close(jc, cache)


@pytest.mark.parametrize("arch", MOE)
def test_ragged_equals_dropless_capacity(arch):
    """The forward half of the reference's ``TestRaggedMoE``: at the
    reduced capacity factor the capacity path drops nothing, so the ragged
    grouped-matmul path gives its logits (the gradients wait for the
    training slice)."""
    cfg = get_config(arch, reduced=True)
    m1, m2 = Model(cfg), Model(dataclasses.replace(cfg, moe_ragged=True))
    params = m1.init(seed=0, device="cpu")
    toks = torch.from_numpy(_tokens((2, 24), seed=7))
    l1, _ = m1.forward(params, toks)
    l2, _ = m2.forward(params, toks)
    assert float((l1 - l2).abs().max()) < 1e-4


# --------------------------------------------------------------------------
# int8 KV cache
# --------------------------------------------------------------------------

class TestKVQuant:
    def test_greedy_decode_identical(self):
        """The reference's check: the int8 cache leaves greedy decoding
        unchanged."""
        cfg = get_config("qwen2-0.5b", reduced=True)
        m = Model(cfg)
        mq = Model(dataclasses.replace(cfg, kv_quant=True))
        params = m.init(seed=0, device="cpu")
        toks = torch.from_numpy(_tokens((2, 8), seed=4, vocab=cfg.vocab))

        def gen(model, n=8):
            logits, cache = model.prefill(params, toks, max_len=32)
            t = model.greedy_token(logits)
            out = []
            for _ in range(n):
                out.append(t.clone())
                logits, cache = model.decode_step(params, cache, t[:, None])
                t = model.greedy_token(logits)
            return torch.stack(out)

        assert torch.equal(gen(m), gen(mq))

    def test_quantised_cache_matches_jax(self):
        jm, jp, m, p = _pair("qwen2-0.5b", kv_quant=True)
        toks = _tokens((2, 10), seed=5)
        jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :8]), max_len=16)
        logits, cache = m.prefill(p, torch.from_numpy(toks[:, :8]),
                                  max_len=16)
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
        assert cache["segments"][0]["k"].dtype == torch.int8
        for t in (8, 9):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
            logits, cache = m.decode_step(p, cache,
                                          torch.from_numpy(toks[:, t:t + 1]))
            np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL,
                                       atol=TOL)


# --------------------------------------------------------------------------
# the facade and the weight carrier
# --------------------------------------------------------------------------

def test_init_is_seeded_and_stacked():
    cfg = get_config("qwen2-0.5b", reduced=True)
    m = Model(cfg)
    a, b = m.init(seed=3, device="cpu"), m.init(seed=3, device="cpu")
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y)
    wq = a["segments"][0]["attn"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)
    assert m.param_count(a) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            JModel(jget_config("qwen2-0.5b", reduced=True)).init(
                jax.random.PRNGKey(0))))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssm_trees_match_reference_dtypes(arch):
    """bf16 weights: the port's parameter and cache trees have the JAX
    package's key paths, shapes and dtypes (dt_bias, A_log and D_skip stay
    f32, the ``h`` state is f32 and ``conv`` bf16), the shared block lives
    once in ``shared_block`` and its segments are empty."""
    import ml_dtypes
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    m, jm = Model(cfg), JModel(jcfg)
    for ours, theirs in ((m.init(device="cpu"),
                          jm.init(jax.random.PRNGKey(0))),
                         (m.init_cache(2, 8, device="cpu"),
                          jm.init_cache(2, 8))):
        flat = torch.utils._pytree.tree_flatten_with_path
        got = {torch.utils._pytree.keystr(k): (tuple(v.shape),
                                               str(v.dtype)[6:])
               for k, v in flat(ours)[0]}
        want = {torch.utils._pytree.keystr(k): (
            tuple(v.shape), "bfloat16" if v.dtype == ml_dtypes.bfloat16
            else np.dtype(v.dtype).name)
            for k, v in flat(jax.tree_util.tree_map(np.asarray, theirs))[0]}
        assert got == want
    params = m.init(device="cpu")
    assert params["segments"][0]["mamba"]["A_log"].dtype == torch.float32
    kinds = [k for k, _ in transformer.structure(cfg)]
    assert ("shared_block" in params) == ("shared_attn" in kinds)
    assert all(seg == {} for kind, seg in zip(kinds, params["segments"])
               if kind == "shared_attn")


def test_params_from_numpy_checks_structure_and_shapes():
    m = Model(get_config("qwen2-0.5b", reduced=True))
    like = m.init(device="cpu")
    tree = torch.utils._pytree.tree_map(lambda t: t.numpy(), like)
    tree["segments"][0]["attn"]["wq"] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, "cpu", like=like)
    del tree["segments"][0]["attn"]["wq"]
    with pytest.raises(ValueError, match="structure"):
        params_from_numpy(tree, "cpu", like=like)
