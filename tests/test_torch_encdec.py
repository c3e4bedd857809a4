"""The port's encoder-decoder against the JAX package's, on the CPU.

Reduced whisper-tiny (2 encoder and 4 decoder layers, d 128, 4 query heads
over 2 kv heads of 32, float32): the JAX package's weights, drawn from
``PRNGKey(0)``, cross to the port through ``params_from_numpy``, and the
same numpy-seeded tokens and stub frames go through both.  The JAX side
runs with ``use_pallas=True``, its flash kernel in interpret mode.  Encoder
output, logits and caches must agree within 1e-4; prefill and decode
against the forward keep the reference's own 3e-3 gate
(``tests/test_models.py::test_decode_matches_forward``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import encdec as jencdec
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model, encdec

TOL = 1e-4
ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) on the same
    weights."""
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True),
                               use_pallas=True)
    jm, m = JModel(jcfg), Model(get_config(ARCH, reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    p = params_from_numpy(_numpy(jp), "cpu", like=m.init(device="cpu"))
    return jm, jp, m, p


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(shape, seed=0, vocab=200):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _frames(batch, n, d, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, d)).astype(np.float32)


def _close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


def _cache_close(jcache, cache):
    """Every leaf of the JAX cache (``self`` k/v/index, ``enc_out``,
    ``step``) against the port's, by key path."""
    ours = params_from_numpy(_numpy(jcache), "cpu", like=cache)
    for (path, a), b in zip(pytree.tree_flatten_with_path(ours)[0],
                            pytree.tree_leaves(cache)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=TOL, atol=TOL,
                                   err_msg=pytree.keystr(path))


def _shapes(tree):
    """{key path: shape} of every leaf (tensors, numpy arrays or JAX
    ``ShapeDtypeStruct``s)."""
    return {pytree.keystr(path): tuple(leaf.shape)
            for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


# --------------------------------------------------------------------------
# trees: the same key paths and shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_init_tree_matches_jax(reduced):
    """The port's parameter tree has the JAX tree's key paths and shapes,
    the encoder and decoder stacked on a leading layer axis (the full
    width's JAX tree by ``eval_shape``, with no weights drawn)."""
    jm = JModel(jget_config(ARCH, reduced=reduced))
    m = Model(get_config(ARCH, reduced=reduced))
    theirs = _shapes(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    ours = m.init(device="cpu")
    assert _shapes(ours) == theirs
    cfg = m.cfg
    assert ours["enc"]["attn"]["wq"].shape[0] == cfg.encdec.n_enc_layers
    assert ours["dec"]["cross_attn"]["wk"].shape[0] == cfg.n_layers
    assert ours["dec_pos"].shape == (4096, cfg.d_model)
    assert m.param_count(ours) == sum(
        int(np.prod(s)) for s in theirs.values())


def test_init_honours_max_dec_len():
    m = Model(get_config(ARCH, reduced=True))
    p = m.init(device="cpu", max_dec_len=48)
    jp = jencdec.init_params(jget_config(ARCH, reduced=True),
                             jax.random.PRNGKey(0), max_dec_len=48)
    assert p["dec_pos"].shape == jp["dec_pos"].shape == (48, m.cfg.d_model)


def test_cache_trees_match_jax(pair):
    """``init_cache`` and ``prefill``'s cache carry across unchanged: the
    same key paths and shapes, ``step`` a 0-d int32."""
    jm, jp, m, p = pair
    cache = m.init_cache(2, 16, device="cpu")
    jcache = jm.init_cache(2, 16)
    assert _shapes(cache) == _shapes(jcache)
    _, pcache = m.prefill(p, torch.zeros((2, 3), dtype=torch.int32),
                          max_len=16)
    _, jpcache = jm.prefill(jp, jnp.zeros((2, 3), jnp.int32), max_len=16)
    assert _shapes(pcache) == _shapes(jpcache)
    assert cache["self"]["k"].shape == (m.cfg.n_layers, 2, 16, 2, 32)
    assert cache["enc_out"].shape == (2, 4, m.cfg.d_model)
    assert cache["step"].shape == () and cache["step"].dtype == torch.int32


def test_model_accepts_full_width_whisper():
    """The facade takes the audio family (it refused it before the
    encoder-decoder was ported)."""
    m = Model(get_config(ARCH))
    assert m._m is encdec


# --------------------------------------------------------------------------
# the same weights, the same outputs
# --------------------------------------------------------------------------

def test_encode_matches_jax(pair):
    jm, jp, m, p = pair
    frames = _frames(2, 6, m.cfg.d_model)
    want = jencdec.encode(jm.cfg, jp, jnp.asarray(frames))
    got = encdec.encode(m.cfg, p, torch.from_numpy(frames))
    assert got.shape == (2, 6, m.cfg.d_model)
    _close(got, want)


def test_sinusoid_matches_jax():
    """``[sin | cos]`` concatenated, in float32."""
    got = encdec._sinusoid(37, 64, "cpu")
    want = jencdec._sinusoid(37, 64)
    assert got.dtype == torch.float32
    _close(got, want, tol=1e-6)


@pytest.mark.parametrize("with_frames", [True, False],
                         ids=["frames", "stub-frames"])
def test_forward_matches_jax(pair, with_frames):
    jm, jp, m, p = pair
    toks = _tokens((2, 24))
    kw, jkw = {}, {}
    if with_frames:
        frames = _frames(2, 6, m.cfg.d_model, seed=1)
        kw["frames"] = torch.from_numpy(frames)
        jkw["frames"] = jnp.asarray(frames)
    jl, jaux = jm.forward(jp, jnp.asarray(toks), **jkw)
    logits, aux = m.forward(p, torch.from_numpy(toks), **kw)
    assert logits.shape == (2, 24, m.cfg.vocab)
    assert aux.dtype == torch.float32 and aux.ndim == 0 and float(aux) == 0
    assert float(jaux) == 0
    _close(logits, jl)


@pytest.mark.parametrize("with_frames", [True, False],
                         ids=["frames", "stub-frames"])
def test_prefill_matches_jax(pair, with_frames):
    """Prefill's logits and its whole cache: ``self`` k/v/index,
    ``enc_out`` and ``step``."""
    jm, jp, m, p = pair
    toks = _tokens((2, 12), seed=1)
    frames = _frames(2, 5, m.cfg.d_model, seed=2) if with_frames else None
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=24,
                        frames=None if frames is None
                        else jnp.asarray(frames))
    logits, cache = m.prefill(p, torch.from_numpy(toks), max_len=24,
                              frames=None if frames is None
                              else torch.from_numpy(frames))
    _close(logits, jl)
    assert int(cache["step"]) == 12
    assert cache["enc_out"].shape == (2, 5 if with_frames else 3,
                                      m.cfg.d_model)
    _cache_close(jc, cache)


@pytest.mark.parametrize("steps", [1, 4])
def test_decode_steps_match_jax(pair, steps):
    """One and then several decode steps after a prefill: logits at every
    step and the cache after the last."""
    jm, jp, m, p = pair
    toks = _tokens((2, 12 + steps), seed=3)
    frames = _frames(2, 6, m.cfg.d_model, seed=4)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :12]), max_len=20,
                        frames=jnp.asarray(frames))
    logits, cache = m.prefill(p, torch.from_numpy(toks[:, :12]), max_len=20,
                              frames=torch.from_numpy(frames))
    for t in range(12, 12 + steps):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        logits, cache = m.decode_step(p, cache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        _close(logits, jl)
    assert int(cache["step"]) == 12 + steps
    assert cache["self"]["index"].eq(12 + steps).all()
    _cache_close(jc, cache)


def test_decode_matches_forward(pair):
    """The reference's own gate, inside the port: the same stub frames
    pinned for ``forward`` and ``prefill``, then prefill and one decode
    step against the forward within 3e-3."""
    _, _, m, p = pair
    toks = torch.from_numpy(_tokens((2, 24), seed=5))
    frames = torch.zeros((2, 6, m.cfg.d_model), dtype=torch.float32)
    full, _ = m.forward(p, toks, frames=frames)
    logits_p, cache = m.prefill(p, toks[:, :12], max_len=32, frames=frames)
    err = float((logits_p[:, -1] - full[:, 11]).abs().max())
    assert err < 3e-3, f"prefill diverges from forward: {err}"
    logits_d, cache = m.decode_step(p, cache, toks[:, 12:13])
    err = float((logits_d[:, -1] - full[:, 12]).abs().max())
    assert err < 3e-3, f"decode diverges from forward: {err}"


def test_decode_step_writes_self_cache_in_place(pair):
    """As the dense ``decode_step``: the new cache's k/v are the input's
    buffers (the JAX package's are new arrays); the index, ``step`` and the
    encoder output are new tensors or the input's unchanged."""
    _, _, m, p = pair
    toks = torch.from_numpy(_tokens((2, 5), seed=6))
    _, cache = m.prefill(p, toks[:, :4], max_len=8)
    before = pytree.tree_map(torch.clone, cache)
    _, new = m.decode_step(p, cache, toks[:, 4:5])
    assert new["self"]["k"] is cache["self"]["k"]
    assert new["self"]["v"] is cache["self"]["v"]
    assert not torch.equal(cache["self"]["k"], before["self"]["k"])
    assert torch.equal(cache["self"]["index"], before["self"]["index"])
    assert int(cache["step"]) == 4 and int(new["step"]) == 5
    assert new["enc_out"] is cache["enc_out"]


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_reset_slot_refused_for_audio(pair):
    """The reference asserts decoder-only families for slot reuse."""
    jm, jp, m, p = pair
    cache = m.init_cache(2, 8, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        m.reset_slot(cache, 0)
    with pytest.raises(AssertionError, match="decoder-only"):
        jm.reset_slot(jm.init_cache(2, 8), 0)


def test_cache_beyond_decoder_positions_refused():
    """A cache longer than the learned decoder positions: the JAX package
    gathers past them and reads NaN; the port refuses it up front, from
    shapes alone, in ``prefill`` and in ``decode_step``."""
    jcfg = jget_config(ARCH, reduced=True)
    m = Model(get_config(ARCH, reduced=True))
    jp = jencdec.init_params(jcfg, jax.random.PRNGKey(0), max_dec_len=16)
    p = params_from_numpy(_numpy(jp), "cpu",
                          like=m.init(device="cpu", max_dec_len=16))
    toks = _tokens((2, 20), seed=7)
    jl, jc = jencdec.prefill(jcfg, jp, jnp.asarray(toks[:, :12]), 24)
    for t in range(12, 17):
        jl, jc = jencdec.decode_step(jcfg, jp, jc,
                                     jnp.asarray(toks[:, t:t + 1]))
    assert np.isnan(np.asarray(jl)).all()  # position 16 of 16 rows
    with pytest.raises(ValueError, match="decoder positions"):
        m.prefill(p, torch.from_numpy(toks[:, :12]), max_len=24)
    with pytest.raises(ValueError, match="decoder positions"):
        m.decode_step(p, m.init_cache(2, 24, device="cpu"),
                      torch.from_numpy(toks[:, :1]))
    logits, cache = m.prefill(p, torch.from_numpy(toks[:, :12]), max_len=16)
    assert bool(torch.isfinite(logits).all())  # the cache fits: computes


def test_interop_keeps_zero_d_leaves():
    """A 0-d leaf (the encoder-decoder cache's ``step``, a numpy scalar)
    crosses as a 0-d tensor: ``np.ascontiguousarray`` made it (1,), so
    ``params_from_numpy`` refused the JAX package's cache."""
    from repro_torch.interop import tree_from_numpy
    jcache = jencdec.init_cache(jget_config(ARCH, reduced=True), 2, 8)
    cache = Model(get_config(ARCH, reduced=True)).init_cache(2, 8,
                                                             device="cpu")
    ours = params_from_numpy(_numpy(jcache), "cpu", like=cache)
    assert ours["step"].shape == () and ours["step"].dtype == torch.int32
    got = tree_from_numpy({"x": np.float32(2.5), "y": np.zeros(())}, "cpu")
    assert got["x"].shape == () and float(got["x"]) == 2.5
    assert got["y"].shape == ()
