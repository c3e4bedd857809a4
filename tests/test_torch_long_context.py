"""The port at the reference's long contexts, on the CPU, at reduced width.

The JAX package's ``prefill_32k`` and ``long_500k`` cells run
``Model.forward`` on a long row and a ``decode_step`` over a long cache
(``src/repro/launch/dryrun.py``).  Here the reduced mamba2-2.7b and
zamba2-1.2b carry the JAX package's ``PRNGKey(0)`` weights through
``params_from_numpy``: a forward of 2,048 tokens (128 chunks of the
reduced SSD chunk of 16) and zamba2's decode steps from a cache of 16,384
positions go through both packages on the same numpy-seeded tokens (the
JAX package through its plain paths, ``use_pallas=False``, as its own
tests run it); a request served from 16,384 positions equals the same
request served from 64; and the rotary angles agree with the reference's
at every RoPE arch's longest position.  The reduced configs are float32:
logits and caches agree within ``tests/test_torch_models.py``'s 1e-4.

The cached attention holds no float32 copy of a cache in another dtype
(fault 23): it casts a block of positions at a time, and its output is the
former whole-cache formula's within f32 rounding.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro_torch.configs import ARCHS, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model, layers
from repro_torch.serve import LocalDecodeBackend, Request, ServeEngine

TOL = 1e-4  # tests/test_torch_models.py: float32 logits and caches
LONG_500K = 524_288  # the JAX package's long_500k length (configs/base.py)
PREFILL_32K = 32_768  # its prefill_32k and decode_32k length


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX model, JAX params, port model, port params) of the reduced
    ``arch`` on the same weights (drawn once for the module)."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               use_pallas=False)
    jm, m = JModel(jcfg), Model(get_config(arch, reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                          like=m.init(device="cpu"))
    return jm, jp, m, p


def _tokens(shape, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_forward_on_a_long_row_matches_jax(arch):
    """2,048 tokens: 128 chunks of 16, the inter-chunk state carried 127
    times (and zamba2's shared attention over 2,048 keys)."""
    jm, jp, m, p = _pair(arch)
    assert m.cfg.ssm.chunk == 16
    toks = _tokens((1, 2048), seed=11)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    logits, _ = m.forward(p, torch.from_numpy(toks))
    assert logits.shape == (1, 2048, m.cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)


def test_hybrid_decode_from_a_long_cache_matches_jax():
    """zamba2's prefill into a cache of 16,384 positions, then two decode
    steps over it: the logits and every cache leaf agree."""
    jm, jp, m, p = _pair("zamba2-1.2b")
    toks = _tokens((2, 14), seed=12)
    T = 16_384
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :12]), max_len=T)
    logits, cache = m.prefill(p, torch.from_numpy(toks[:, :12]), max_len=T)
    np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
    for t in range(12, 14):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        logits, cache = m.decode_step(p, cache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=TOL, atol=TOL)
    ours = params_from_numpy(jax.tree_util.tree_map(np.asarray, jc), "cpu",
                             like=cache)
    leaves = torch.utils._pytree.tree_leaves(cache)
    assert max(t.shape[1] for t in leaves if t.ndim == 4) == T
    for a, b in zip(torch.utils._pytree.tree_leaves(ours), leaves):
        np.testing.assert_allclose(_np(a), _np(b), rtol=TOL, atol=TOL)


class _Recording:
    """A model whose ``decode_step`` keeps each step's last logits."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, cache, tokens, **kw):
        logits, cache = self.model.decode_step(params, cache, tokens, **kw)
        self.logits.append(logits[:, -1].float().clone())
        return logits, cache


def _serve(model, params, max_len, req):
    rec = _Recording(model)
    with ServeEngine(LocalDecodeBackend(rec, params, n_slots=1,
                                        max_len=max_len)) as eng:
        eng.submit(req)
        (done,) = eng.run_until_drained()
    return done.tokens, torch.stack(rec.logits)


def test_request_served_from_a_long_cache_equals_a_short_one():
    """One request (16 prompt tokens, fed one a step, and 16 new ones)
    served by zamba2 from 16,384 positions and from 64: the masked
    positions add exact zeros, so the greedy tokens are equal and the
    logits agree within f32 rounding of the softmax's longer sum."""
    m = Model(get_config("zamba2-1.2b", reduced=True))
    params = m.init(seed=0, device="cpu")
    req = Request(rid=0, prompt=tuple(_tokens(16, seed=13).tolist()),
                  max_new=16)
    with torch.inference_mode():
        long_toks, long_logits = _serve(m, params, 16_384, req)
        short_toks, short_logits = _serve(m, params, 64, req)
    assert len(long_toks) == 16 and long_toks == short_toks
    assert long_logits.shape == short_logits.shape
    rel = float((long_logits - short_logits).norm() / short_logits.norm())
    assert rel <= 1e-5, rel


def _rope_cases():
    """(arch, the longest position its cells reach): long_500k for the
    sub-quadratic archs with attention, prefill_32k's otherwise."""
    out = []
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        if cfg.family == "audio" or cfg.family == "ssm":
            continue  # learned positions; no attention
        out.append((arch, LONG_500K if cfg.sub_quadratic() else PREFILL_32K))
    return out


@pytest.mark.parametrize("arch,longest", _rope_cases(),
                         ids=lambda c: str(c))
def test_rope_angles_match_reference_at_long_positions(arch, longest):
    """cos and sin of the first 4,096 positions and of the last 4,096 up
    to the cell's longest, at the published config's rotary width and
    theta (M-RoPE: three position streams), against the JAX package's."""
    cfg = get_config(arch)
    rot = int(cfg.hd * cfg.rope_fraction) // 2 * 2
    pos = np.arange(longest - 4096, longest, dtype=np.int32)[None]
    pos = np.concatenate([np.arange(0, 4096, dtype=np.int32)[None], pos], 1)
    sections = cfg.mrope_sections if cfg.mrope else None
    if sections is not None:
        pos = np.stack([pos, pos // 2, pos // 3], axis=-1)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), rot, cfg.rope_theta,
                                 sections)
    c, s = layers.rope_angles(torch.from_numpy(pos), rot, cfg.rope_theta,
                              sections)
    assert c.dtype == torch.float32 and c.shape == (1, 8192, rot // 2)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=TOL, atol=TOL)


# -- fault 23: no float32 copy of the cache ---------------------------------


def _former_cached_attention(q, k, v, idx, dtype):
    """The cached attention as the port computed it before the repair:
    the whole cache cast to f32 at once."""
    B, S, H, hd = q.shape
    K, T = k.shape[2], k.shape[1]
    qg = q.reshape(B, S, K, H // K, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) * (hd ** -0.5)
    ki = torch.arange(T)[None, None, None, None, :]
    qi = idx[:, None, None, None, None] + torch.arange(S)[None, None, None,
                                                           :, None]
    logits = logits.masked_fill(~(ki <= qi), float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    ot = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(),
                      v.float())
    return ot.reshape(B, S, H, hd).to(dtype)


class _F32Outputs(TorchDispatchMode):
    """The element count of every float32 tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.sizes.append(t.numel())
        return out


def _attention_inputs(T, dtype, S=1, B=2, H=8, K=2, hd=32, seed=14):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g).to(dtype)
    k = (torch.randn(B, T, K, hd, generator=g) * 0.5).to(dtype)
    v = torch.randn(B, T, K, hd, generator=g).to(dtype)
    idx = torch.tensor([T - S, T // 3], dtype=torch.int32)[:B]
    return q, k, v, idx


@pytest.mark.parametrize("S", [1, 3])
def test_cached_attention_holds_no_f32_copy_of_a_bf16_cache(monkeypatch, S):
    """A bf16 cache of 8,192 positions with blocks of 512 KiB of f32 (16
    blocks): no op returns a float32 tensor as large as the cache's k, and
    the output is the former formula's within f32 rounding."""
    monkeypatch.setattr(layers, "CAST_BLOCK_BYTES", 1 << 19)
    q, k, v, idx = _attention_inputs(8192, torch.bfloat16, S=S)
    with _F32Outputs() as seen:
        got = layers._cached_attention(q, k, v, idx, torch.float32)
    assert max(seen.sizes) < k.numel(), (max(seen.sizes), k.numel())
    want = _former_cached_attention(q, k, v, idx, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with _F32Outputs() as seen:  # the former formula: two whole copies
        _former_cached_attention(q, k, v, idx, torch.float32)
    assert max(seen.sizes) >= k.numel()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_attention_of_one_block_is_the_former_formula(dtype):
    """A cache within ``CAST_BLOCK_BYTES`` (a float32 one, whatever its
    size, is read as it is) takes the former ops: bit for bit."""
    q, k, v, idx = _attention_inputs(300, dtype, S=2)
    got = layers._cached_attention(q, k, v, idx, dtype)
    want = _former_cached_attention(q, k, v, idx, dtype)
    assert torch.equal(got, want)
