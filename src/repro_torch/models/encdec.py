"""Whisper-style encoder-decoder backbone (whisper-tiny), in PyTorch.

The JAX package's ``models/encdec.py`` on the same parameter and cache
trees.  The conv audio frontend is a stub: callers pass precomputed frame
embeddings (B, S_frames, D).  The backbone is pre-LN: LayerNorm, GELU MLPs,
sinusoidal positions on the encoder, learned positions on the decoder,
causal self-attention and full cross-attention in the decoder.  The
encoder's and decoder's blocks are stacked on a leading layer axis
``(L, ...)`` as the reference's ``vmap`` init makes them; a Python loop
indexes that axis where the reference runs ``lax.scan`` (so ``remat`` and
``scan_layers`` change nothing in a forward).

On a CUDA tensor every attention without a KV cache runs the hand-written
flash kernel (:func:`layers._sdpa`): the encoder's self-attention and the
decoder's cross-attention without causality, the decoder's self-attention
in :func:`forward` with it.  The KV-cache self-attention of
:func:`prefill` and :func:`decode_step` stays plain tensor code, as in the
JAX package.

Entry points::

    init_params(cfg, gen, *, max_dec_len=0)            -> params
    encode(cfg, params, frames)                        -> enc_out
    forward(cfg, params, tokens, *, frames=None)       -> (logits, 0.0)
    init_cache(cfg, batch, max_len, device, enc_frames=0) -> cache
    prefill(cfg, params, tokens, max_len, frames=None) -> (logits, cache)
    decode_step(cfg, params, cache, tokens)            -> (logits, cache)

The training loss comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.axes import act
from . import layers
from .transformer import _layer, _restack

__all__ = ["init_params", "encode", "forward", "init_cache", "prefill",
           "decode_step"]

MAX_DEC_LEN = 4096  # rows of the learned decoder positions by default


def _sinusoid(length: int, d: int, device) -> torch.Tensor:
    """(length, d) float32: ``[sin | cos]`` of the position angles,
    concatenated (not interleaved)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_init(gen, cfg, dtype, stack: int) -> dict:
    dev = gen.device
    return {
        "norm1": layers.layernorm_init(cfg.d_model, dtype, dev, stack),
        "attn": layers.attention_init(gen, cfg, dtype, stack),
        "norm2": layers.layernorm_init(cfg.d_model, dtype, dev, stack),
        "mlp": layers.mlp_init(gen, cfg, dtype, stack=stack),
    }


def _dec_block_init(gen, cfg, dtype, stack: int) -> dict:
    dev = gen.device
    return {
        "norm1": layers.layernorm_init(cfg.d_model, dtype, dev, stack),
        "self_attn": layers.attention_init(gen, cfg, dtype, stack),
        "norm_x": layers.layernorm_init(cfg.d_model, dtype, dev, stack),
        "cross_attn": layers.attention_init(gen, cfg, dtype, stack),
        "norm2": layers.layernorm_init(cfg.d_model, dtype, dev, stack),
        "mlp": layers.mlp_init(gen, cfg, dtype, stack=stack),
    }


def init_params(cfg, gen: torch.Generator, *, max_dec_len: int = 0) -> dict:
    """Seeded weights on ``gen``'s device, in ``cfg.param_dtype``; the
    learned decoder positions have ``max_dec_len`` rows (4096 for 0)."""
    dtype = getattr(torch, cfg.param_dtype)
    max_dec = max_dec_len or MAX_DEC_LEN
    return {
        "embedding": layers.embedding_init(gen, cfg, dtype),
        "dec_pos": (torch.randn((max_dec, cfg.d_model), generator=gen,
                                device=gen.device) * 0.01).to(dtype),
        "enc": _enc_block_init(gen, cfg, dtype, cfg.encdec.n_enc_layers),
        "dec": _dec_block_init(gen, cfg, dtype, cfg.n_layers),
        "enc_norm": layers.layernorm_init(cfg.d_model, dtype, gen.device),
        "dec_norm": layers.layernorm_init(cfg.d_model, dtype, gen.device),
    }


def _stub_frames(cfg, tokens) -> torch.Tensor:
    """Zero frames, ``max(S // frontend_downsample, 1)`` of them, in the
    compute dtype: the reference's stand-in when no frames are given."""
    B, S = tokens.shape
    Sf = max(S // cfg.encdec.frontend_downsample, 1)
    return torch.zeros((B, Sf, cfg.d_model),
                       dtype=getattr(torch, cfg.compute_dtype),
                       device=tokens.device)


def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_f, D) precomputed frame embeddings (frontend stub)."""
    B, Sf, D = frames.shape
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + _sinusoid(Sf, D, x.device).to(x.dtype)[None]
    x = act(x, "batch", "seq", "d")
    pos = torch.arange(Sf, dtype=torch.int32,
                       device=x.device)[None].expand(B, Sf)
    for i in range(cfg.encdec.n_enc_layers):
        lp = _layer(params["enc"], i)
        a, _ = layers.attention(lp["attn"], cfg,
                                layers.layernorm(lp["norm1"], x),
                                positions=pos, causal=False)
        x = x + a
        x = x + layers.mlp(lp["mlp"], cfg, layers.layernorm(lp["norm2"], x),
                           act_fn="gelu")
    return layers.layernorm(params["enc_norm"], x)


def _dec_block(lp, cfg, x, enc_out, pos, cache=None):
    h = layers.layernorm(lp["norm1"], x)
    a, nc = layers.attention(lp["self_attn"], cfg, h, positions=pos,
                             causal=True, cache=cache)
    x = x + a
    h = layers.layernorm(lp["norm_x"], x)
    c, _ = layers.attention(lp["cross_attn"], cfg, h, positions=pos,
                            causal=False, kv_input=enc_out)
    x = x + c
    x = x + layers.mlp(lp["mlp"], cfg, layers.layernorm(lp["norm2"], x),
                       act_fn="gelu")
    return x, nc


def forward(cfg, params, tokens, *, frames: Optional[torch.Tensor] = None):
    """Teacher-forced decoder over the encoded (stub) frames.

    tokens: (B, S); frames: (B, S_f, D), or zeros if None.  Returns
    (logits, aux) with aux a float32 0 (no MoE layer)."""
    B, S = tokens.shape
    if frames is None:
        frames = _stub_frames(cfg, tokens)
    enc_out = encode(cfg, params, frames)
    x = layers.embed(params["embedding"], cfg, tokens)
    x = x + params["dec_pos"][:S].to(x.dtype)[None]
    pos = torch.arange(S, dtype=torch.int32,
                       device=x.device)[None].expand(B, S)
    for i in range(cfg.n_layers):
        x, _ = _dec_block(_layer(params["dec"], i), cfg, x, enc_out, pos)
    x = layers.layernorm(params["dec_norm"], x)
    logits = layers.unembed(params["embedding"], cfg, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg, batch: int, max_len: int, device,
               enc_frames: int = 0) -> dict:
    """Zero cache in ``cfg.compute_dtype``: the decoder's self-attention
    k/v stacked over its layers, the encoder output of ``enc_frames``
    frames (``max_len // frontend_downsample`` for 0) and a 0-d ``step``."""
    dtype = getattr(torch, cfg.compute_dtype)
    frames = enc_frames or max(max_len // cfg.encdec.frontend_downsample, 1)
    return {
        "self": layers.attention_cache(cfg, batch, max_len, dtype, device,
                                       stack=cfg.n_layers),
        "enc_out": torch.zeros((batch, frames, cfg.d_model), dtype=dtype,
                               device=device),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _check_positions(params, max_len: int) -> None:
    """The cache must not outrun the learned decoder positions: the JAX
    package's gather past them reads NaN, a CUDA gather asserts on the
    device.  Reads shapes only (no host sync)."""
    rows = params["dec_pos"].shape[0]
    if max_len > rows:
        raise ValueError(f"cache length {max_len} exceeds the {rows} learned "
                         "decoder positions (init with a larger max_dec_len)")


def prefill(cfg, params, tokens, max_len: int, frames=None):
    """Encode the (stub) frames, then teacher-feed the prompt through the
    decoder, building its self-attention cache.  Returns (logits, cache)."""
    _check_positions(params, max_len)
    if frames is None:
        frames = _stub_frames(cfg, tokens)
    cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device,
                       enc_frames=frames.shape[1])
    cache["enc_out"] = encode(cfg, params, frames)
    return decode_step(cfg, params, cache, tokens)


def decode_step(cfg, params, cache, tokens):
    """One decoder step of tokens (B, S_step) against the cached encoder
    output.  Returns (logits, new_cache).

    The self-attention k/v buffers are written in place (see
    :func:`layers.attention`), so the new cache shares them with
    ``cache``."""
    _check_positions(params, cache["self"]["k"].shape[2])
    B, S = tokens.shape
    x = layers.embed(params["embedding"], cfg, tokens)
    pos_idx = cache["step"] + torch.arange(S, dtype=torch.int32,
                                           device=x.device)
    x = x + params["dec_pos"][pos_idx.long()].to(x.dtype)[None]
    pos = pos_idx[None].expand(B, S)
    enc_out = cache["enc_out"]
    layer_caches = []
    for i in range(cfg.n_layers):
        x, nc = _dec_block(_layer(params["dec"], i), cfg, x, enc_out, pos,
                           cache=_layer(cache["self"], i))
        layer_caches.append(nc)
    x = layers.layernorm(params["dec_norm"], x)
    logits = layers.unembed(params["embedding"], cfg, x)
    return logits, {"self": _restack(cache["self"], layer_caches),
                    "enc_out": enc_out, "step": cache["step"] + S}
