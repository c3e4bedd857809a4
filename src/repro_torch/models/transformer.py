"""Decoder LM of the dense, VLM, MoE, SSM and hybrid families, in PyTorch.

The JAX package's ``models/transformer.py`` for the families whose blocks
are attention + MLP, attention + MoE or Mamba2.  A model is a sequence of
*segments*, homogeneous runs of one block kind whose parameters are stacked
on a leading layer axis ``(L, ...)`` as the reference's ``vmap`` init
makes them; a Python loop indexes that axis where the reference runs
``lax.scan``.  zamba2's *shared* attention block (one parameter set applied
every ``period`` layers) sits between mamba segments; its weights live once
in the tree (``params["shared_block"]``) and its segments are empty.

Entry points::

    init_params(cfg, gen)                         -> params
    forward(cfg, params, tokens, ...)             -> (logits, aux)
    init_cache(cfg, batch, max_len, device)       -> cache
    decode_step(cfg, params, cache, tokens, ...)  -> (logits, cache)
    prefill(cfg, params, tokens, max_len)         -> (logits, cache)
    reset_slot(cfg, cache, slot)                  -> cache

A MoE layer adds its load-balancing aux loss to ``forward``'s second
output; the decode step drops it, as the reference's does.  The training
loss, remat and ``scan_layers`` come with the training slice.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.utils._pytree as pytree

from . import layers, mamba, moe

__all__ = ["structure", "init_params", "forward", "hidden_states",
           "init_cache", "decode_step", "prefill", "reset_slot",
           "param_count"]

# cache leaves an attention layer updates in place (the rest are new)
_IN_PLACE = ("k", "v", "k_scale", "v_scale")


# --------------------------------------------------------------------------
# segment structure per family
# --------------------------------------------------------------------------

def structure(cfg) -> list[tuple[str, int]]:
    """Returns [(block_kind, count), ...] covering cfg.n_layers."""
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        return [("attn", L)]
    if cfg.family == "moe":
        if cfg.moe.layer0_dense:
            return [("attn", 1), ("attn_moe", L - 1)]
        return [("attn_moe", L)]
    if cfg.family == "ssm":
        return [("mamba", L)]
    if cfg.family == "hybrid":
        segs: list[tuple[str, int]] = []
        period = cfg.hybrid.period
        remaining = L
        while remaining > 0:
            run = min(period, remaining)
            segs.append(("mamba", run))
            remaining -= run
            if remaining > 0 or run == period:
                segs.append(("shared_attn", 1))
        return segs
    raise ValueError(f"unknown family {cfg.family!r} (audio → encdec)")


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _block_init(gen, cfg, dtype, kind: str, stack: int) -> dict:
    """A block of ``kind``, its leaves stacked ``stack`` deep (0: one
    unstacked block, the shared attention)."""
    ninit, _ = layers.norm(cfg.norm)
    if kind == "mamba":
        return {"norm1": ninit(cfg.d_model, dtype, gen.device, stack),
                "mamba": mamba.mamba_init(gen, cfg, dtype, stack)}
    p = {
        "norm1": ninit(cfg.d_model, dtype, gen.device, stack),
        "attn": layers.attention_init(gen, cfg, dtype, stack),
        "norm2": ninit(cfg.d_model, dtype, gen.device, stack),
    }
    if kind == "attn_moe":
        p["moe"] = moe.moe_init(gen, cfg, dtype, stack)
        return p
    d_ff = cfg.d_ff
    if kind == "shared_attn" and cfg.hybrid and cfg.hybrid.shared_d_ff:
        d_ff = cfg.hybrid.shared_d_ff
    p["mlp"] = layers.mlp_init(gen, cfg, dtype, d_ff=d_ff, stack=stack)
    return p


def _block_apply(p: dict, cfg, x, positions, kind: str, cache=None,
                 advance=None):
    """Returns (x, aux, new_cache); aux is the MoE layer's load-balancing
    loss (None for every other kind)."""
    _, napply = layers.norm(cfg.norm)
    nfn = functools.partial(napply, eps=cfg.norm_eps)
    h = nfn(p["norm1"], x)
    if kind == "mamba":
        if cache is None:
            return x + mamba.mamba_apply(p["mamba"], cfg, h), None, None
        if h.shape[1] > 1:  # prefill: a fresh full scan hands over its state
            out, new_cache = mamba.mamba_apply(p["mamba"], cfg, h,
                                               return_state=True)
        else:
            out, new_cache = mamba.mamba_decode_step(p["mamba"], cfg, h,
                                                     cache, advance=advance)
        return x + out, None, new_cache
    a_out, new_cache = layers.attention(
        p["attn"], cfg, h, positions=positions, causal=True, cache=cache,
        mrope=cfg.mrope, advance=advance)
    x = x + a_out
    h2 = nfn(p["norm2"], x)
    if kind == "attn_moe":
        f, aux = moe.moe_apply(p["moe"], cfg, h2)
        return x + f, aux, new_cache
    return x + layers.mlp(p["mlp"], cfg, h2), None, new_cache


def _layer(tree, i: int):
    """Layer ``i`` of a stacked segment: views of every leaf."""
    return pytree.tree_map(lambda leaf: leaf[i], tree)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_params(cfg, gen: torch.Generator) -> dict:
    """Seeded weights on ``gen``'s device, in ``cfg.param_dtype``."""
    dtype = getattr(torch, cfg.param_dtype)
    ninit, _ = layers.norm(cfg.norm)
    params: dict[str, Any] = {
        "embedding": layers.embedding_init(gen, cfg, dtype),
        "final_norm": ninit(cfg.d_model, dtype, gen.device),
        "segments": [],
    }
    if any(kind == "shared_attn" for kind, _ in structure(cfg)):
        params["shared_block"] = _block_init(gen, cfg, dtype, "shared_attn",
                                             0)
    for kind, count in structure(cfg):
        params["segments"].append(  # shared weights live in shared_block
            {} if kind == "shared_attn"
            else _block_init(gen, cfg, dtype, kind, count))
    return params


def param_count(params) -> int:
    return sum(int(x.numel()) for x in pytree.tree_leaves(params))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _positions(cfg, tokens, offset=0):
    """(B, S) int32 positions ``offset + [0, S)``; ``offset`` is an int or a
    (B,) tensor of per-row offsets (continuous batching).  M-RoPE gets
    (B, S, 3) with the (t, h, w) streams equal (text only)."""
    B, S = tokens.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)[None]
    if isinstance(offset, torch.Tensor):  # stays on the device
        off = offset.to(torch.int32)
        pos = pos + (off[:, None] if off.ndim == 1 else off)
    else:
        pos = pos + offset
    pos = pos.expand(B, S)
    if cfg.mrope:
        pos = pos[..., None].expand(B, S, 3)
    return pos


def hidden_states(cfg, params, tokens, *, positions=None,
                  input_embeds=None):
    """Backbone up to (and including) the final norm: (B,S,D), and the sum
    of the MoE layers' aux losses (f32, 0 without MoE layers)."""
    x = (layers.embed(params["embedding"], cfg, tokens)
         if input_embeds is None else input_embeds)
    pos = _positions(cfg, tokens) if positions is None else positions
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (kind, count), seg_p in zip(structure(cfg), params["segments"]):
        layer_params = ([params["shared_block"]] if kind == "shared_attn"
                        else [_layer(seg_p, i) for i in range(count)])
        for lp in layer_params:
            x, aux, _ = _block_apply(lp, cfg, x, pos, kind)
            if aux is not None:
                aux_total = aux_total + aux
    _, napply = layers.norm(cfg.norm)
    x = napply(params["final_norm"], x, eps=cfg.norm_eps)
    return x, aux_total


def forward(cfg, params, tokens, *, positions=None, input_embeds=None):
    """Full-sequence forward (scoring a prompt: a prefill without a cache).

    Returns (logits, aux_loss); aux sums the MoE layers' load-balancing
    losses, and is 0 for the families without MoE layers."""
    x, aux = hidden_states(cfg, params, tokens, positions=positions,
                           input_embeds=input_embeds)
    return layers.unembed(params["embedding"], cfg, x), aux


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zero cache in ``cfg.compute_dtype`` (the mamba ``h`` state in f32):
    leaves (L, B, ...) per stacked segment, (B, ...) for each application
    of the shared attention block, plus the per-row ``step`` counter."""
    dtype = getattr(torch, cfg.compute_dtype)
    segments = []
    for kind, count in structure(cfg):
        if kind == "mamba":
            segments.append(mamba.mamba_cache(cfg, batch, dtype, device,
                                              stack=count))
        else:
            segments.append(layers.attention_cache(
                cfg, batch, max_len, dtype, device,
                stack=0 if kind == "shared_attn" else count))
    return {"segments": segments,
            "step": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _restack(seg_c: dict, layer_caches: list) -> dict:
    """A stacked segment's new cache from its layers' new caches: the k/v
    buffers were written in place and stay the segment's own; every other
    leaf (an index, a mamba state) is stacked anew."""
    new_seg = dict(seg_c)
    for name in layer_caches[0]:
        if name not in _IN_PLACE:
            new_seg[name] = torch.stack([nc[name] for nc in layer_caches])
    return new_seg


def decode_step(cfg, params, cache, tokens, *, positions=None, advance=None):
    """tokens: (B, S_step) (S_step=1 for pure decode).  Returns
    (logits, new_cache).  ``advance`` (B,) bool: continuous-batching rows.

    The k/v buffers are written in place (see :func:`layers.attention`), so
    the new cache shares them with ``cache``.  With S_step > 1 (prefill) a
    mamba layer runs a fresh full scan from a zero state, whatever its
    cache and ``advance`` say, as in the JAX package."""
    x = layers.embed(params["embedding"], cfg, tokens)
    pos = (_positions(cfg, tokens, offset=cache["step"])
           if positions is None else positions)
    B, S = tokens.shape[:2]
    adv = (torch.ones((B,), dtype=torch.bool, device=tokens.device)
           if advance is None else advance.to(tokens.device))
    new_cache: dict[str, Any] = {
        "segments": [],
        "step": cache["step"] + torch.where(adv, S, 0).to(torch.int32)}
    for (kind, count), seg_p, seg_c in zip(
            structure(cfg), params["segments"], cache["segments"]):
        if kind == "shared_attn":
            x, _, nc = _block_apply(params["shared_block"], cfg, x, pos,
                                    kind, cache=seg_c, advance=adv)
            new_cache["segments"].append(nc)
            continue
        layer_caches = []
        for i in range(count):
            x, _, nc = _block_apply(_layer(seg_p, i), cfg, x, pos, kind,
                                    cache=_layer(seg_c, i), advance=adv)
            layer_caches.append(nc)
        new_cache["segments"].append(_restack(seg_c, layer_caches))
    _, napply = layers.norm(cfg.norm)
    x = napply(params["final_norm"], x, eps=cfg.norm_eps)
    return layers.unembed(params["embedding"], cfg, x), new_cache


def prefill(cfg, params, tokens, max_len: int):
    """Process the prompt, building the cache.  Returns (logits, cache)."""
    cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
    return decode_step(cfg, params, cache, tokens)


def reset_slot(cfg, cache, slot: int):
    """Zero one batch row of the cache (slot reuse in continuous batching),
    in place.  Cache leaves are (L, B, ...) for stacked segments and
    (B, ...) for the shared block, so the batch axis is 1 or 0."""
    for (kind, _), seg_c in zip(structure(cfg), cache["segments"]):
        for leaf in pytree.tree_leaves(seg_c):
            if kind == "shared_attn":
                leaf[slot] = 0
            else:
                leaf[:, slot] = 0
    cache["step"][slot] = 0
    return cache
