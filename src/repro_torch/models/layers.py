"""Neural building blocks of the decoder LMs, in PyTorch.

The same functions as the JAX package's ``models/layers.py`` on plain dicts
of tensors with the same leaf names, so a parameter tree carries across leaf
by leaf.  Activation annotations route through :mod:`..parallel.axes` (a
rank check on one device).  Full-sequence attention on a CUDA tensor runs
the hand-written flash kernel; the KV-cache branch stays plain tensor code,
as the JAX package leaves it outside any kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import on_card
from ..kernels.flash_attention import ops as fops, ref as fref
from ..parallel.axes import act, is_dtensor

# --------------------------------------------------------------------------
# init helpers (weights drawn on the generator's device)
# --------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, dtype, scale: float):
    """N(0, 1) · scale of ``shape``, drawn in ``dtype`` and scaled in place,
    so init never holds an f32 copy of a bf16 leaf: yi-34b's MLP gate
    stack is 35.2 GB in f32 beside 68.8 GB of bf16 weights.  An f32 leaf
    keeps the values of ``randn · scale``; a bf16 leaf rounds once more
    than the reference's ``normal · scale → astype``."""
    return torch.randn(shape, dtype=dtype, generator=gen,
                       device=gen.device).mul_(scale)


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None, *, stack: int = 0):
    """N(0, 1) * scale, scale 1/sqrt(fan-in) by default; ``stack`` > 0
    prepends a layer axis of that length (the stacked segments)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    full = ((stack,) if stack else ()) + tuple(shape)
    return normal(gen, full, dtype, scale)


def embed_init(gen: torch.Generator, shape, dtype):
    return normal(gen, shape, dtype, 0.02)


def _const(shape, value, dtype, device, stack: int = 0):
    full = ((stack,) if stack else ()) + tuple(shape)
    return torch.full(full, value, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device, stack: int = 0) -> dict:
    return {"scale": _const((d,), 1.0, dtype, device, stack)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device, stack: int = 0) -> dict:
    return {"scale": _const((d,), 1.0, dtype, device, stack),
            "bias": _const((d,), 0.0, dtype, device, stack)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm(kind: str):
    return {"rmsnorm": (rmsnorm_init, rmsnorm),
            "layernorm": (layernorm_init, layernorm)}[kind]


# --------------------------------------------------------------------------
# rotary embeddings (standard, fractional, and M-RoPE)
# --------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, rot_dim: int, theta: float,
                sections: Optional[tuple] = None) -> tuple:
    """positions: (B, S) int — or (B, S, 3) for M-RoPE with ``sections``
    (t, h, w) summing to rot_dim // 2.  Returns cos, sin: (B, S, rot_dim/2),
    float32."""
    half = rot_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / torch.pow(theta, expo)  # f32, no host-to-device copy
    if sections is None:
        ang = positions.float()[..., None] * inv  # (B, S, half)
    else:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} do not sum to "
                             f"{half}")
        # frequency block i rotates by position stream i (t, h, w)
        parts, lo = [], 0
        for i, n in enumerate(sections):
            parts.append(positions[..., i:i + 1].float() * inv[lo:lo + n])
            lo += n
        ang = torch.cat(parts, dim=-1)  # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """x: (B, S, H, hd); rotate the first rot_dim dims (half-split layout)
    in float32, then cast back to x's dtype."""
    rot, rest = x[..., :rot_dim], x[..., rot_dim:]
    half = rot_dim // 2
    x1f, x2f = rot[..., :half].float(), rot[..., half:].float()
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    r1 = x1f * c - x2f * s
    r2 = x2f * c + x1f * s
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), rest], dim=-1)


# --------------------------------------------------------------------------
# attention (GQA, optional KV cache, flash kernel dispatch)
# --------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg, dtype, stack: int = 0) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, (D, H * hd), dtype, stack=stack),
        "wk": dense_init(gen, (D, K * hd), dtype, stack=stack),
        "wv": dense_init(gen, (D, K * hd), dtype, stack=stack),
        "wo": dense_init(gen, (H * hd, D), dtype,
                         scale=1.0 / math.sqrt(H * hd), stack=stack),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = _const((width,), 0.0, dtype, gen.device, stack)
    return p


def _sdpa(q, k, v, *, causal: bool, attn_chunk: int = 0) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,K,hd) → (B,S,H,hd).  BHSD under the hood.

    On a CUDA tensor every full-sequence attention runs the flash kernel,
    whatever ``use_pallas`` and ``attn_chunk`` say: in the JAX package those
    two choose among its plain paths (and its TPU kernel), so on the card the
    kernel is the one path.  On the CPU the plain versions run as the JAX
    package runs them: chunked when ``attn_chunk`` is set, else dense (its
    Pallas kernel computes the same function)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if on_card(q):
        ot = fops.mha(qt, kt, vt, causal=causal)
    elif attn_chunk:
        ot = fref.mha_chunked(qt, kt, vt, causal=causal, chunk=attn_chunk)
    else:
        ot = fops.mha(qt, kt, vt, causal=causal)
    return ot.transpose(1, 2)


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n·hd) → (B, S, n, hd).  A DTensor whose last dim is split
    over ranks off the head boundaries (n heads on more ways than divide
    them) is gathered along those ways first, as GSPMD reshards it."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        dm = t.device_mesh
        last = (Shard(t.ndim - 1), Shard(-1))
        ways = math.prod(dm.size(i) for i, p in enumerate(t.placements)
                         if p in last)
        if n % ways:
            t = t.redistribute(dm, [Replicate() if p in last else p
                                    for p in t.placements])
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def _write_rows(buf: torch.Tensor, new: torch.Tensor,
                start: torch.Tensor) -> None:
    """``buf[b, start[b]:start[b] + S] = new[b]`` for every row b, in place.

    ``start`` is clamped to ``[0, T - S]`` as ``dynamic_update_slice`` clamps
    it, and stays on the device (no host read of the cache index)."""
    if is_dtensor(buf):
        return _write_rows_sharded(buf, new, start)
    B, S = new.shape[:2]
    T = buf.shape[1]
    lo = start.clamp(0, T - S).long()
    pos = lo[:, None] + torch.arange(S, device=buf.device)[None, :]
    rows = torch.arange(B, device=buf.device)[:, None].expand(B, S)
    buf[rows, pos] = new.to(buf.dtype)


def _seq_block(dm, placements, T: int) -> tuple[list, int, int]:
    """The mesh dims that split dim 1 (a cache's positions) of a DTensor,
    and this rank's block of positions: (dims, first, length)."""
    from torch.distributed.tensor import Shard
    dims = [i for i, p in enumerate(placements) if p == Shard(1)]
    ways, block = 1, 0
    for i in dims:
        ways *= dm.size(i)
        block = block * dm.size(i) + dm.get_local_rank(i)
    return dims, block * (T // ways), T // ways


def _write_rows_sharded(buf, new, start) -> None:
    """:func:`_write_rows` into a DTensor cache whose positions (dim 1)
    may be split over ranks (the ``kv_seq`` rule): each rank writes, in
    place through ``local_map``, the rows of its batch shard that fall in
    its own block of positions.  A row's S positions taken modulo the
    block length are distinct for S up to that length, so a position
    outside the block rewrites its own old value at a slot no other
    position of the row uses; a longer S is written block by block."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm, bp = buf.device_mesh, list(buf.placements)
    T, S = buf.shape[1], new.shape[1]
    _, off, Tl = _seq_block(dm, bp, T)
    new_p = [Replicate() if p == Shard(1) else p for p in bp]
    idx_p = [p if p == Shard(0) else Replicate() for p in bp]

    def local(b, n, st):
        lo = st.clamp(0, T - S).long()
        rows = torch.arange(b.shape[0], device=b.device)[:, None]
        for j in range(0, S, Tl):
            nj = n[:, j:j + Tl].to(b.dtype)
            pos = lo[:, None] + j + torch.arange(nj.shape[1],
                                                 device=b.device)[None, :]
            inside = (pos >= off) & (pos < off + Tl)
            slot = torch.remainder(pos - off, Tl)
            r = rows.expand_as(slot)
            keep = inside.reshape(inside.shape + (1,) * (nj.ndim - 2))
            b[r, slot] = torch.where(keep, nj, b[r, slot])
        return b

    local_map(local, out_placements=bp, in_placements=(bp, new_p, idx_p),
              device_mesh=dm, redistribute_inputs=True)(buf, new, start)


# the most bytes of float32 that :func:`_cached_attention` casts a cache in
# another dtype to at once
CAST_BLOCK_BYTES = 1 << 28


def _cached_attention(q, k, v, idx, dtype):
    """Attention of q (B, S, H, hd) over the cache's k, v (B, T, K, hd):
    row b's queries sit at positions idx_b + [0, S) and see the keys up to
    their own.  GQA via a grouped einsum — never materialise repeated (or
    f32) KV.

    The products are the cache's dtype's, summed in f32 into f32 logits
    and softmax, with the probabilities cast to v's dtype before the PV
    product, as the JAX package's einsums with ``preferred_element_type``
    compute them.  A float32 cache is read as it is; a cache in another
    dtype is cast in blocks of positions of at most ``CAST_BLOCK_BYTES``
    of f32, never whole: zamba2-1.2b at 524,288 positions would otherwise
    hold 4.3 GB of f32 k and as much v in each shared application.  A
    cache that fits one block takes the same ops as a whole cast."""
    B, S, H, hd = q.shape
    K, T = k.shape[2], k.shape[1]
    qg = q.reshape(B, S, K, H // K, hd).float()
    step = (T if k.dtype == torch.float32
            else max(1, CAST_BLOCK_BYTES // (4 * B * K * hd)))
    starts = range(0, T, step)
    parts = [torch.einsum("bskgd,btkd->bkgst", qg, k[:, t:t + step].float())
             for t in starts]
    logits = (parts[0] if len(parts) == 1
              else torch.cat(parts, dim=-1)) * (hd ** -0.5)
    del parts
    ki = torch.arange(T, device=q.device)[None, None, None, None, :]
    qi = (idx.to(q.device)[:, None, None, None, None]
          + torch.arange(S, device=q.device)[None, None, None, :, None])
    logits = logits.masked_fill(~(ki <= qi), float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    ot = None
    for t in starts:
        part = torch.einsum("bkgst,btkd->bskgd",
                            probs[..., t:t + step].float(),
                            v[:, t:t + step].float())
        ot = part if ot is None else ot.add_(part)
    return ot.reshape(B, S, H, hd).to(dtype)


def _cached_attention_sharded(q, k, v, idx, dtype):
    """:func:`_cached_attention` over DTensor caches whose positions may
    be split over ranks (flash-decoding over ranks): each rank scores its
    own block of keys, the ranks' maxima meet in one all-reduce, and each
    rank's exponentiated sums and partial output, scaled to that maximum,
    in another; the output is then whole on every rank of those ways.  q
    follows the cache's batch and head shards."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm, kp = k.device_mesh, list(k.placements)
    T, hd = k.shape[1], q.shape[3]
    dims, off, _ = _seq_block(dm, kp, T)
    groups = [dm.get_group(i) for i in dims]
    qp = [Replicate() if p == Shard(1) else p for p in kp]
    ip = [p if p == Shard(0) else Replicate() for p in kp]

    def local(ql, kl, vl, il):
        B, S, H, _ = ql.shape
        K, Tl = kl.shape[2], kl.shape[1]
        qg = ql.reshape(B, S, K, H // K, hd).float()
        # one KV head at a time: a float32 copy of the rank's whole block
        # of the cache would outweigh everything else a step holds
        logits = torch.stack([
            torch.einsum("bsgd,btd->bgst", qg[:, :, h], kl[:, :, h].float())
            for h in range(K)], dim=1) * (hd ** -0.5)
        ki = off + torch.arange(Tl, device=ql.device)[None, None, None,
                                                       None, :]
        qi = (il[:, None, None, None, None]
              + torch.arange(S, device=ql.device)[None, None, None, :, None])
        logits = logits.masked_fill(~(ki <= qi), float("-inf"))
        m = logits.amax(dim=-1, keepdim=True)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        # every query sees key 0, so the maximum over all ranks is finite
        e = torch.exp(logits - m)
        lse = e.sum(dim=-1, keepdim=True)
        ot = torch.stack([
            torch.einsum("bgst,btd->bgsd", e[:, h], vl[:, :, h].float())
            for h in range(K)], dim=1)
        both = torch.cat([ot, lse], dim=-1)
        for g in groups:
            both = funcol.all_reduce(both, "sum", g)
        ot = both[..., :hd] / both[..., hd:]
        return ot.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(dtype)

    return local_map(local, out_placements=qp,
                     in_placements=(qp, kp, kp, ip), device_mesh=dm,
                     redistribute_inputs=True)(q, k, v, idx)


def attention(p: dict, cfg, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool = True, cache: Optional[dict] = None,
              kv_input: Optional[torch.Tensor] = None,
              mrope: bool = False, advance: Optional[torch.Tensor] = None):
    """Self (or cross, via ``kv_input``) attention.

    With ``cache`` (decode): write this step's k/v at the *per-row*
    ``cache["index"]`` and attend over each row's valid prefix.  ``advance``
    (B,) bool selects which rows move their index (continuous batching: an
    inactive row writes at its index without moving it, so it rewrites in
    place).  The k/v buffers of the cache are updated in place (the JAX
    package returns new ones); the index is a new tensor in the returned
    cache.  Returns (out, new_cache).
    """
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if kv_input is None else kv_input
    q = x @ p["wq"].to(x.dtype)
    k = src @ p["wk"].to(x.dtype)
    v = src @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = _split_heads(q, H, hd)
    k = _split_heads(k, K, hd)
    v = _split_heads(v, K, hd)
    q = act(q, "batch", "seq", "heads", None)
    k = act(k, "batch", "seq", "heads", None)
    if kv_input is None:  # RoPE only for self-attention
        rot = int(cfg.hd * cfg.rope_fraction) // 2 * 2
        if rot:
            sections = cfg.mrope_sections if mrope else None
            cos, sin = rope_angles(positions, rot, cfg.rope_theta, sections)
            q = apply_rope(q, cos, sin, rot)
            k = apply_rope(k, cos, sin, rot)
    new_cache = None
    if cache is not None:
        idx = cache["index"]  # (B,) per-row write position
        if advance is None:
            advance = torch.ones((B,), dtype=torch.bool, device=x.device)
        step = torch.where(advance.to(x.device), S, 0).to(idx.dtype)
        new_idx = idx + step
        if cfg.kv_quant:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            for name, new in (("k", kq), ("v", vq), ("k_scale", ks),
                              ("v_scale", vs)):
                _write_rows(cache[name], new, idx)
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "k_scale": cache["k_scale"],
                         "v_scale": cache["v_scale"], "index": new_idx}
            k = _kv_dequantize(cache["k"], cache["k_scale"], x.dtype)
            v = _kv_dequantize(cache["v"], cache["v_scale"], x.dtype)
        else:
            _write_rows(cache["k"], k, idx)
            _write_rows(cache["v"], v, idx)
            new_cache = {"k": cache["k"], "v": cache["v"], "index": new_idx}
            k, v = cache["k"], cache["v"]
        out = (_cached_attention_sharded if is_dtensor(k)
               else _cached_attention)(q, k, v, idx, x.dtype)
    else:
        out = _sdpa(q, k, v, causal=causal, attn_chunk=cfg.attn_chunk)
    out = out.reshape(B, S, H * hd)
    out = out @ p["wo"].to(x.dtype)
    return act(out, "batch", "seq", "d"), new_cache


def attention_cache(cfg, batch: int, max_len: int, dtype, device,
                    stack: int = 0) -> dict:
    K, hd = cfg.n_kv_heads, cfg.hd
    lead = (stack,) if stack else ()

    def zeros(shape, dt):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    if cfg.kv_quant:  # int8 payload + per-(pos, head) scale: ~2x smaller
        return {
            "k": zeros((batch, max_len, K, hd), torch.int8),
            "v": zeros((batch, max_len, K, hd), torch.int8),
            "k_scale": zeros((batch, max_len, K), torch.float32),
            "v_scale": zeros((batch, max_len, K), torch.float32),
            "index": zeros((batch,), torch.int32),
        }
    return {
        "k": zeros((batch, max_len, K, hd), dtype),
        "v": zeros((batch, max_len, K, hd), dtype),
        "index": zeros((batch,), torch.int32),
    }


def _kv_quantize(x: torch.Tensor):
    """x: (B, S, K, hd) → int8 payload + (B, S, K) scale."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale[..., None]).to(dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg, dtype, d_ff: Optional[int] = None,
             stack: int = 0) -> dict:
    D = cfg.d_model
    Ff = d_ff if d_ff is not None else cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "gate": dense_init(gen, (D, Ff), dtype, stack=stack),
            "up": dense_init(gen, (D, Ff), dtype, stack=stack),
            "down": dense_init(gen, (Ff, D), dtype,
                               scale=1.0 / math.sqrt(Ff), stack=stack),
        }
    return {  # plain gelu MLP (whisper)
        "up": dense_init(gen, (D, Ff), dtype, stack=stack),
        "up_b": _const((Ff,), 0.0, dtype, gen.device, stack),
        "down": dense_init(gen, (Ff, D), dtype, scale=1.0 / math.sqrt(Ff),
                           stack=stack),
        "down_b": _const((D,), 0.0, dtype, gen.device, stack),
    }


def mlp(p: dict, cfg, x: torch.Tensor, *, act_fn: Optional[str] = None):
    kind = act_fn or cfg.act
    if kind in ("swiglu", "geglu"):
        g = act(x @ p["gate"].to(x.dtype), "batch", "seq", "ff")
        u = act(x @ p["up"].to(x.dtype), "batch", "seq", "ff")
        h = (F.silu(g) if kind == "swiglu"
             else F.gelu(g, approximate="tanh")) * u
        out = h @ p["down"].to(x.dtype)
    else:
        h = act(x @ p["up"].to(x.dtype), "batch", "seq", "ff") \
            + p["up_b"].to(x.dtype)
        h = F.gelu(h, approximate="tanh")
        out = h @ p["down"].to(x.dtype) + p["down_b"].to(x.dtype)
    return act(out, "batch", "seq", "d")


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, cfg, dtype) -> dict:
    p = {"embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype)}
    if not cfg.tied_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype)
    return p


def _split_dims(t, dim: int) -> list:
    """The mesh dims over which DTensor ``t`` splits its dim ``dim``."""
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(t.placements)
            if pl in (Shard(dim), Shard(dim - t.ndim))]


def _first_index(t, placements, dim: int) -> int:
    """The global index of this rank's first entry along ``dim`` of
    DTensor ``t`` placed by ``placements``, as DTensor lays out shards
    (each mesh dim that splits ``dim``, in mesh order, cuts the block
    before it into chunks of ceil(size / ways)), so a dim the ranks split
    unevenly is right too."""
    from torch.distributed.tensor import Shard
    dm = t.device_mesh
    size, first = t.shape[dim], 0
    for i, pl in enumerate(placements):
        if pl == Shard(dim):
            chunk = -(-size // dm.size(i))
            start = min(dm.get_local_rank(i) * chunk, size)
            first += start
            size = min(chunk, size - start)
    return first


def _as_dtensor(t, dm):
    """``t`` as a DTensor on ``dm``: a plain tensor is the same on every
    rank (replicated)."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                              run_check=False)


def _row_placements(t, split: list) -> list:
    """DTensor ``t``'s shards of its leading two dims (batch, sequence) on
    the mesh dims not in ``split``, ``Replicate`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return [pl if pl in (Shard(0), Shard(1)) and i not in split
            else Replicate() for i, pl in enumerate(t.placements)]


def _scaled(x: torch.Tensor, cfg) -> torch.Tensor:
    """Looked-up embeddings in the compute dtype, scaled by √d where the
    arch asks for it."""
    x = x.to(getattr(torch, cfg.compute_dtype))
    if cfg.embed_scale:  # the scale rounds to x's dtype first, as in JAX
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def _embed_vocab_parallel(w, tokens, vocab: list, cfg):
    """The lookup of table rows split over the mesh dims ``vocab``, in
    Megatron-LM's vocab-parallel form, through ``local_map``: each rank
    looks up the tokens that fall in its rows [lo, hi) and zeroes the
    others, so the embeddings come back as a partial sum over the vocab
    ways (exact: one rank holds each row).  The table's gradient is an
    index-add into the rank's own rows, ``Shard(0)`` with no collective
    (partial over the ways that split the tokens)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = w.device_mesh
    n = dm.ndim
    wp = [Shard(0) if i in vocab else Replicate() for i in range(n)]
    tokens = _as_dtensor(tokens, dm)
    tp = _row_placements(tokens, vocab)
    lo = _first_index(w, wp, 0)

    def local(wl, ids):
        inside = (ids >= lo) & (ids < lo + wl.shape[0])
        x = _scaled(wl[torch.where(inside, ids - lo, 0).long()], cfg)
        return x.masked_fill(~inside[..., None], 0)

    xp = [Partial() if i in vocab else tp[i] for i in range(n)]
    wg = [Partial() if isinstance(tp[i], Shard) else wp[i]
          for i in range(n)]
    return local_map(local, out_placements=xp, in_placements=(wp, tp),
                     in_grad_placements=(wg, tp), device_mesh=dm,
                     redistribute_inputs=True)(w, tokens)


def embed(p: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The embeddings of ``tokens`` in the compute dtype.  A DTensor table
    whose rows are split over a mesh is looked up vocab-parallel
    (:func:`_embed_vocab_parallel`); one whose rows are whole is gathered
    whole for the lookup (the fallback of a vocab the ways do not
    divide)."""
    w = p["embed"]
    if not is_dtensor(w):
        x = _scaled(w[tokens.long()], cfg)
    elif _split_dims(w, 0):
        x = _embed_vocab_parallel(w, tokens, _split_dims(w, 0), cfg)
    else:  # through F.embedding, which has a DTensor rule
        from torch.distributed.tensor import Replicate
        w = w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)
        x = _scaled(F.embedding(tokens.long(), w), cfg)
    return act(x, "batch", "seq", "d")


class _VocabShare(torch.autograd.Function):
    """One rank's share of the cross-entropy of float32 logits whose vocab
    is split over ranks: per row, Σ exp(l − m) over the rank's columns
    (m the row's maximum over every rank) and the gold logit where the
    label is one of the rank's columns [lo, lo + V_local) (0 elsewhere),
    stacked (..., 2).  Both sum over the vocab ways to the row's whole
    values.  The backward is softmax − one-hot on the rank's own columns,
    from the upstream gradients of the two sums (1/Σexp and −1 times the
    loss's), with no collective."""

    @staticmethod
    def forward(ctx, logits, m, labels, lo: int):
        inside = (labels >= lo) & (labels < lo + logits.shape[-1])
        col = torch.where(inside, labels - lo, 0).long()[..., None]
        sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
        gold = torch.gather(logits, -1, col)[..., 0].masked_fill(~inside, 0)
        ctx.save_for_backward(logits, m, col, inside)
        return torch.stack([sumexp, gold], dim=-1)

    @staticmethod
    def backward(ctx, g):
        logits, m, col, inside = ctx.saved_tensors
        grad = torch.exp(logits - m[..., None]) * g[..., :1]
        grad.scatter_add_(-1, col, (g[..., 1] * inside)[..., None])
        return grad, None, None, None


def _nll_vocab_parallel(logits, labels, vocab: list) -> torch.Tensor:
    """:func:`nll_sum` of logits whose vocab is split over the mesh dims
    ``vocab``: the rows' maxima meet as a max over the vocab ways, then
    each rank's Σexp and gold logit (:class:`_VocabShare`) as a sum, both
    as ``DTensor`` redistributions of ``Partial`` outputs; the logits'
    gradient stays on each rank's columns."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = logits.device_mesh
    n = dm.ndim
    rp = _row_placements(logits, vocab)
    lp = [Shard(2) if i in vocab else rp[i] for i in range(n)]
    labels = _as_dtensor(labels, dm)
    lo = _first_index(logits, lp, 2)
    with torch.no_grad():
        m = local_map(lambda lg: lg.amax(dim=-1),
                      out_placements=[Partial("max") if i in vocab else rp[i]
                                      for i in range(n)],
                      in_placements=(lp,), device_mesh=dm,
                      redistribute_inputs=True)(logits)
    m = m.redistribute(dm, rp)
    parts = local_map(lambda lg, mx, y: _VocabShare.apply(lg, mx, y, lo),
                      out_placements=[Partial() if i in vocab else rp[i]
                                      for i in range(n)],
                      in_placements=(lp, rp, rp), device_mesh=dm,
                      redistribute_inputs=True)(logits, m, labels)
    parts = parts.redistribute(dm, rp)
    return torch.sum(m + torch.log(parts[..., 0]) - parts[..., 1])


def nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp(logits) − logits[label]) over every (b, s) of float32
    logits (B, S, V).  For DTensors, logits whose vocab is split over
    ranks take the vocab-parallel cross-entropy
    (:func:`_nll_vocab_parallel`); logits whole in V are summed by each
    rank over its own rows through ``local_map`` (the backward of the label
    gather has no sharding rule that stays on the rank's rows).  Either
    leaves a partial sum over the batch and sequence ways."""
    if is_dtensor(logits):
        vocab = _split_dims(logits, 2)
        if vocab:
            return _nll_vocab_parallel(logits, labels, vocab)
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        rows = (Shard(0), Shard(1))
        lp = [pl if pl in rows else Replicate() for pl in logits.placements]
        op = [Partial() if pl in rows else Replicate() for pl in lp]
        return local_map(nll_sum, out_placements=op, in_placements=(lp, lp),
                         device_mesh=logits.device_mesh,
                         redistribute_inputs=True)(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def unembed(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    w = p["embed"].T if cfg.tied_embeddings else p["lm_head"]
    return act(x @ w.to(x.dtype), "batch", "seq", "vocab")
