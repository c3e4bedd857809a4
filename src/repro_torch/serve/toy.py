"""A deterministic toy LM with the serving decode interface.

The serving engine's oracle tests need a model whose ``decode_step`` is
cheap enough to run hundreds of steps in seconds, yet exercises the exact
contract the real :class:`repro_torch.models.Model` facade exposes to the
engine:

* ``init_cache(batch, max_len, device)`` — per-slot recurrent state,
* ``decode_step(params, cache, tokens, advance=)`` — one batched step whose
  ``advance`` mask freezes non-active rows (the continuous-batching
  invariant: a parked slot's cache must not move),
* ``reset_slot(cache, slot)`` — zero one row for slot reuse.

:class:`ToyLM` is a tanh recurrence over token embeddings with tied
input/output embeddings: the next token depends on the whole prefix through
the hidden state, so prefill order, advance masking and slot-reset bugs all
change its argmax outputs.  Every operation is per row, which keeps
generation bit-identical across slot counts — the property the serving
oracle tests lean on.
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device

__all__ = ["ToyLM"]


class ToyLM:
    """Tiny deterministic autoregressive LM (tanh recurrence, tied embed)."""

    def __init__(self, vocab: int = 32, dim: int = 8):
        self.vocab = vocab
        self.dim = dim

    def init(self, seed: int = 0, device=None) -> dict:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        s = 1.0 / math.sqrt(self.dim)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        return {"emb": normal(self.vocab, self.dim) * s,
                "w": normal(self.dim, self.dim) * s,
                "b": normal(self.dim) * 0.1}

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        del max_len  # the recurrence carries fixed-size state per slot
        dev = resolve_device(device)
        return {"h": torch.zeros((batch, self.dim), device=dev),
                "step": torch.zeros((batch,), dtype=torch.int32,
                                    device=dev)}

    def decode_step(self, params, cache, tokens, *, advance=None):
        """``tokens (B, S) -> (logits (B, 1, V), new_cache)``; rows where
        ``advance`` is False keep their cache (and their logits are
        ignored by the caller, as in the real models)."""
        b, s = tokens.shape
        adv = (torch.ones((b,), dtype=torch.bool, device=tokens.device)
               if advance is None else advance)
        h = cache["h"]
        for t in range(s):  # the reference's lax.scan over the step
            h2 = torch.tanh(h @ params["w"] + params["emb"][tokens[:, t].long()]
                            + params["b"])
            h = torch.where(adv[:, None], h2, h)
        logits = (h @ params["emb"].T)[:, None, :]
        return logits, {"h": h, "step": cache["step"]
                        + torch.where(adv, s, 0).to(torch.int32)}

    def reset_slot(self, cache, slot: int) -> dict:
        h, step = cache["h"].clone(), cache["step"].clone()
        h[slot] = 0.0
        step[slot] = 0
        return {"h": h, "step": step}
