"""Family-dispatching model facade: one API for every architecture."""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import encdec, transformer

__all__ = ["Model"]


class Model:
    """Thin functional facade: ``Model(cfg)`` then methods on explicit
    parameter and cache trees (dicts of tensors)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._m = encdec if cfg.family == "audio" else transformer

    # -- params -------------------------------------------------------------
    def init(self, seed: int = 0, device=None, *,
             max_dec_len: int = 0) -> dict:
        """Weights drawn from a ``torch.Generator`` seeded with ``seed``, on
        ``device`` (``None`` means the card); the encoder-decoder's learned
        decoder positions have ``max_dec_len`` rows (4096 for 0).  The JAX
        package's ``PRNGKey(0)`` weights cannot be drawn here; carry them
        across with :func:`repro_torch.interop.params_from_numpy`."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        if self.cfg.family == "audio":
            return encdec.init_params(self.cfg, gen, max_dec_len=max_dec_len)
        return transformer.init_params(self.cfg, gen)

    def param_count(self, params) -> int:
        return transformer.param_count(params)

    # -- full-sequence forward ----------------------------------------------
    def forward(self, params, tokens, **kw):
        return self._m.forward(self.cfg, params, tokens, **kw)

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None):
        return self._m.init_cache(self.cfg, batch, max_len,
                                  resolve_device(device))

    def decode_step(self, params, cache, tokens, **kw):
        return self._m.decode_step(self.cfg, params, cache, tokens, **kw)

    def reset_slot(self, cache, slot: int):
        if self.cfg.family == "audio":
            raise ValueError("slot reuse: decoder-only families")
        return transformer.reset_slot(self.cfg, cache, slot)

    def prefill(self, params, tokens, max_len: int, frames=None):
        if self.cfg.family == "audio":
            return encdec.prefill(self.cfg, params, tokens, max_len,
                                  frames=frames)
        return transformer.prefill(self.cfg, params, tokens, max_len)

    # -- sampling (greedy; the serving engine uses this) ---------------------
    @staticmethod
    def greedy_token(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
