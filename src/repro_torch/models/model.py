"""Family-dispatching model facade: one API for the ported architectures."""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import transformer

__all__ = ["Model"]


class Model:
    """Thin functional facade: ``Model(cfg)`` then methods on explicit
    parameter and cache trees (dicts of tensors)."""

    def __init__(self, cfg):
        if cfg.family == "audio":
            raise NotImplementedError(
                f"{cfg.name}: the audio (encoder-decoder) family is not "
                "ported yet; it comes with the encoder-decoder slice")
        self.cfg = cfg

    # -- params -------------------------------------------------------------
    def init(self, seed: int = 0, device=None) -> dict:
        """Weights drawn from a ``torch.Generator`` seeded with ``seed``, on
        ``device`` (``None`` means the card).  The JAX package's
        ``PRNGKey(0)`` weights cannot be drawn here; carry them across with
        :func:`repro_torch.interop.params_from_numpy`."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_params(self.cfg, gen)

    def param_count(self, params) -> int:
        return transformer.param_count(params)

    # -- full-sequence forward ----------------------------------------------
    def forward(self, params, tokens, **kw):
        return transformer.forward(self.cfg, params, tokens, **kw)

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None):
        return transformer.init_cache(self.cfg, batch, max_len,
                                      resolve_device(device))

    def decode_step(self, params, cache, tokens, **kw):
        return transformer.decode_step(self.cfg, params, cache, tokens, **kw)

    def reset_slot(self, cache, slot: int):
        return transformer.reset_slot(self.cfg, cache, slot)

    def prefill(self, params, tokens, max_len: int):
        return transformer.prefill(self.cfg, params, tokens, max_len)

    # -- sampling (greedy; the serving engine uses this) ---------------------
    @staticmethod
    def greedy_token(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
