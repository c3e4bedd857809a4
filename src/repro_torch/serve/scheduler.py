"""The deprecated first serving surface, as a shim over :class:`ServeEngine`.

``FarmScheduler`` was the JAX package's first continuous-batching farm: a
mutable ``Request.generated``-in-place contract over a single-host decode
step.  The serving API is :mod:`repro_torch.serve.engine` (immutable
:class:`~repro_torch.serve.engine.Request` in, :class:`~repro_torch.serve
.engine.Response` out, local or clustered backends); this class keeps the
old constructor, the legacy views (``queue`` / ``slot_req`` / ``done`` /
``steps_run``) and the step handles (``_prefill`` / ``_decode`` /
``_reset``, which tests wrap) alive on top of the engine, and fills
``generated`` on whatever objects were submitted when they complete.  The
handles are the backend's ``prefill`` / ``decode`` / ``reset``: setting one
replaces what the engine calls.

A ``max_new=0`` request completes at ``submit`` with zero tokens, without
claiming a slot or a decode step.
"""

from __future__ import annotations

import warnings

from .engine import LocalDecodeBackend, Request, ServeEngine

__all__ = ["Request", "FarmScheduler"]


def _handle(name: str) -> property:
    """A step handle: the backend's bound method ``name``; assigning one
    shadows it on the backend instance."""
    def get(self):
        return getattr(self._backend, name)

    def put(self, fn) -> None:
        setattr(self._backend, name, fn)

    return property(get, put)


class FarmScheduler:
    """Slot-based continuous batching over a fixed decode batch
    (deprecated: use :class:`repro_torch.serve.ServeEngine`)."""

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 eos_id: int = -1, prefill_chunk: int = 8):
        warnings.warn(
            "FarmScheduler is deprecated; use repro_torch.serve.ServeEngine "
            "with a LocalDecodeBackend (or ClusterDecodeBackend)",
            DeprecationWarning, stacklevel=2)
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self._backend = LocalDecodeBackend(
            model, params, n_slots=n_slots, max_len=max_len,
            prefill_chunk=prefill_chunk)
        self._engine = ServeEngine(self._backend, eos_id=eos_id)
        self._by_rid: dict = {}
        self.done: list = []

    # -- legacy views over the engine's state --------------------------------
    @property
    def queue(self) -> list:
        return [self._by_rid[r.rid] for r in self._engine.pending]

    @property
    def slot_req(self) -> list:
        out = [None] * self.n_slots
        for slot, rid in self._engine.plan.active():
            out[slot] = self._by_rid[rid]
        return out

    @property
    def last_tok(self):
        return self._engine.last_tok

    @property
    def steps_run(self) -> int:
        return self._engine.steps_run

    @property
    def cache(self):
        return self._backend.cache

    @cache.setter
    def cache(self, value) -> None:
        self._backend.cache = value

    # -- the step handles ----------------------------------------------------
    _prefill = _handle("prefill")
    _decode = _handle("decode")
    _reset = _handle("reset")

    # -- host-side farm ------------------------------------------------------
    def submit(self, req) -> None:
        """Accepts the immutable :class:`Request` or any object with
        ``rid`` / ``prompt`` / ``max_new``; ``generated`` is written onto
        the submitted object when the request completes."""
        eng_req = (req if isinstance(req, Request)
                   else Request(rid=req.rid, prompt=tuple(req.prompt),
                                max_new=req.max_new))
        before = len(self._engine.completed)
        self._engine.submit(eng_req)   # empty prompt raises untouched
        self._by_rid[req.rid] = req
        object.__setattr__(req, "generated", [])
        self._sync_done(before)

    def step(self) -> int:
        """One farm step: fill free slots, decode all active ones."""
        before = len(self._engine.completed)
        n = self._engine.step()
        self._sync_done(before)
        return n

    def run(self) -> list:
        while self._engine.pending or self._engine._live:
            self.step()
        return self.done

    def _sync_done(self, before: int) -> None:
        for resp in self._engine.completed[before:]:
            legacy = self._by_rid[resp.rid]
            object.__setattr__(legacy, "generated", list(resp.tokens))
            self.done.append(legacy)
