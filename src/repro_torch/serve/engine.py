"""Request-level continuous batching on one host, in PyTorch.

The JAX package's serving engine for its single-host backend:

* the **admission queue** coalesces live requests into a slot-batched
  decode step (:class:`repro_torch.core.stream.SlotPlan`): new requests
  join between decode chunks by claiming the lowest free slot, finished
  ones leave and free it — the OneFanAny any-channel at request level;
* **chunked prefill** streams prompt context through the same
  :func:`repro_torch.core.stream.microbatch_plan` schedule as the rest of
  the library (one backend call per chunk);
* the decode step runs in this process (:class:`LocalDecodeBackend`), on the
  card unless the model's weights lie on the CPU.

The public API is small and immutable: :class:`Request` in,
:class:`Response` out (tokens, timing, finish reason), via
``submit() -> rid`` / ``poll(rid)`` / ``run_until_drained()``.  Token
streams are identical to sequential per-request generation.

The clustered decode farm (``ClusterDecodeBackend``, ``make_decode_farm``)
and durable serving state (``store=``, ``adopt``) come with the cluster and
durable slices; here they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import trace as _trace
from ..core.dataflow import NetworkError
from ..core.stream import SlotPlan, microbatch_plan

__all__ = ["Request", "Response", "ServeEngine", "LocalDecodeBackend",
           "ClusterDecodeBackend", "build_decode_model", "make_decode_farm"]

_CLUSTER_SLICE = ("the clustered decode farm comes with the port's cluster "
                  "runtime slice")
_DURABLE_SLICE = ("durable serving state comes with the port's cluster and "
                  "durable slices")


# ==========================================================================
# The immutable request/response surface
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  Immutable: results arrive as a
    :class:`Response`."""

    rid: int
    prompt: tuple
    max_new: int = 16

    def __post_init__(self):
        object.__setattr__(self, "prompt", tuple(self.prompt))


@dataclasses.dataclass(frozen=True)
class Response:
    """The completed request: generated tokens, timing, finish reason.

    ``finish_reason`` is ``"length"`` (``max_new`` reached, including the
    degenerate ``max_new=0``) or ``"eos"``.  Timestamps come from the
    engine's clock (``time_fn``): ``first_token_at`` is None only when no
    token was generated."""

    rid: int
    prompt: tuple
    tokens: tuple
    finish_reason: str
    submitted_at: float
    first_token_at: Optional[float]
    finished_at: float
    steps: int            # engine decode steps this request was active for
    # the request's audited admission-queue transitions, straight from
    # :class:`SlotPlan.events`: exactly one join and one leave for any
    # request that decoded (empty for ``max_new=0``)
    slot_events: tuple = ()

    @property
    def ttft(self) -> float:
        """Time to first token (queue wait + prefill + first decode)."""
        at = (self.first_token_at if self.first_token_at is not None
              else self.finished_at)
        return at - self.submitted_at

    @property
    def latency(self) -> float:
        return self.finished_at - self.submitted_at

    @property
    def tpot(self) -> float:
        """Mean per-token latency after the first token."""
        if self.first_token_at is None or len(self.tokens) <= 1:
            return 0.0
        return ((self.finished_at - self.first_token_at)
                / (len(self.tokens) - 1))


@dataclasses.dataclass
class _Live:
    """Engine-internal mutable state of an admitted request."""

    req: Request
    submitted_at: float
    tokens: list
    left: int
    steps: int = 0
    first_token_at: Optional[float] = None


# ==========================================================================
# Decode backends: where the slot-batched step runs
# ==========================================================================

class LocalDecodeBackend:
    """The single-host decode farm: one slot-batched step over every row in
    this process, on the device that holds the weights.  The cache's k/v
    buffers are updated in place step by step (the JAX backend donates
    them)."""

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 prefill_chunk: int = 8):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.device = pytree.tree_leaves(params)[0].device
        self.cache = model.init_cache(n_slots, max_len, device=self.device)

    def reset(self, slot: int) -> None:
        self.cache = self.model.reset_slot(self.cache, slot)

    def prefill(self, slot: int, toks: np.ndarray, act: np.ndarray) -> None:
        """Feed a fixed-size chunk of prompt tokens into ``slot``'s cache,
        one decode step per token with the other rows frozen.  ``act``
        masks the padding of the last chunk: a padded step writes at the
        slot's index without moving it, as in the JAX backend's scan (a
        Python loop here)."""
        rows = np.zeros((len(toks), self.n_slots), np.int32)
        adv = np.zeros((len(toks), self.n_slots), bool)
        rows[:, slot] = toks
        adv[:, slot] = act
        rows_t = torch.from_numpy(rows).to(self.device)
        adv_t = torch.from_numpy(adv).to(self.device)
        for i in range(len(toks)):
            _, self.cache = self.model.decode_step(
                self.params, self.cache, rows_t[i][:, None],
                advance=adv_t[i])

    def decode(self, last: np.ndarray, adv) -> np.ndarray:
        """One greedy step of every row: the next token of each (rows with
        ``adv`` False are computed and ignored, their cache frozen)."""
        tokens = torch.as_tensor(np.asarray(last, np.int32),
                                 device=self.device)[:, None]
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, tokens,
            advance=torch.as_tensor(adv, dtype=torch.bool,
                                    device=self.device))
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt.cpu().numpy()

    def close(self) -> None:
        pass


class ClusterDecodeBackend:
    """Placeholder for the decode farm on a cluster deployment."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_CLUSTER_SLICE)


def make_decode_farm(*args, **kwargs):
    """Placeholder for the decode farm as a process network."""
    raise NotImplementedError(_CLUSTER_SLICE)


def build_decode_model(spec: tuple, device=None):
    """``(model, params)`` from a spec: ``("toy", vocab, dim)`` builds
    :class:`ToyLM`; ``("model", arch, reduced)`` builds the
    :class:`repro_torch.models.Model` facade.  Weights come from seed 0 on
    ``device`` (``None`` means the card)."""
    kind = spec[0]
    if kind == "toy":
        from .toy import ToyLM
        model = ToyLM(int(spec[1]), int(spec[2]))
    elif kind == "model":
        from ..configs import get_config
        from ..models import Model
        model = Model(get_config(spec[1], reduced=bool(spec[2])))
    else:
        raise NetworkError(f"build_decode_model: unknown spec kind "
                           f"{kind!r} (want 'toy' or 'model')")
    return model, model.init(seed=0, device=device)


# ==========================================================================
# The engine
# ==========================================================================

class ServeEngine:
    """Request-level continuous batching over a decode backend.

    ::

        eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=4,
                                             max_len=64))
        rid = eng.submit(Request(rid=0, prompt=(5, 7, 11), max_new=8))
        for resp in eng.run_until_drained():
            print(resp.rid, resp.tokens, f"{resp.ttft * 1e3:.1f}ms")

    ``submit`` is non-blocking (the admission queue holds what the slot
    batch cannot seat yet); ``step()`` admits between decode chunks and
    runs one batched decode; ``poll(rid)`` returns the :class:`Response`
    once finished."""

    def __init__(self, backend, *, eos_id: int = -1,
                 time_fn=time.monotonic,
                 recorder: Optional[_trace.TraceRecorder] = None,
                 store=None):
        if store is not None:
            raise NotImplementedError(_DURABLE_SLICE)
        self.backend = backend
        self.eos_id = eos_id
        self.time_fn = time_fn
        self.rec = recorder if recorder is not None else _trace.current()
        self.n_slots = backend.n_slots
        self.plan = SlotPlan(backend.n_slots)
        self.pending: list[Request] = []
        self.responses: dict[int, Response] = {}
        self.completed: list[Response] = []   # completion order
        self.steps_run = 0
        self.last_tok = np.zeros(backend.n_slots, np.int32)
        self._live: dict[int, _Live] = {}     # rid -> admitted state
        self._known: set = set()
        self._submit_times: dict[int, float] = {}

    @classmethod
    def adopt(cls, backend, store, **kwargs) -> "ServeEngine":
        """Placeholder for standing an engine up over persisted state."""
        raise NotImplementedError(_DURABLE_SLICE)

    # -- the public surface --------------------------------------------------
    def submit(self, req: Request) -> int:
        """Enqueue ``req``; returns its rid (the poll handle).  Rejects
        empty prompts and duplicate rids before any slot state is touched;
        a ``max_new=0`` request completes immediately (zero tokens, reason
        ``"length"``) without ever claiming a slot."""
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.rid in self._known:
            raise ValueError(f"request {req.rid}: duplicate rid")
        self._known.add(req.rid)
        now = self.time_fn()
        self.rec.instant("submit", "serve", rid=req.rid,
                         prompt_len=len(req.prompt), max_new=req.max_new)
        if req.max_new <= 0:
            self._finish(Response(
                rid=req.rid, prompt=req.prompt, tokens=(),
                finish_reason="length", submitted_at=now,
                first_token_at=None, finished_at=now, steps=0))
            return req.rid
        self.pending.append(req)
        self._submit_times[req.rid] = now
        return req.rid

    def poll(self, rid: int) -> Optional[Response]:
        """The response for ``rid``, or None while it is still queued or
        decoding.  Unknown rids raise KeyError."""
        if rid not in self._known:
            raise KeyError(f"unknown request {rid}")
        return self.responses.get(rid)

    def step(self) -> int:
        """One farm step: admit from the queue into free slots (join
        between decode chunks), then decode every active slot once.
        Returns the number of active slots (0 = drained)."""
        self._fill_slots()
        active = self.plan.active()
        if not active:
            return 0
        with self.rec.span("decode_chunk", "serve", step=self.steps_run,
                           active=len(active)):
            nxt = self.backend.decode(self.last_tok, self.plan.mask())
        now = self.time_fn()
        self.steps_run += 1
        self.plan.tick()
        for slot, rid in active:
            live = self._live[rid]
            tok = int(nxt[slot])
            live.tokens.append(tok)
            live.steps += 1
            if live.first_token_at is None:
                live.first_token_at = now
                self.rec.instant("first_token", "serve", rid=rid, slot=slot)
            self.last_tok[slot] = tok
            live.left -= 1
            if live.left <= 0 or tok == self.eos_id:
                self.plan.release(slot)
                del self._live[rid]
                self._finish(Response(
                    rid=rid, prompt=live.req.prompt,
                    tokens=tuple(live.tokens),
                    finish_reason=("eos" if tok == self.eos_id
                                   else "length"),
                    submitted_at=live.submitted_at,
                    first_token_at=live.first_token_at,
                    finished_at=now, steps=live.steps,
                    slot_events=tuple(e for e in self.plan.events
                                      if e.rid == rid)))
        return len(active)

    def run_until_drained(self) -> list[Response]:
        """Step until the queue and every slot are empty; returns ALL
        responses so far in completion order."""
        while self.pending or self._live:
            self.step()
        return list(self.completed)

    def close(self) -> None:
        self.backend.close()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def slot_events(self) -> list:
        """The full audited admission trace (`SlotEvent` per join/leave),
        across every request, in transition order."""
        return list(self.plan.events)

    # -- internals -----------------------------------------------------------
    def _finish(self, resp: Response) -> None:
        self.responses[resp.rid] = resp
        self.completed.append(resp)
        self.rec.instant("done", "serve", rid=resp.rid,
                         reason=resp.finish_reason,
                         tokens=len(resp.tokens))

    def _fill_slots(self) -> None:
        """Admission: seat queued requests into free slots (lowest slot,
        FIFO queue — the deterministic any-channel), reset the slot's
        cache and stream the prompt context through chunked prefill."""
        while self.pending and self.plan.n_free:
            req = self.pending.pop(0)
            slot = self.plan.claim(req.rid)
            self.rec.instant("admit", "serve", rid=req.rid, slot=slot,
                             step=self.plan.step)
            self.backend.reset(slot)
            # chunked prefill: all but the last prompt token flow through
            # the microbatch plan; a single-token prompt has no context —
            # the plan is empty and no prefill runs at all
            ctx = req.prompt[:-1]
            pc = self.backend.prefill_chunk
            for lo, hi in microbatch_plan(len(ctx), pc):
                toks = np.zeros(pc, np.int32)
                act = np.zeros(pc, bool)
                toks[:hi - lo] = ctx[lo:hi]
                act[:hi - lo] = True
                with self.rec.span("prefill", "serve", rid=req.rid,
                                   slot=slot, lo=lo, hi=hi):
                    self.backend.prefill(slot, toks, act)
            self.last_tok[slot] = req.prompt[-1]
            self._live[req.rid] = _Live(
                req=req,
                submitted_at=self._submit_times.pop(req.rid),
                tokens=[], left=req.max_new)
