"""Request-level continuous batching over a local or clustered decode
backend, in PyTorch.

The JAX package's serving engine:

* the **admission queue** coalesces live requests into a slot-batched
  decode step (:class:`repro_torch.core.stream.SlotPlan`): new requests
  join between decode chunks by claiming the lowest free slot, finished
  ones leave and free it — the OneFanAny any-channel at request level;
* **chunked prefill** streams prompt context through the same
  :func:`repro_torch.core.stream.microbatch_plan` schedule as the rest of
  the library (one backend call per chunk);
* the decode step runs either in this process (:class:`LocalDecodeBackend`,
  on the card unless the model's weights lie on the CPU) or as a **parked
  warm farm** on a persistent :class:`~..cluster.deploy.ClusterDeployment`
  (:class:`ClusterDecodeBackend`): each farm step is one batch whose items
  are *decode shards* — a worker's slice of the slot batch, cache
  included — flowing Emit → OneFanAny → decode workers → AnyFanOne →
  Collect.  The farm's processes are stateless and the serving state
  rides the items, so a host failure mid-step raises,
  :meth:`ClusterDeployment.recover` replays the lost chunks from the same
  input items, and the engine sees a completed, identical step: no
  request lost, none duplicated;
* **scale-out** of the decode farm is an epoch-bumped ``reconfigure`` with
  its refinement re-proof, not a restart: the admission queue keeps its
  state and in-flight requests keep their caches across the bump.

The public API is small and immutable: :class:`Request` in,
:class:`Response` out (tokens, timing, finish reason), via
``submit() -> rid`` / ``poll(rid)`` / ``run_until_drained()``.  Token
streams are identical to sequential per-request generation.  The deprecated
``FarmScheduler`` survives as a shim over this engine
(:mod:`repro_torch.serve.scheduler`).

With ``store=`` (a :class:`..cluster.durable.DeploymentStore`) the engine
persists its request table and the backend's cache (a farm's per-shard
caches) every ``persist_every`` steps, and :meth:`ServeEngine.adopt` stands
a new engine up over them after a crash: every accepted request is answered
exactly once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import trace as _trace
from ..core.dataflow import (Distribution, Kind, Network, NetworkError,
                             ProcessDef)
from ..core.processes import AnyFanOne, Collect, Emit, OneFanAny, Worker
from ..core.stream import SlotPlan, microbatch_plan
from ..device import resolve_device, to_device

__all__ = ["Request", "Response", "ServeEngine", "LocalDecodeBackend",
           "ClusterDecodeBackend", "build_decode_model", "make_decode_farm"]


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


def make_decode_farm(spec: tuple, n_slots: int, shards: int, max_len: int,
                     prefill_chunk: int, device=None) -> Network:
    """The decode farm as a process network (module-level and picklable:
    the ``pipe``/``shm`` transports rebuild it in spawned interpreters),
    its weights from :func:`build_decode_model` on ``device`` (``None``:
    the card).

    Each *item* is one decode shard — ``n_slots // shards`` rows of the
    slot batch, cache included — tagged with a mode: a decode item carries
    last tokens and the advance mask, a prefill item one prompt chunk bound
    for one row.  Workers are identical and stateless (any shard can land
    on any worker); the Collect appends items in chunk order, so the
    backend reads shard outputs back positionally.

    Each worker drains into a per-branch relay buffer (a 1-in/1-out MERGE
    process: the transport's egress FIFO declared *in* the network) before
    the AnyFanOne.  The unpartitioned farm's trace set then already holds
    every merge-arrival order a buffered deployment can show, so
    ``check_redeployment`` holds for any host count under ``reconfigure``.

    A worker decodes into a copy of its item's cache: the model writes the
    k/v buffers in place, and over the thread transports the item's
    tensors are those of the batch the controller keeps to replay a failed
    step, so the step leaves its input as it found it."""
    model, params = build_decode_model(spec, device=device)
    if shards <= 0 or n_slots % shards:
        raise NetworkError(f"make_decode_farm: n_slots={n_slots} not "
                           f"divisible into {shards} shards")
    s_rows = n_slots // shards
    dev = pytree.tree_leaves(params)[0].device

    def zero_item(i):
        """Emit is only exercised by ``run(instances=)`` probes; serving
        always supplies the item batch explicitly."""
        return _shard_item(model.init_cache(s_rows, max_len, device=dev),
                           s_rows, prefill_chunk, dev)

    def shard_step(chunk):
        # batched=True worker at microbatch 1: peel the chunk axis and take
        # ONE branch on the item's mode (the JAX farm's lax.cond)
        item = pytree.tree_map(lambda l: l[0], chunk)
        cache = pytree.tree_map(torch.clone, item["cache"])
        if int(item["mode"]) == 1:
            ps = int(item["pslot"])
            rows = torch.zeros((prefill_chunk, s_rows), dtype=torch.int32,
                               device=dev)
            adv = torch.zeros((prefill_chunk, s_rows), dtype=torch.bool,
                              device=dev)
            rows[:, ps] = item["toks"]
            adv[:, ps] = item["act"]
            for i in range(prefill_chunk):  # the JAX farm's lax.scan
                _, cache = model.decode_step(params, cache, rows[i][:, None],
                                             advance=adv[i])
            nxt = torch.zeros((s_rows,), dtype=torch.int32, device=dev)
        else:
            logits, cache = model.decode_step(
                params, cache, item["last"][:, None], advance=item["adv"])
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return pytree.tree_map(lambda l: l[None],
                               {"cache": cache, "nxt": nxt})

    net = Network("decode-farm")
    net.add(Emit(zero_item, name="emit"))
    net.add(OneFanAny(destinations=shards, name="ofa"))
    bufs = []
    for w in range(shards):
        wn = f"decode{w}"
        net.procs[wn] = Worker(shard_step, batched=True, name=wn,
                               tag="decode")
        net.connect("ofa", wn)
        bn = f"buf{w}"
        net.procs[bn] = ProcessDef(name=bn, kind=Kind.REDUCER,
                                   distribution=Distribution.MERGE)
        net.connect(wn, bn)
        bufs.append(bn)
    net.procs["afo"] = AnyFanOne(sources=shards, name="afo")
    for bn in bufs:
        net.connect(bn, "afo")
    net._tail = "afo"
    net.add(Collect(lambda acc, item: acc + [item], init=[],
                    jit_combine=False, name="collect"))
    return net


def _shard_item(cache, rows: int, pc: int, dev, *, last=None, adv=None,
                toks=None, act=None, pslot: int = 0, mode: int = 0) -> dict:
    """One farm item on ``dev``: a shard's cache, its rows' last tokens
    and advance mask (decode), a prompt chunk and the row it is bound for
    (prefill), and the mode (0 decode, 1 prefill)."""
    def vec(x, n, dtype):
        if x is None:
            return torch.zeros((n,), dtype=dtype, device=dev)
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    return {"cache": cache,
            "last": vec(last, rows, torch.int32),
            "adv": vec(adv, rows, torch.bool),
            "toks": vec(toks, pc, torch.int32),
            "act": vec(act, pc, torch.bool),
            "pslot": torch.tensor(pslot, dtype=torch.int32, device=dev),
            "mode": torch.tensor(mode, dtype=torch.int32, device=dev)}


class ClusterDecodeBackend:
    """The decode farm parked warm on a :class:`ClusterDeployment`.

    Holds the canonical serving state (per-shard caches) on ``device``
    (``None``: the card) and streams it through the farm each step: a
    decode step is one batch of ``shards`` items, a prefill chunk a
    one-item batch bound for the owning shard.  Over ``device`` the caches
    never leave the card; over ``pipe``/``shm`` they cross as raw bytes
    with their dtype (bf16 included).  A
    :class:`~..cluster.runtime.ClusterError` mid-step triggers
    ``recover()``: the replayed batch returns the completed, identical
    step result, so engine bookkeeping only ever advances on full steps
    (exactly-once responses under host kills).  ``scale()`` re-fits the
    same farm to a new host count through the controller's epoch-bumped
    ``reconfigure``; ``autoscale=`` (an
    :class:`~..cluster.autoscale.AutoscalePolicy`, or ``True`` for the
    defaults) does the same by itself: :class:`ServeEngine` calls
    :meth:`maybe_autoscale` after every decode step."""

    def __init__(self, spec: tuple, *, n_slots: int, shards: int = 2,
                 hosts: int = 2, transport="inprocess", max_len: int = 64,
                 prefill_chunk: int = 8, timeout_s: float = 60.0,
                 max_recover_attempts: int = 4, recover_mode: str = "restart",
                 trace: bool = False, snapshot_every: int = 0,
                 snapshot_dir: Optional[str] = None, autoscale=None,
                 device=None):
        from ..cluster.deploy import ClusterDeployment
        if shards <= 0 or n_slots % shards:
            raise NetworkError(f"ClusterDecodeBackend: n_slots={n_slots} "
                               f"not divisible into {shards} shards")
        self.spec = spec
        self.n_slots = n_slots
        self.shards = shards
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.recover_mode = recover_mode
        self.max_recover_attempts = max_recover_attempts
        self.recoveries = 0
        self._rows = n_slots // shards
        self.device = resolve_device(device)
        dev_arg = None if device is None else str(device)
        self.model, self.params = build_decode_model(spec, device=dev_arg)
        # canonical state: one cache tree per shard, on the backend's
        # device (it rides the items through the transport each step)
        self.shard_cache = [
            self.model.init_cache(self._rows, max_len, device=self.device)
            for _ in range(shards)]
        factory = (make_decode_farm,
                   (spec, n_slots, shards, max_len, prefill_chunk, dev_arg))
        self.dep = ClusterDeployment(
            factory[0](*factory[1]), hosts=hosts, transport=transport,
            microbatch_size=1, factory=factory, timeout_s=timeout_s,
            trace=trace, snapshot_every=snapshot_every,
            snapshot_dir=snapshot_dir, device=dev_arg)
        self.dep.start()
        # the backend owns its Autoscaler (rather than handing autoscale=
        # to the deployment) so polling is per decode STEP, under the
        # engine's control — not per internal batch, where one-item
        # prefill chunks would pollute the policy's rate signals
        self.autoscaler = None
        if autoscale is not None and autoscale is not False:
            from ..cluster.autoscale import Autoscaler, AutoscalePolicy
            pol = AutoscalePolicy() if autoscale is True else autoscale
            self.autoscaler = Autoscaler(self.dep.controller, pol)

    @property
    def store(self):
        """The deployment's :class:`~..cluster.durable.DeploymentStore`
        (None without ``snapshot_dir``): hand it to :class:`ServeEngine`
        as ``store=`` so the request table persists next to the farm's
        durable state."""
        return self.dep.controller.store

    # -- farm plumbing ------------------------------------------------------
    def _run(self, batch) -> list:
        """One batch through the warm farm, recovering as many times as
        host failures demand; returns the per-item outputs in item order."""
        from ..cluster.runtime import ClusterError
        try:
            return self.dep.run(batch=batch)["collect"]
        except ClusterError:
            pass
        for _ in range(self.max_recover_attempts):
            self.recoveries += 1
            try:
                out = self.dep.recover(mode=self.recover_mode)
            except ClusterError:
                continue  # the replay was killed too — recover again
            if out is not None:
                return out["collect"]
            try:  # recovery had no pending batch: re-run this one
                return self.dep.run(batch=batch)["collect"]
            except ClusterError:
                continue
        raise NetworkError(
            f"ClusterDecodeBackend: step did not complete within "
            f"{self.max_recover_attempts} recoveries")

    def _item(self, w: int, **kw) -> dict:
        return _shard_item(self.shard_cache[w], self._rows,
                           self.prefill_chunk, self.device, **kw)

    @staticmethod
    def _stack(items: list):
        return pytree.tree_map(lambda *ls: torch.stack(ls), *items)

    # -- the DecodeBackend surface ------------------------------------------
    def reset(self, slot: int) -> None:
        # in place: a canonical cache is a step's output, never part of a
        # batch the controller keeps for a replay
        w, ps = divmod(slot, self._rows)
        self.shard_cache[w] = self.model.reset_slot(self.shard_cache[w], ps)

    def prefill(self, slot: int, toks: np.ndarray, act: np.ndarray) -> None:
        w, ps = divmod(slot, self._rows)
        batch = self._stack([self._item(w, toks=toks, act=act, pslot=ps,
                                        mode=1)])
        (out,) = self._run(batch)
        # a process host's output comes back on the CPU
        self.shard_cache[w] = to_device(out["cache"], self.device)

    def decode(self, last: np.ndarray, adv) -> np.ndarray:
        rows = self._rows
        last = np.asarray(last, np.int32)
        adv = np.asarray(adv, bool)
        batch = self._stack([
            self._item(w, last=last[w * rows:(w + 1) * rows],
                       adv=adv[w * rows:(w + 1) * rows])
            for w in range(self.shards)])
        outs = self._run(batch)
        for w, out in enumerate(outs):
            self.shard_cache[w] = to_device(out["cache"], self.device)
        return np.concatenate([out["nxt"].cpu().numpy() for out in outs])

    # -- elasticity ---------------------------------------------------------
    def scale(self, hosts: int):
        """Re-fit the live farm to ``hosts``: drain, replan, epoch bump,
        refinement re-proof; serving state (caches, admission queue) is
        untouched.  Returns the :class:`RecoveryEvent`."""
        return self.dep.reconfigure(hosts=hosts)

    def maybe_autoscale(self):
        """One :class:`~..cluster.autoscale.AutoscalePolicy` poll against
        the live farm: the hook :meth:`ServeEngine.step` calls after every
        decode step.  No-op without ``autoscale=``; returns the
        :class:`AutoscaleEvent` when the policy decided anything."""
        if self.autoscaler is None:
            return None
        return self.autoscaler.poll()

    @property
    def autoscale_events(self) -> list:
        """Every autoscale decision so far (executed and vetoed)."""
        return [] if self.autoscaler is None else self.autoscaler.events

    def close(self) -> None:
        self.dep.close()


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
                 store=None, persist_every: int = 1):
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
        # durability: a DeploymentStore persists the full request table
        # (admission queue, in-flight slots, answered responses) plus the
        # backend's cache at step boundaries, so a brand-new engine can
        # adopt() the serving state and answer exactly once
        self.store = store
        self.persist_every = persist_every
        self._persist_seq = 0

    @classmethod
    def adopt(cls, backend, store, *, time_fn=time.monotonic,
              recorder: Optional[_trace.TraceRecorder] = None,
              persist_every: int = 1) -> "ServeEngine":
        """Stand a brand-new engine up over a dead one's persisted serving
        state: the request table resumes exactly where the last persisted
        step left it — answered responses stay answered (never recomputed,
        never re-delivered), in-flight requests resume mid-decode on the
        restored cache, which goes back onto the backend's device, and
        queued ones are admitted as slots free up.  The decode being
        deterministic, the adopted engine's token streams equal an
        uncrashed run's: every accepted request is answered exactly
        once."""
        state = store.load_serve()
        if state is None:
            raise NetworkError(
                "ServeEngine.adopt: no persisted serving state in "
                f"{store.root!r}")
        eng = cls(backend, eos_id=state["eos_id"], time_fn=time_fn,
                  recorder=recorder, store=store,
                  persist_every=persist_every)
        eng.rec.instant("adopt", "durable", steps=state["steps_run"])
        eng.plan = state["plan"]
        eng.pending = list(state["pending"])
        eng.responses = dict(state["responses"])
        eng.completed = list(state["completed"])
        eng.steps_run = state["steps_run"]
        eng.last_tok = np.asarray(state["last_tok"]).copy()
        eng._live = dict(state["live"])
        eng._known = set(state["known"])
        eng._submit_times = dict(state["submit_times"])
        eng._persist_seq = store.serve_step() or 0
        if state.get("shard_cache") is not None:
            backend.shard_cache = [to_device(c, backend.device)
                                   for c in state["shard_cache"]]
        elif state.get("cache") is not None:
            backend.cache = to_device(state["cache"], backend.device)
        return eng

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
        # elasticity: the backend's autoscale policy (if any) polls the
        # farm's metrics once per decode step — a scale decision lands as
        # an epoch bump between steps, invisible to slot bookkeeping
        maybe = getattr(self.backend, "maybe_autoscale", None)
        if maybe is not None:
            maybe()
        if (self.store is not None and self.persist_every
                and self.steps_run % self.persist_every == 0):
            self._persist()
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
    def _state(self) -> dict:
        """The engine's full serving state as one picklable dict — the
        request table plus the backend's cache (a farm's per-shard caches),
        every tensor copied to the CPU, captured at a step boundary so the
        pair is mutually consistent."""
        import copy as _copy

        from ..cluster.durable import to_host
        be = self.backend
        shards = getattr(be, "shard_cache", None)
        cache = None if shards is not None else getattr(be, "cache", None)
        return {
            "eos_id": self.eos_id,
            "plan": _copy.deepcopy(self.plan),
            "pending": list(self.pending),
            "responses": dict(self.responses),
            "completed": list(self.completed),
            "steps_run": self.steps_run,
            "last_tok": np.asarray(self.last_tok).copy(),
            "live": _copy.deepcopy(self._live),
            "known": set(self._known),
            "submit_times": dict(self._submit_times),
            "shard_cache": (None if shards is None
                            else [to_host(c) for c in shards]),
            "cache": None if cache is None else to_host(cache),
        }

    def _persist(self) -> None:
        self._persist_seq += 1
        with self.rec.span("persist", "durable", step=self.steps_run,
                           seq=self._persist_seq) as sp:
            sp.set(nbytes=self.store.save_serve(self._persist_seq,
                                                self._state()))

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
