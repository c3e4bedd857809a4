"""Pluggable channel transports: how a cut channel moves chunks between hosts.

A :class:`ChannelTransport` realises the cut channels of a
:class:`.partition.PartitionPlan` as bounded FIFO pipes.  The bound is the
channel's CSP ``capacity`` (``ChannelDef.capacity``; rendezvous channels get
``DEFAULT_CAPACITY``), and ``send`` *blocks* when the pipe is full — the
streaming executor's backpressure extended across the host boundary: a slow
consumer host throttles its producer host through the transport itself,
exactly as a buffered CSP channel chain would.

Four implementations:

* :class:`InProcess` — ``queue.Queue``-backed loopback; hosts are threads in
  this interpreter.  Always available; the reference semantics.
* :class:`MultiProcessPipe` — ``multiprocessing`` queues between *real OS
  processes* (spawn start method: each host is a fresh interpreter with its
  own CUDA context), so the tests exercise genuine host boundaries.  Values
  cross as raw bytes with a dtype tag (:func:`pack_raw`) and are rebuilt on
  the consumer host's device.
* :class:`SharedMemoryRing` — spawned process hosts again, but a chunk's
  tensors cross through preallocated ``/dev/shm`` slots: one copy from the
  producer's tensor (on the card or not) into a slot, one copy out onto the
  consumer's device, and only a small header through the queue.
* :class:`DeviceTransport` — thread hosts whose tensors stay on the card:
  host *h* runs on ``cuda:(h % device_count)``, and a send places the chunk
  on the consumer host's device (a no-op when producer and consumer share
  a card).

All transports carry a per-chunk SKIP marker so upstream COMBINE reducers
(which emit nothing until their final chunk) stay chunk-aligned across the
cut, and an EOS marker as a defensive stream terminator.

Every record on the wire is stamped ``(epoch, ci, payload)``.  The
deployment epoch is what a recovery bumps
(:meth:`.control.ClusterController.recover`), so a consumer discards
records left over from an older stream (stale epoch) and
replayed duplicates (``ci`` below the chunk it needs) instead of tripping
the out-of-order check.  :meth:`ChannelTransport.drain` empties the FIFOs —
the controller drains a failed host's ingress so its producers unblock.

Coalescing fast path (``coalesce_bytes > 0``): small records buffer per
channel until a byte budget fills, then ship as ONE queue put
(:class:`_Coalesced` on the wire).  The receiver explodes a batch into a
read-ahead buffer and feeds each sub-record through the same
epoch/duplicate/order protocol as a plain record.  EOS flushes before it
ships, an epoch bump flushes under the OLD epoch, the executor flushes at
the end of a stream and on failure, and :meth:`ChannelTransport.drain`
sweeps any still-unflushed local buffers after the FIFO contents.

Thread transports (:class:`InProcess` / :class:`DeviceTransport`) hand each
host its own :class:`_ThreadEndpoint`: the FIFOs and the epoch are live
views of the parent's, but the coalescing state — unflushed send buffers
and the exploded-batch read-ahead — is per host, so concurrent host threads
never race one another's buffers.
"""

from __future__ import annotations

import queue
import threading
import time as _time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.dataflow import NetworkError

__all__ = [
    "DEFAULT_CAPACITY",
    "SKIP",
    "EOS",
    "TransportError",
    "ChannelTransport",
    "InProcess",
    "MultiProcessPipe",
    "SharedMemoryRing",
    "DeviceTransport",
    "make_transport",
    "pack_raw",
    "unpack_raw",
]

DEFAULT_CAPACITY = 2  # rendezvous channels buffer like the stream executor
SKIP = "__gpp_skip__"  # chunk produced nothing (COMBINE still accumulating)
EOS = "__gpp_eos__"    # defensive end-of-stream marker

_RECV_TIMEOUT_S = 120.0  # a hung peer surfaces as a TransportError, not a hang
_DRAIN_POLL_S = 0.02  # drain declares a FIFO empty after 2 misses of this
_BRICK_PROBE_S = 0.25  # reader-lock probe: held longer than this = corpse


class TransportError(NetworkError):
    """A cut channel failed (peer died, timeout, protocol violation)."""


class _RawLeaf:
    """Header + buffer encoding of one contiguous tensor or numpy leaf.

    Not a registered pytree node, so ``tree_map`` treats it as a leaf.  A
    tensor keeps its torch dtype by name (``"bfloat16"``), a numpy array
    its exact ``dtype.str`` (which carries byte order — ``'<f4'`` vs
    ``'>f4'``); the full shape (``()`` for 0-d leaves) survives the round
    trip, which plain bytes alone would lose.
    """

    __slots__ = ("torch", "dtype", "shape", "buf")

    def __init__(self, is_torch: bool, dtype: str, shape: tuple, buf: bytes):
        self.torch = is_torch
        self.dtype = dtype
        self.shape = shape
        self.buf = buf

    # __slots__ classes need explicit pickle support
    def __getstate__(self):
        return (self.torch, self.dtype, self.shape, self.buf)

    def __setstate__(self, state):
        self.torch, self.dtype, self.shape, self.buf = state


def _rawable(a: np.ndarray) -> bool:
    """Plain (non-object, non-structured) dtypes round-trip through raw
    bytes; anything exotic falls back to pickling the array itself."""
    return not a.dtype.hasobject and a.dtype.names is None


def _as_contig(leaf) -> np.ndarray:
    """C-contiguous numpy view of ``leaf`` — preserving 0-d shape, which
    ``np.ascontiguousarray`` alone would silently promote to ``(1,)``."""
    a = np.asarray(leaf)
    if a.ndim and not a.flags["C_CONTIGUOUS"]:
        a = np.ascontiguousarray(a)
    return a


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a CPU tensor in C order (any dtype: read through a
    uint8 view of a contiguous copy, so bf16 needs no numpy type)."""
    t = t.detach().contiguous()
    if t.numel() == 0:
        return b""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def pack_raw(value):
    """Host pytree -> pytree of :class:`_RawLeaf` headers (markers pass
    through).  What :meth:`MultiProcessPipe._pack` ships: a CPU tensor or
    a contiguous numpy leaf crosses as (dtype, shape, buffer) instead of a
    pickled object (pickling a tensor through a ``multiprocessing`` queue
    would move its storage into shared memory instead).  Tensors on a
    device are copied to the CPU first, keeping their dtype — bfloat16
    included, which numpy has no type for."""
    if isinstance(value, str):
        return value

    def _one(leaf):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            return _RawLeaf(True, str(t.dtype).removeprefix("torch."),
                            tuple(t.shape), _tensor_bytes(t))
        if not isinstance(leaf, (np.ndarray, np.generic)):
            return leaf  # Python scalars, strings, ... pickle as they are
        a = _as_contig(leaf)
        if not _rawable(a):
            return a  # pickle fallback (object/structured dtypes)
        return _RawLeaf(False, a.dtype.str, a.shape, a.tobytes())

    return pytree.tree_map(_one, value)


def unpack_raw(value, device=None):
    """Inverse of :func:`pack_raw`: rebuild each leaf with its recorded
    dtype (byte order included) and shape — 0-d leaves come back 0-d.
    Tensors are rebuilt on ``device`` (the consumer host's; ``None``: the
    CPU)."""
    if isinstance(value, str):
        return value

    def _one(leaf):
        if not isinstance(leaf, _RawLeaf):
            return leaf
        if leaf.torch:
            dtype = getattr(torch, leaf.dtype)
            if not leaf.buf:
                t = torch.empty(leaf.shape, dtype=dtype)
            else:
                # bytearray: one copy, but WRITABLE (frombuffer over the
                # bytes object would hand consumers a read-only buffer)
                t = torch.frombuffer(bytearray(leaf.buf), dtype=torch.uint8
                                     ).view(dtype).reshape(leaf.shape)
            return t if device is None else t.to(device)
        return np.frombuffer(bytearray(leaf.buf),
                             dtype=np.dtype(leaf.dtype)).reshape(leaf.shape)

    return pytree.tree_map(_one, value)


class _Coalesced:
    """Wire wrapper for records coalesced into one queue put.

    ``records`` is ``[(ci, packed_payload), ...]`` in send order; the whole
    batch carries ONE epoch stamp (records never straddle an epoch bump —
    the bump flushes first).  Not a pytree; queue transports pickle it as a
    unit.
    """

    __slots__ = ("records",)

    def __init__(self, records: list):
        self.records = records

    def __getstate__(self):
        return self.records

    def __setstate__(self, state):
        self.records = state


def _payload_nbytes(value) -> int:
    """Approximate wire size of one record for coalesce-budget accounting:
    raw buffers and array leaves by byte length, markers/exotica by a small
    constant (the budget is a batching heuristic, not an exact quota)."""
    if isinstance(value, str):
        return 64
    total = 0
    for leaf in pytree.tree_leaves(value):
        if isinstance(leaf, _RawLeaf):
            total += len(leaf.buf)
        else:
            total += int(getattr(leaf, "nbytes", 64))
    return total


class ChannelTransport:
    """One bounded FIFO per cut channel; chunk-granular send/recv.

    ``chan`` keys are ``(src, dst)`` process-name pairs from the plan's cut
    list.  ``send`` blocks on a full pipe (backpressure); ``recv`` blocks on
    an empty one and raises :class:`TransportError` after a timeout.

    Every record is stamped with the deployment ``epoch`` (see the module
    docstring): ``recv`` discards stale-epoch records and replayed
    duplicates, so post-recovery streams compose with pre-recovery leftovers
    without protocol violations.
    """

    name = "abstract"
    process_hosts = False  # True: hosts are spawned OS processes
    _epoch = 1  # backing store of the epoch property (controller-bumped)
    # how long a blocked send/recv waits before declaring the peer hung —
    # a class attribute so the fault-injection simulator (and tests) can
    # shrink it without patching the module constant
    recv_timeout_s = _RECV_TIMEOUT_S
    # coalescing fast path: > 0 buffers small records per channel until this
    # many bytes are pending, then ships them as ONE queue put / ring slot.
    # 0 (the default) keeps the legacy one-record-per-put wire format.
    coalesce_bytes = 0

    @property
    def epoch(self) -> int:
        """Deployment epoch records are stamped with."""
        return self._epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        # an epoch bump is a flush barrier: records buffered before it
        # belong to the abandoned stream and must arrive STALE (never
        # renumbered) — best effort, since a full FIFO of a doomed epoch is
        # not worth blocking recovery over (the replay re-sends drops)
        if value != self._epoch and getattr(self, "_send_pending", None):
            self.flush_sends(best_effort=True)
        self._epoch = value

    # -- coalescing buffers (lazy: endpoints that skip __init__ still work) --
    # Thread transports set a real threading.Lock here: their buffers can be
    # touched by a host thread (send / flush) and the controller thread
    # (epoch-bump flush, drain sweep) at once.  Per-process endpoints own
    # their buffers outright and stay lock-free.
    _coalesce_lock = None

    def _buf_lock(self):
        lk = self._coalesce_lock
        return lk if lk is not None else nullcontext()

    def _pending_map(self) -> dict:
        """``chan -> [records, nbytes]`` unflushed coalesce buffers.  Only
        mutate under :meth:`_buf_lock`: an unguarded flush-pop can race a
        concurrent append, landing a record in an already-detached buffer
        that never flushes."""
        p = getattr(self, "_send_pending", None)
        if p is None:
            p = self._send_pending = {}
        return p

    def _exploded_map(self) -> dict:
        """``chan -> [(ci, payload), ...]`` read-ahead buffer of an exploded
        coalesced batch (records pulled off the FIFO, not yet delivered)."""
        p = getattr(self, "_recv_exploded", None)
        if p is None:
            p = self._recv_exploded = {}
        return p

    def _take_pending(self, chan):
        """Atomically detach ``chan``'s coalesce buffer (None when empty)."""
        if not getattr(self, "_send_pending", None):
            return None
        with self._buf_lock():
            return self._send_pending.pop(chan, None)

    def _sweep_pending(self, chan) -> list:
        """Pop ``chan``'s unflushed coalesce records in send order — ours
        and every registered per-host endpoint's (thread transports): those
        producers believe the records were sent."""
        out = []
        for owner in (self, *getattr(self, "_endpoints", {}).values()):
            buf = owner._take_pending(chan)
            if buf:
                out.extend(buf[0])
        return out

    def flush_sends(self, chan=None, *, best_effort: bool = False) -> None:
        """Ship whatever the coalescing fast path still buffers — one
        batched record per channel (``chan`` limits it; None = all).  No-op
        with nothing pending.  ``best_effort`` drops what a full FIFO cannot
        take quickly instead of raising (stale-epoch flushes: the replay
        machinery re-sends anything dropped).  Buffers detach under the
        lock and ship outside it — a blocking put must not hold other
        threads' sends hostage."""
        pend = getattr(self, "_send_pending", None)
        if not pend:
            return
        with self._buf_lock():
            chans = [chan] if chan is not None else list(pend)
            bufs = [(c, pend.pop(c)) for c in chans if c in pend]
        for c, buf in bufs:
            if buf and buf[0]:
                self._flush_one(c, buf, best_effort=best_effort)

    def _flush_one(self, chan, buf, *, best_effort: bool = False) -> None:
        raise NotImplementedError

    def _send_transform(self, chan, value) -> object:
        """Pre-send payload hook (DeviceTransport's consumer placement);
        per-host thread endpoints delegate to their parent's."""
        return value

    def clear_read_buffers(self) -> None:
        """Drop THIS endpoint's read-ahead state from a previous stream.
        An executor calls this when it RESETS its run state (fresh batch /
        replay from scratch); a stall-resume keeps the buffers — they hold
        exactly the records already pulled off the FIFO but not yet folded.
        Endpoints are per host on every transport, so the reset is host
        local: it can never destroy a stall-resuming peer's read-ahead."""
        m = getattr(self, "_recv_exploded", None)
        if m:
            m.clear()

    def setup(self, cut_channels, capacities: dict) -> None:
        raise NotImplementedError

    def reconfigure(self, cut_channels, capacities: dict) -> None:
        """Re-point the transport at a new cut (rebalance): keep the FIFO of
        every channel still in the cut, create the missing ones, release the
        removed ones.  Default: a full re-setup."""
        self.setup(cut_channels, capacities)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def endpoint(self, host: int):
        """The (possibly serialisable) handle a host runner uses."""
        return self

    def send(self, chan, ci: int, value) -> None:
        raise NotImplementedError

    def recv(self, chan, ci: int):
        raise NotImplementedError

    def drain(self, channels=None, *, keep=frozenset()) -> dict:
        """Empty channel FIFOs (a recovery step).  ``channels`` limits the
        sweep (None = all).  For channels in ``keep`` the undelivered *data*
        records are decoded and returned in FIFO order so the controller can
        :meth:`requeue` them under the new epoch; everything else — EOS
        markers, records of dead peers, stale streams — is discarded.
        Returns ``{chan: (records, n_discarded)}`` with ``records = [(ci,
        value), ...]``."""
        return {}

    def requeue(self, chan, records) -> int:
        """Re-send drained records on ``chan`` at the CURRENT epoch, oldest
        first, at most one FIFO's worth (never blocks on a full pipe: the
        producer replays whatever does not fit).  Returns the number
        requeued — a contiguous prefix of ``records``."""
        n = 0
        for ci, value in records[:self._requeue_limit(chan)]:
            self.send(chan, ci, value)
            n += 1
        if n and self.coalesce_bytes > 0:
            # requeued records must be ON the FIFO when the replay floor is
            # computed — a partial coalesce buffer here would break the
            # contiguous-prefix contract
            self.flush_sends(chan)
        return n

    def _requeue_limit(self, chan) -> int:
        return 0

    def inject_eos(self, chan) -> bool:
        """Controller-side out-of-band EOS (a dead producer cannot send its
        own): non-blocking, returns False when the FIFO is full (retry on
        the next quiesce tick)."""
        return False

    def bricked_channels(self, channels=None) -> set:
        """Channels whose FIFO inherited a *dead reader lock*: a host
        SIGKILLed while blocked inside ``recv`` dies holding the queue's
        reader lock, so every later ``get`` — a restarted worker, the
        controller's drain — times out empty forever.  The controller probes
        a dead host's ingress channels during :meth:`recover` and routes
        around (or rebuilds) whatever this reports.  ``channels`` limits the
        probe (None = all).  Default: nothing bricks (thread hosts cannot be
        SIGKILLed mid-``get``)."""
        return set()

    def rebuild_channel(self, chan) -> bool:
        """Replace a bricked channel's FIFO with a fresh one at the same
        capacity, abandoning the old queue and whatever the corpse left in
        it (the epoch bump makes those records stale anyway).  Returns True
        when the transport could rebuild — the *controller* is responsible
        for restarting any live host still holding an endpoint onto the old
        FIFO (spawned processes snapshot the queue map at spawn time).
        Default: cannot rebuild (fall back to ``mode="rebalance"``)."""
        return False

    def forget_channel(self, chan) -> None:
        """Discard a channel's FIFO entirely so a later ``reconfigure`` /
        ``setup`` recreates it from scratch.  The rebalance fallback uses
        this for bricked FIFOs: ``reconfigure`` keeps the FIFO of every
        channel still in the new cut, so without forgetting, a bricked
        channel whose (src, dst) pair survives the rebalance would hand the
        relocated consumer the same dead queue.  Default: nothing to do."""

    def channel_depths(self) -> dict:
        """``{(src, dst): records waiting right now}`` — the live queue-depth
        probe behind :class:`..core.trace.MetricsSnapshot`.  Best effort
        (mp ``qsize`` is approximate; -1 where the platform cannot say) and
        zero-cost unless polled.  Default: no visibility."""
        return {}

    def channel_capacities(self) -> dict:
        """``{(src, dst): FIFO bound}`` for the channels this transport
        carries — depth/capacity is the occupancy a scaling policy watches
        (1.0 = the cut channel is exerting backpressure)."""
        return {}

    def ring_counts(self) -> dict:
        """``{(src, dst): (chunks through a slot, chunks inline)}`` sent by
        this handle; only the shared-memory ring has two paths."""
        return {}

    def named_resources(self) -> tuple[list, list]:
        """The machine-wide named objects this transport created —
        ``(semaphore names, /dev/shm segment names)`` — which a process
        killed without a clean close leaves behind (a durable deployment
        records them, so whoever adopts it can reclaim them)."""
        return [], []

    def close(self) -> None:
        pass


def queue_semaphores(queues) -> list:
    """The named semaphores behind ``multiprocessing`` queues (each has a
    reader lock, a writer lock and a bound counter)."""
    names = []
    for q in queues:
        for lock in (getattr(q, "_rlock", None), getattr(q, "_wlock", None),
                     getattr(q, "_sem", None)):
            name = getattr(getattr(lock, "_semlock", None), "name", None)
            if name:
                names.append(name)
    return names


class _QueueTransport(ChannelTransport):
    """Shared logic for queue-per-channel transports."""

    def __init__(self):
        self._queues: dict = {}
        self._caps: dict = {}  # chan -> capacity, kept for rebuilds

    def _capacity(self, capacities, chan) -> int:
        cap = capacities.get(chan, 0)
        return cap if cap > 0 else DEFAULT_CAPACITY

    def _new_queue(self, chan, capacities):
        raise NotImplementedError

    def _release_queue(self, q) -> None:
        pass

    def setup(self, cut_channels, capacities) -> None:
        self._caps.update(capacities)
        for chan in cut_channels:
            self._queues[chan] = self._new_queue(chan, capacities)

    def reconfigure(self, cut_channels, capacities) -> None:
        self._caps.update(capacities)
        old = self._queues
        self._queues = {}
        for chan in cut_channels:
            kept = old.pop(chan, None)
            self._queues[chan] = (kept if kept is not None
                                  else self._new_queue(chan, capacities))
        for q in old.values():  # channels no longer in the cut
            self._release_queue(q)

    def bricked_channels(self, channels=None) -> set:
        """Probe each FIFO's reader lock (mp queues only — ``queue.Queue``
        readers are threads, which cannot die holding it): a lock that stays
        held for :data:`_BRICK_PROBE_S` with its reader host dead is the
        corpse's.  Only probe channels whose legitimate reader is known dead
        (the controller passes a dead host's ingress): a *live* reader
        blocked in ``recv`` also holds the lock while waiting."""
        out = set()
        for chan in (list(self._queues) if channels is None else channels):
            q = self._queues.get(chan)
            rlock = getattr(q, "_rlock", None)
            if rlock is None:
                continue
            if rlock.acquire(True, _BRICK_PROBE_S):
                rlock.release()
            else:
                out.add(chan)
        return out

    def rebuild_channel(self, chan) -> bool:
        if chan not in self._queues:
            return False
        self.forget_channel(chan)
        self._queues[chan] = self._new_queue(chan, self._caps)
        return True

    def forget_channel(self, chan) -> None:
        old = self._queues.pop(chan, None)
        if old is None:
            return
        try:  # abandon the bricked FIFO; never join its feeder (it may
            self._release_queue(old)  # be wedged mid-flush with the corpse)
        except Exception:
            pass

    def send(self, chan, ci: int, value) -> None:
        if self.coalesce_bytes > 0:
            if isinstance(value, str) and value == EOS:
                # EOS terminates the stream: flush everything buffered before
                # it, then ship the marker ALONE so drains and out-of-band
                # consumers keep seeing it unwrapped
                self.flush_sends(chan)
                self._put_record(chan, ci, self._pack(value))
                return
            packed = self._pack(value)
            full = None
            with self._buf_lock():
                buf = self._pending_map().setdefault(chan, [[], 0])
                buf[0].append((ci, packed))
                buf[1] += _payload_nbytes(packed)
                if buf[1] >= self.coalesce_bytes:
                    full = self._send_pending.pop(chan)
            if full is not None:  # ship outside the lock (the put may block)
                self._flush_one(chan, full)
            return
        self._put_record(chan, ci, self._pack(value))

    def _put_record(self, chan, ci: int, packed, *,
                    best_effort: bool = False) -> None:
        try:
            self._queues[chan].put((self.epoch, ci, packed),
                                   timeout=0.1 if best_effort
                                   else self.recv_timeout_s)
        except queue.Full:
            if best_effort:
                return  # stale-epoch flush: replay re-sends the drop
            raise TransportError(
                f"{self.name}: channel {chan} full for "
                f"{self.recv_timeout_s}s (consumer host stalled?)") from None

    def _flush_one(self, chan, buf, *, best_effort: bool = False) -> None:
        records = buf[0]
        if len(records) == 1:  # no batching win — ship the plain record
            self._put_record(chan, records[0][0], records[0][1],
                             best_effort=best_effort)
        else:
            self._put_record(chan, records[0][0], _Coalesced(records),
                             best_effort=best_effort)

    def recv(self, chan, ci: int):
        deadline = _time.monotonic() + (self.recv_timeout_s if ci >= 0
                                        else 1.0)
        exploded = self._exploded_map()
        while True:
            buf = exploded.get(chan)
            while buf:  # read-ahead from an exploded coalesced batch
                got_ci, value = buf.pop(0)
                if not buf:
                    exploded.pop(chan, None)
                if isinstance(value, str) and value == EOS:
                    return EOS
                if ci < 0:
                    return value
                if got_ci < ci:
                    continue  # replayed duplicate of an already-folded chunk
                if got_ci > ci:
                    raise TransportError(
                        f"{self.name}: channel {chan} out of order: "
                        f"expected chunk {ci}, got {got_ci}")
                return value
            try:
                ep, got_ci, value = self._queues[chan].get(
                    timeout=max(deadline - _time.monotonic(), 0.01))
            except queue.Empty:
                raise TransportError(
                    f"{self.name}: channel {chan} empty for "
                    f"{self.recv_timeout_s}s (producer host died?)") from None
            if isinstance(value, _Coalesced):
                # ONE epoch check for the whole batch (records never
                # straddle a bump), then explode into the read-ahead buffer;
                # each sub-record still passes the dup/order filter above
                if ci >= 0 and ep < self.epoch:
                    continue  # pre-recovery leftover batch
                if ci >= 0 and ep > self.epoch:
                    raise TransportError(
                        f"{self.name}: channel {chan} carries epoch {ep} "
                        f"but this endpoint is at {self.epoch} (controller "
                        "out of sync)")
                exploded.setdefault(chan, []).extend(
                    (rci, rv if isinstance(rv, str) else self._unpack(rv))
                    for rci, rv in value.records)
                continue
            if ci < 0:  # draining: any record at any epoch
                if isinstance(value, str) and value == EOS:
                    return EOS
                return self._unpack(value)
            if ep < self.epoch:
                continue  # pre-recovery leftover: silently discarded
            if ep > self.epoch:
                raise TransportError(
                    f"{self.name}: channel {chan} carries epoch {ep} but "
                    f"this endpoint is at {self.epoch} (controller out of "
                    "sync)")
            if isinstance(value, str) and value == EOS:
                return EOS  # stream terminator outranks the order check (a
                # peer failing mid-stream sends EOS out of band)
            if got_ci < ci:
                continue  # replayed duplicate of an already-folded chunk
            if got_ci > ci:
                raise TransportError(
                    f"{self.name}: channel {chan} out of order: expected "
                    f"chunk {ci}, got {got_ci}")
            return self._unpack(value)

    def drain(self, channels=None, *, keep=frozenset()) -> dict:
        out = {}
        for chan in (self._queues if channels is None else channels):
            q = self._queues[chan]
            records, empties, failures = [], 0, 0
            while empties < 2 and failures < 10_000:
                try:
                    item = q.get(timeout=_DRAIN_POLL_S)
                    if isinstance(item[2], _Coalesced):  # flatten the batch
                        records.extend((item[0], rci, rv)
                                       for rci, rv in item[2].records)
                    else:
                        records.append(item)
                    empties = 0
                except queue.Empty:
                    empties += 1
                except Exception:  # a peer killed mid-put can corrupt a
                    failures += 1  # pickled record — count it lost, move on
            # sweep the unflushed coalesce buffers last — the controller's
            # own AND every thread host endpoint's: those producers believe
            # the records were sent
            records.extend((self.epoch, rci, rv)
                           for rci, rv in self._sweep_pending(chan))
            kept, dropped = [], 0
            for ep, ci, value in records:
                if (chan in keep and ci >= 0
                        and not (isinstance(value, str) and value == EOS)):
                    kept.append((ci, value if isinstance(value, str)
                                 else self._unpack(value)))
                else:
                    dropped += 1
            out[chan] = (kept, dropped + failures)
        return out

    def _requeue_limit(self, chan) -> int:
        return self._queues[chan].maxsize or DEFAULT_CAPACITY

    def channel_depths(self) -> dict:
        out = {}
        for chan, q in self._queues.items():
            try:
                out[chan] = q.qsize()
            except (NotImplementedError, OSError):
                out[chan] = -1  # platform without sem_getvalue (macOS mp)
        return out

    def channel_capacities(self) -> dict:
        return {chan: (getattr(q, "maxsize", 0)
                       or getattr(q, "_maxsize", 0) or DEFAULT_CAPACITY)
                for chan, q in self._queues.items()}

    def inject_eos(self, chan) -> bool:
        try:
            self._queues[chan].put((self.epoch, -1, EOS), timeout=0.1)
            return True
        except queue.Full:
            return False

    def _pack(self, value):
        return value

    def _unpack(self, value):
        return value


class InProcess(_QueueTransport):
    """Loopback transport: hosts are threads, channels are ``queue.Queue``s
    bounded by the CSP capacity.  The always-available reference.

    :meth:`endpoint` hands each host its own :class:`_ThreadEndpoint` —
    shared FIFOs and epoch, host-local coalesce buffers and read-ahead —
    so concurrent host threads never touch one another's buffered records."""

    name = "inprocess"

    def __init__(self):
        super().__init__()
        # controller-side flushes and drain sweeps race host-thread sends:
        # the coalesce buffers need a real lock here (per-process endpoints
        # are single-threaded and stay lock-free)
        self._coalesce_lock = threading.Lock()
        self._endpoints: dict = {}  # host -> _ThreadEndpoint (stable)

    def _new_queue(self, chan, capacities):
        return queue.Queue(maxsize=self._capacity(capacities, chan))

    def endpoint(self, host: int):
        # one stable endpoint per host: a restarted thread host reuses it
        # (its fresh executor clears the read-ahead; stale send buffers
        # flush as stale-epoch records on the next bump)
        ep = self._endpoints.get(host)
        if ep is None:
            ep = self._endpoints[host] = _ThreadEndpoint(self, host)
        return ep

    def set_epoch(self, epoch: int) -> None:
        # the epoch bump is a flush barrier for EVERY host's buffers, not
        # just the controller's own: records buffered before the bump
        # belong to the abandoned stream and must arrive stamped with the
        # OLD epoch (never renumbered)
        if epoch != self._epoch:
            for ep in list(self._endpoints.values()):
                ep.flush_sends(best_effort=True)
        super().set_epoch(epoch)


class _ThreadEndpoint(_QueueTransport):
    """Per-host handle of a thread transport (InProcess / DeviceTransport).

    The FIFOs, epoch and knobs are live views of the parent's (a rebuilt
    channel is visible immediately — thread hosts, unlike spawned
    processes, never snapshot the queue map), but the coalescing state —
    unflushed send buffers and the exploded-batch read-ahead — is THIS
    host's alone.  Sharing it (the old endpoint()-returns-``self``
    behaviour) let one host's ``clear_read_buffers`` destroy a
    stall-resuming peer's read-ahead, and let a flush-pop interleave with a
    concurrent append so a record landed in an already-detached buffer and
    never flushed."""

    def __init__(self, parent, host: int):
        self._parent = parent
        self.host = host
        self.name = parent.name
        self._send_pending: dict = {}
        self._recv_exploded: dict = {}
        self._coalesce_lock = threading.Lock()

    @property
    def _queues(self):
        return self._parent._queues

    @property
    def epoch(self) -> int:
        return self._parent.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        # the epoch is deployment-wide state: route through the parent so
        # every host's stale buffers flush under the old stamp
        self._parent.set_epoch(value)

    @property
    def recv_timeout_s(self) -> float:
        return self._parent.recv_timeout_s

    @recv_timeout_s.setter
    def recv_timeout_s(self, value: float) -> None:
        self._parent.recv_timeout_s = value

    @property
    def coalesce_bytes(self) -> int:
        return self._parent.coalesce_bytes

    @coalesce_bytes.setter
    def coalesce_bytes(self, value: int) -> None:
        self._parent.coalesce_bytes = value

    def send(self, chan, ci: int, value) -> None:
        if not isinstance(value, str):
            value = self._parent._send_transform(chan, value)
        super().send(chan, ci, value)

    def _pack(self, value):
        return self._parent._pack(value)

    def _unpack(self, value):
        return self._parent._unpack(value)


class MultiProcessPipe(_QueueTransport):
    """Real host boundaries: one OS process per host (``spawn`` — a fresh
    interpreter, CUDA context and set of kernel libraries each), channels
    are bounded ``multiprocessing`` queues, values cross as raw bytes with
    a dtype tag (:func:`pack_raw`) and are rebuilt on the consumer host's
    device."""

    name = "pipe"
    process_hosts = True

    def __init__(self, ctx=None):
        super().__init__()
        if ctx is None:
            import multiprocessing
            # spawn: never fork a process whose CUDA context is live (CUDA
            # does not survive fork); children rebuild the network from a
            # factory
            ctx = multiprocessing.get_context("spawn")
        self.ctx = ctx

    def _new_queue(self, chan, capacities):
        return self.ctx.Queue(maxsize=self._capacity(capacities, chan))

    def _release_queue(self, q) -> None:
        q.close()

    def _requeue_limit(self, chan) -> int:
        return self._queues[chan]._maxsize or DEFAULT_CAPACITY

    def endpoint(self, host: int):
        # mp.Queues are inheritable through Process args; ship only the dict
        ep = _PipeEndpoint(self._queues)
        ep.recv_timeout_s = self.recv_timeout_s  # keep any override
        ep.coalesce_bytes = self.coalesce_bytes
        return ep

    def named_resources(self) -> tuple[list, list]:
        return queue_semaphores(self._queues.values()), []

    def _pack(self, value):
        # tensor and contiguous numpy leaves cross as raw header+buffer
        # records — the queue then pickles plain bytes, never tensors
        return pack_raw(value)

    def _unpack(self, value):
        return unpack_raw(value)

    def close(self) -> None:
        for q in self._queues.values():
            q.close()
            q.join_thread()


class _PipeEndpoint(_QueueTransport):
    """Child-process handle of a MultiProcessPipe (picklable via Process
    args inheritance).  ``device`` is the host's own: the host entry sets it
    once its executor is built, and received tensors land there."""

    name = "pipe"

    def __init__(self, queues):
        super().__init__()
        self._queues = queues
        self.device = None

    def _pack(self, value):
        return pack_raw(value)

    def _unpack(self, value):
        return unpack_raw(value, self.device)


class _ShmLeaf:
    """Placement record of one leaf inside a shared-memory slot: the torch
    dtype's name (``"bfloat16"``; numpy has no bf16) or a numpy leaf's
    ``dtype.str``, the full shape (``()`` for 0-d leaves) and the byte
    offset in the slot."""

    __slots__ = ("torch", "dtype", "shape", "offset")

    def __init__(self, is_torch: bool, dtype: str, shape: tuple,
                 offset: int):
        self.torch = is_torch
        self.dtype = dtype
        self.shape = shape
        self.offset = offset

    def __getstate__(self):
        return (self.torch, self.dtype, self.shape, self.offset)

    def __setstate__(self, state):
        self.torch, self.dtype, self.shape, self.offset = state


_SHM_ALIGN = 64  # leaves start on 64-byte boundaries inside a slot


def _aligned(offset: int) -> int:
    return -(-offset // _SHM_ALIGN) * _SHM_ALIGN


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.nbytes


def _slot_leaves(value):
    """``value``'s leaves as the ring writes them: tensors detached, numpy
    leaves C-contiguous (0-d kept), anything else as it is.  Returns
    ``(tree, bytes the leaves take in a slot, exotic)``; exotic (object or
    structured numpy dtypes) cannot be written as raw bytes."""
    total, exotic = 0, False  # total: where the last leaf ends

    def _one(leaf):
        nonlocal total, exotic
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
        elif isinstance(leaf, (np.ndarray, np.generic)):
            leaf = _as_contig(leaf)
            if not _rawable(leaf):
                exotic = True
                return leaf
        else:
            return leaf
        total = _aligned(total) + _leaf_nbytes(leaf)
        return leaf

    tree = pytree.tree_map(_one, value)
    return tree, total, exotic


def _write_slot(buf, tree):
    """Write every array leaf of ``tree`` into the slot ``buf`` (a
    shared-memory ``memoryview``) with ONE copy each, straight through a
    view of the slot (a CUDA tensor copies from the card into it); returns
    the tree of :class:`_ShmLeaf` placements."""
    offset = 0

    def _one(leaf):
        nonlocal offset
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            offset = _aligned(offset)
        if isinstance(leaf, torch.Tensor):
            n = _leaf_nbytes(leaf)
            meta = _ShmLeaf(True, str(leaf.dtype).removeprefix("torch."),
                            tuple(leaf.shape), offset)
            if n:
                torch.frombuffer(buf, dtype=torch.uint8, count=n,
                                 offset=offset).view(leaf.dtype).view(
                                     leaf.shape).copy_(leaf)
        elif isinstance(leaf, np.ndarray):
            n = leaf.nbytes
            meta = _ShmLeaf(False, leaf.dtype.str, leaf.shape, offset)
            if n:
                np.copyto(np.frombuffer(buf, dtype=leaf.dtype,
                                        count=leaf.size,
                                        offset=offset).reshape(leaf.shape),
                          leaf)
        else:
            return leaf
        offset += n
        return meta

    return pytree.tree_map(_one, tree)


def _read_slot(buf, meta_tree, device):
    """Rebuild the leaves of ``meta_tree`` out of the slot ``buf``: each a
    writable copy that does not alias the slot, tensors on ``device``
    (``None``: the CPU).  A copy onto a card is finished before this
    returns, so the caller may recycle the slot at once."""

    def _one(meta):
        if not isinstance(meta, _ShmLeaf):
            return meta
        n_el = 1
        for s in meta.shape:
            n_el *= s
        if not meta.torch:
            dt = np.dtype(meta.dtype)
            return np.frombuffer(buf, dtype=dt, count=n_el,
                                 offset=meta.offset).reshape(
                                     meta.shape).copy()
        dtype = getattr(torch, meta.dtype)
        if n_el == 0:
            t = torch.empty(meta.shape, dtype=dtype)
            return t if device is None else t.to(device)
        view = torch.frombuffer(buf, dtype=torch.uint8,
                                count=n_el * dtype.itemsize,
                                offset=meta.offset).view(dtype).view(
                                    meta.shape)
        if device is None or device.type == "cpu":
            return view.clone()
        return view.to(device, non_blocking=False)

    out = pytree.tree_map(_one, meta_tree)
    if device is not None and device.type == "cuda":
        # the slot is recycled once this returns: every copy out of it
        # must have landed on the card first
        torch.cuda.current_stream(device).synchronize()
    return out


def _attach_shm(name: str):
    """Attach a peer-created segment.  Spawned hosts share the parent's
    resource-tracker process and its registry is a *set*, so the attach's
    re-registration is idempotent and the single unregister happens when the
    owning transport ``unlink``\\ s in :meth:`SharedMemoryRing.close` —
    never unregister here, or concurrent hosts race to double-remove the
    name and the tracker logs KeyErrors."""
    from multiprocessing import shared_memory
    return shared_memory.SharedMemory(name=name)


class _ShmRing:
    """One channel's ring: slot names + the two queues that cycle them.

    Picklable through ``Process`` args (mp queues inherit); attached
    ``SharedMemory`` objects are cached per process, never pickled.
    """

    def __init__(self, slot_names: list, slot_bytes: int, free_q, data_q,
                 capacity: Optional[int] = None):
        self.slot_names = slot_names
        self.slot_bytes = slot_bytes
        self.free_q = free_q  # indices of writable slots (backpressure)
        self.data_q = data_q  # (ci, header) FIFO, bounded by capacity
        # the LOGICAL CSP bound — double-buffered rings hold 2× slots but
        # the header queue still only admits `capacity` in-flight records
        self.capacity = capacity if capacity is not None else len(slot_names)


class _ShmOps:
    """send/recv over ``self._rings`` — shared by the parent transport and
    the picklable child endpoint.  Received tensors land on ``device`` (the
    host's own, set by the host entry; ``None``: the CPU)."""

    name = "shm"
    _rings: dict
    device = None

    # the shm coalesce budget is capped by the ring's slot size: a batch
    # must fit ONE slot, or _flush_one silently degrades to per-record
    # sends and the fast path never engages.  The setter clamps (with a
    # warning) so a mis-sized budget is visible instead of silent.
    @property
    def coalesce_bytes(self) -> int:
        return getattr(self, "_coalesce_bytes", 0)

    @coalesce_bytes.setter
    def coalesce_bytes(self, value: int) -> None:
        value = int(value)
        limit = self._slot_limit()
        if value > 0 and limit and value > limit:
            import warnings
            warnings.warn(
                f"shm: coalesce_bytes={value} exceeds slot_bytes={limit}; "
                f"clamping to {limit} (a coalesced batch must fit one ring "
                "slot or every batch falls back to per-record sends)",
                RuntimeWarning, stacklevel=2)
            value = limit
        self._coalesce_bytes = value

    def _slot_limit(self) -> int:
        sb = getattr(self, "slot_bytes", 0)  # the owning transport
        if sb:
            return sb
        rings = getattr(self, "_rings", None)  # a child endpoint
        if rings:
            return min((r.slot_bytes for r in rings.values()), default=0)
        return 0

    def _attached(self) -> dict:
        cache = getattr(self, "_shm_cache", None)
        if cache is None:
            cache = self._shm_cache = {}
        return cache

    def _slot(self, ring: _ShmRing, idx: int):
        cache = self._attached()
        name = ring.slot_names[idx]
        if name not in cache:
            cache[name] = _attach_shm(name)
        return cache[name]

    # -- which path each chunk took ---------------------------------------
    def _count(self, chan, path: int, n: int = 1) -> None:
        counts = getattr(self, "_ring_counts", None)
        if counts is None:
            counts = self._ring_counts = {}
        counts.setdefault(chan, [0, 0])[path] += n

    def ring_counts(self) -> dict:
        """``{chan: (chunks sent through a slot, chunks sent inline)}``
        by THIS handle since it was made: a run shows which path its bytes
        took (inline: larger than a slot, or an exotic numpy dtype)."""
        return {chan: tuple(c) for chan, c in
                getattr(self, "_ring_counts", {}).items()}

    def send(self, chan, ci: int, value) -> None:
        if self.coalesce_bytes > 0:
            if isinstance(value, str) and value == EOS:
                # EOS flushes what precedes it, then ships alone (unwrapped)
                self.flush_sends(chan)
                self._send_one(chan, ci, value)
                return
            full = None
            with self._buf_lock():
                buf = self._pending_map().setdefault(chan, [[], 0])
                buf[0].append((ci, value))  # RAW values; written into a
                buf[1] += _payload_nbytes(value)  # slot at flush time
                if buf[1] >= self.coalesce_bytes:
                    full = self._send_pending.pop(chan)
            if full is not None:  # write + ship outside the lock
                self._flush_one(chan, full)
            return
        self._send_one(chan, ci, value)

    def _free_slot(self, ring: _ShmRing, chan, best_effort: bool):
        try:
            return ring.free_q.get(timeout=0.1 if best_effort
                                   else self.recv_timeout_s)
        except queue.Empty:
            if best_effort:
                return None  # stale-epoch flush: replay re-sends the drop
            raise TransportError(
                f"{self.name}: channel {chan} has no free slot for "
                f"{self.recv_timeout_s}s (consumer host stalled?)") from None

    def _write_free_slot(self, ring: _ShmRing, chan, tree, best_effort):
        """Take a free slot and write ``tree`` into it: ``(idx, placements)``,
        or ``(None, None)`` when a best-effort send finds no slot.  A write
        that fails hands its slot back, so the ring keeps its capacity."""
        idx = self._free_slot(ring, chan, best_effort)
        if idx is None:
            return None, None
        try:
            return idx, _write_slot(self._slot(ring, idx).buf, tree)
        except BaseException:
            ring.free_q.put(idx)
            raise

    def _send_one(self, chan, ci: int, value, *,
                  best_effort: bool = False) -> None:
        ring = self._rings[chan]
        if isinstance(value, str):  # SKIP / EOS markers need no slot
            self._put_header(ring, chan, (self.epoch, ci, ("marker", value)),
                             best_effort=best_effort)
            return
        tree, total, exotic = _slot_leaves(value)
        if total > ring.slot_bytes or exotic:
            # the reference's semantics: oversized / exotic chunks ship
            # inline through the header queue (counted, never silent)
            self._count(chan, 1)
            self._put_header(ring, chan,
                             (self.epoch, ci, ("inline", pack_raw(tree))),
                             best_effort=best_effort)
            return
        idx, meta = self._write_free_slot(ring, chan, tree, best_effort)
        if idx is None:
            return
        self._count(chan, 0)
        self._put_header(ring, chan, (self.epoch, ci, ("slot", idx, meta)),
                         best_effort=best_effort)

    def _flush_one(self, chan, buf, *, best_effort: bool = False) -> None:
        records = buf[0]
        if len(records) == 1:  # no batching win — ship the plain record
            self._send_one(chan, records[0][0], records[0][1],
                           best_effort=best_effort)
            return
        ring = self._rings[chan]
        # one slot, the leaves of every record one after another: lay the
        # batch out as ONE tree, so its size counts the alignment between
        # records and the offsets never overlap
        trees, total, exotic = _slot_leaves(
            [value for _, value in records if not isinstance(value, str)])
        if exotic or total > ring.slot_bytes:
            # the batch cannot share one slot: ship it record by record
            for ci, value in records:
                self._send_one(chan, ci, value, best_effort=best_effort)
            return
        idx, metas = self._write_free_slot(ring, chan, trees, best_effort)
        if idx is None:
            return
        entries, it = [], iter(metas)
        for ci, value in records:
            entries.append((ci, ("marker", value)) if isinstance(value, str)
                           else (ci, ("tree", next(it))))
        self._count(chan, 0, len(metas))
        self._put_header(ring, chan,
                         (self.epoch, records[0][0],
                          ("cbatch", idx, entries)),
                         best_effort=best_effort)

    def _put_header(self, ring: _ShmRing, chan, item, *,
                    best_effort: bool = False) -> None:
        try:
            ring.data_q.put(item, timeout=0.1 if best_effort
                            else self.recv_timeout_s)
        except queue.Full:
            header = item[2]  # dropping the header must still recycle
            if header[0] in ("slot", "cbatch"):  # its slot
                ring.free_q.put(header[1])
            if best_effort:
                return
            raise TransportError(
                f"{self.name}: channel {chan} full for "
                f"{self.recv_timeout_s}s (consumer host stalled?)") from None

    def _discard_header(self, ring: _ShmRing, header) -> None:
        """Drop a header, recycling its slot (the ring invariant is that
        free slots + in-flight slots == slot count)."""
        if header[0] in ("slot", "cbatch"):
            ring.free_q.put(header[1])

    def _consume_header(self, ring: _ShmRing, header):
        """Decode a header into its value, recycling the slot only once
        every leaf has been copied out of it."""
        if header[0] == "marker":
            return header[1]
        if header[0] == "inline":
            return unpack_raw(header[1], self.device)
        _, idx, meta_tree = header
        out = _read_slot(self._slot(ring, idx).buf, meta_tree, self.device)
        ring.free_q.put(idx)
        return out

    def _consume_batch(self, ring: _ShmRing, header) -> list:
        """Decode every record of a ``("cbatch", idx, entries)`` header out
        of its slot (copying — the slot is recycled once, at the end) and
        return ``[(ci, value), ...]`` in send order."""
        _, idx, entries = header
        metas = [e[1] for _, e in entries if e[0] == "tree"]
        values = iter(_read_slot(self._slot(ring, idx).buf, metas,
                                 self.device))
        out = [(ci, entry[1] if entry[0] == "marker" else next(values))
               for ci, entry in entries]
        ring.free_q.put(idx)
        return out

    def recv(self, chan, ci: int):
        ring = self._rings[chan]
        deadline = _time.monotonic() + (self.recv_timeout_s if ci >= 0
                                        else 1.0)
        exploded = self._exploded_map()
        while True:
            buf = exploded.get(chan)
            while buf:  # read-ahead from an exploded coalesced batch
                got_ci, value = buf.pop(0)
                if not buf:
                    exploded.pop(chan, None)
                if isinstance(value, str) and value == EOS:
                    return EOS
                if ci < 0:
                    return value
                if got_ci < ci:
                    continue  # replayed duplicate of an already-folded chunk
                if got_ci > ci:
                    raise TransportError(
                        f"{self.name}: channel {chan} out of order: "
                        f"expected chunk {ci}, got {got_ci}")
                return value
            try:
                ep, got_ci, header = ring.data_q.get(
                    timeout=max(deadline - _time.monotonic(), 0.01))
            except queue.Empty:
                raise TransportError(
                    f"{self.name}: channel {chan} empty for "
                    f"{self.recv_timeout_s}s (producer host died?)") from None
            if header[0] == "cbatch":
                # ONE epoch check for the whole batch, then explode into the
                # read-ahead buffer (sub-records hit the dup/order filter)
                if ci >= 0 and ep < self.epoch:
                    self._discard_header(ring, header)
                    continue
                if ci >= 0 and ep > self.epoch:
                    self._discard_header(ring, header)
                    raise TransportError(
                        f"{self.name}: channel {chan} carries epoch {ep} "
                        f"but this endpoint is at {self.epoch} (controller "
                        "out of sync)")
                exploded.setdefault(chan, []).extend(
                    self._consume_batch(ring, header))
                continue
            is_eos = header[0] == "marker" and header[1] == EOS
            if ci < 0:  # draining: any record at any epoch
                return EOS if is_eos else self._consume_header(ring, header)
            if ep < self.epoch:
                self._discard_header(ring, header)  # pre-recovery leftover
                continue
            if ep > self.epoch:
                self._discard_header(ring, header)
                raise TransportError(
                    f"{self.name}: channel {chan} carries epoch {ep} but "
                    f"this endpoint is at {self.epoch} (controller out of "
                    "sync)")
            if is_eos:
                return EOS  # stream terminator outranks the order check
            if got_ci < ci:
                self._discard_header(ring, header)  # replayed duplicate
                continue
            if got_ci > ci:
                self._discard_header(ring, header)
                raise TransportError(
                    f"{self.name}: channel {chan} out of order: expected "
                    f"chunk {ci}, got {got_ci}")
            return self._consume_header(ring, header)

    def channel_depths(self) -> dict:
        out = {}
        for chan, ring in self._rings.items():
            try:
                out[chan] = ring.data_q.qsize()
            except (NotImplementedError, OSError):
                out[chan] = -1
        return out

    def channel_capacities(self) -> dict:
        return {chan: ring.capacity for chan, ring in self._rings.items()}


class SharedMemoryRing(_ShmOps, ChannelTransport):
    """Cut channels over ``multiprocessing.shared_memory`` between spawned
    host processes.

    Each channel preallocates ``capacity`` fixed-size slots of
    ``slot_bytes`` (twice as many with ``double_buffer``); a send writes
    the chunk's leaves into a free slot — one copy a leaf, straight from
    the tensor (on the card or not) into the slot, no pickling of the
    payload — and queues a small placement header; the receiver copies the
    leaves out of the slot onto its own device and then recycles the slot.
    A producer that outruns its consumer blocks on the header queue (the
    CSP bound, ``ChannelDef.capacity`` as on every transport) or on the
    empty free-slot queue.

    Chunks larger than ``slot_bytes`` (and numpy leaves of object or
    structured dtypes) ship inline through the header queue, as raw
    header+buffer records (:func:`pack_raw`), so the transport never wedges
    on an unexpected payload; :meth:`ring_counts` counts each channel's
    chunks by path, and the hosts report them (``HostReport.metrics``,
    :func:`..core.netlog.cluster_report`).

    Every slot needs ``slot_bytes`` of ``/dev/shm`` once written: size the
    slot to the largest chunk (:meth:`slot_bytes_for`) and check the free
    space before a large ring.
    Owned segments are unlinked by :meth:`close`, and from ``atexit`` if a
    parent dies without closing.
    """

    name = "shm"
    process_hosts = True

    def __init__(self, ctx=None, slot_bytes: int = 1 << 20,
                 double_buffer: bool = False):
        if ctx is None:
            import multiprocessing
            ctx = multiprocessing.get_context("spawn")
        self.ctx = ctx
        self.slot_bytes = int(slot_bytes)
        # 2× physical slots per ring (same logical CSP capacity): a producer
        # writes the next slot while the consumer still reads the previous
        # one, instead of blocking on free_q
        self.double_buffer = double_buffer
        self._rings: dict = {}
        self._caps: dict = {}   # chan -> capacity, kept for rebuilds
        self._owned: dict = {}  # chan -> created segments; we unlink them
        self._atexit_armed = False

    @staticmethod
    def slot_bytes_for(chunk) -> int:
        """The ``slot_bytes`` that carries ``chunk`` through a slot: its
        leaves laid out as a send writes them, the alignment between them
        included.  ``chunk`` may hold ``meta`` tensors of the real shapes,
        so sizing a ring allocates nothing."""
        return max(_slot_leaves(chunk)[1], 1)

    def _make_ring(self, chan, capacities) -> _ShmRing:
        from multiprocessing import shared_memory
        cap = capacities.get(chan, 0) or DEFAULT_CAPACITY
        n_slots = cap * 2 if self.double_buffer else cap
        slots = [shared_memory.SharedMemory(create=True,
                                            size=self.slot_bytes)
                 for _ in range(n_slots)]
        self._owned[chan] = slots
        self._attached().update({s.name: s for s in slots})
        free_q = self.ctx.Queue()
        for i in range(n_slots):
            free_q.put(i)
        data_q = self.ctx.Queue(maxsize=cap)  # the CSP bound, not slot count
        return _ShmRing([s.name for s in slots], self.slot_bytes,
                        free_q, data_q, capacity=cap)

    def setup(self, cut_channels, capacities) -> None:
        self._caps.update(capacities)
        for chan in cut_channels:
            self._rings[chan] = self._make_ring(chan, capacities)
        # a process that dies without a clean close() must not strand the
        # segments: /dev/shm outlives us, so unlink from atexit as a net
        if not self._atexit_armed:
            import atexit
            atexit.register(self._unlink_owned)
            self._atexit_armed = True

    def reconfigure(self, cut_channels, capacities) -> None:
        self._caps.update(capacities)
        keep = set(cut_channels)
        for chan in list(self._rings):
            if chan not in keep:
                self._release_ring(chan)
        for chan in cut_channels:
            if chan not in self._rings:
                self._rings[chan] = self._make_ring(chan, capacities)

    def owned_names(self) -> list:
        """Names of the ``/dev/shm`` segments this transport created and
        has not unlinked yet (empty after :meth:`close`)."""
        return [s.name for slots in self._owned.values() for s in slots]

    def named_resources(self) -> tuple[list, list]:
        return (queue_semaphores(q for r in self._rings.values()
                                 for q in (r.free_q, r.data_q)),
                self.owned_names())

    def bricked_channels(self, channels=None) -> set:
        """A ring has TWO reader locks a corpse can hold: the header queue's
        (consumer killed mid-``recv``) and the free-slot queue's (producer
        killed waiting for a slot).  Either one wedges the channel."""
        out = set()
        for chan in (list(self._rings) if channels is None else channels):
            ring = self._rings.get(chan)
            if ring is None:
                continue
            for q in (ring.data_q, ring.free_q):
                rlock = getattr(q, "_rlock", None)
                if rlock is None:
                    continue
                if rlock.acquire(True, _BRICK_PROBE_S):
                    rlock.release()
                else:
                    out.add(chan)
                    break
        return out

    def rebuild_channel(self, chan) -> bool:
        if chan not in self._rings:
            return False
        self.forget_channel(chan)
        self._rings[chan] = self._make_ring(chan, self._caps)
        return True

    def forget_channel(self, chan) -> None:
        if chan not in self._rings:
            return
        try:  # release slots + queues of the bricked ring; best effort —
            self._release_ring(chan)  # the corpse may hold its locks
        except Exception:
            # a wedged queue close must not strand the segments: they are
            # only ever unlinked through _owned, so walk it here too
            self._rings.pop(chan, None)
            self._unlink(self._owned.pop(chan, ()))

    def _unlink(self, slots) -> None:
        cache = self._attached()
        for shm in slots:
            cache.pop(shm.name, None)
            try:
                shm.close()
            except BufferError:
                pass  # a view still exported: the mapping goes with us
            try:
                shm.unlink()
            except FileNotFoundError:
                pass

    def _release_ring(self, chan) -> None:
        ring = self._rings.pop(chan)
        self._unlink(self._owned.pop(chan, ()))
        for q in (ring.free_q, ring.data_q):
            q.close()

    def drain(self, channels=None, *, keep=frozenset()) -> dict:
        out = {}
        for chan in (list(self._rings) if channels is None else channels):
            ring = self._rings[chan]
            records, empties, failures = [], 0, 0
            while empties < 2 and failures < 10_000:
                try:
                    records.append(ring.data_q.get(timeout=_DRAIN_POLL_S))
                    empties = 0
                except queue.Empty:
                    empties += 1
                except Exception:  # a peer killed mid-put can corrupt a
                    failures += 1  # pickled header — count it lost, move on
            kept, dropped = [], failures
            for ep, ci, header in records:
                if header[0] == "cbatch":
                    if chan in keep:
                        for rci, rv in self._consume_batch(ring, header):
                            if rci >= 0 and not (isinstance(rv, str)
                                                 and rv == EOS):
                                kept.append((rci, rv))
                            else:
                                dropped += 1
                    else:
                        self._discard_header(ring, header)
                        dropped += 1
                    continue
                is_eos = header[0] == "marker" and header[1] == EOS
                if chan in keep and ci >= 0 and not is_eos:
                    # decode out of the slot (recycling it): holding slots
                    # hostage would starve the producer's free-slot ring
                    kept.append((ci, self._consume_header(ring, header)))
                else:
                    self._discard_header(ring, header)
                    dropped += 1
            # sweep the unflushed coalesce buffers (raw values, send order)
            for rci, rv in self._sweep_pending(chan):
                if (chan in keep and rci >= 0
                        and not (isinstance(rv, str) and rv == EOS)):
                    kept.append((rci, rv))
                else:
                    dropped += 1
            out[chan] = (kept, dropped)
        return out

    def _requeue_limit(self, chan) -> int:
        return self._rings[chan].capacity

    def inject_eos(self, chan) -> bool:
        try:
            self._rings[chan].data_q.put(
                (self.epoch, -1, ("marker", EOS)), timeout=0.1)
            return True
        except queue.Full:
            return False

    def endpoint(self, host: int):
        ep = _ShmEndpoint(self._rings)
        ep.recv_timeout_s = self.recv_timeout_s  # keep any override
        ep.coalesce_bytes = self.coalesce_bytes
        return ep

    def _unlink_owned(self) -> None:
        for slots in self._owned.values():
            self._unlink(slots)
        self._owned = {}

    def close(self) -> None:
        self._unlink_owned()
        if self._atexit_armed:
            import atexit
            atexit.unregister(self._unlink_owned)
            self._atexit_armed = False
        for ring in self._rings.values():
            for q in (ring.free_q, ring.data_q):
                q.close()
                q.join_thread()


class _ShmEndpoint(_ShmOps, ChannelTransport):
    """Child-process handle of a SharedMemoryRing (picklable via Process
    args inheritance; attaches slots lazily, once per process).
    ``device`` is the host's own: the host entry sets it once its executor
    is built, and received tensors land there."""

    name = "shm"
    process_hosts = True

    def __init__(self, rings: dict):
        self._rings = rings
        self.device = None


class DeviceTransport(InProcess):
    """Thread hosts whose tensors stay on the card: host *h* owns
    ``cuda:(h % device_count)`` (on one card every host shares ``cuda:0``),
    and a send places the chunk on the consumer host's device.  The
    placement is eager: PyTorch has no jit to fold it into, and on one card
    it is a no-op."""

    name = "device"

    def __init__(self):
        super().__init__()
        self._dst_device: dict = {}

    @staticmethod
    def device_split(n_hosts: int, base: torch.device) -> list:
        """Each host's device: round-robin over the CUDA devices, or
        ``base`` for every host when the deployment runs off the card."""
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if base.type == "cuda" else [base])
        return [devs[h % len(devs)] for h in range(n_hosts)]

    def bind(self, dst_devices: dict) -> None:
        """Record each cut channel's consumer device ``{chan: device}``."""
        self._dst_device = dict(dst_devices)

    def _send_transform(self, chan, value):
        # per-host endpoints route their sends through this hook, so the
        # consumer placement happens no matter which handle sends
        dev = self._dst_device.get(chan)
        if dev is None:
            return value
        return pytree.tree_map(
            lambda l: l.to(dev) if isinstance(l, torch.Tensor) else l, value)


def make_transport(kind: str, **kw) -> ChannelTransport:
    """A transport by name: ``"inprocess"``, ``"pipe"``, ``"shm"`` (with
    ``slot_bytes=`` and ``double_buffer=``) or ``"device"``.
    ``coalesce_bytes=`` is accepted by every kind."""
    kinds = {"inprocess": InProcess, "pipe": MultiProcessPipe,
             "shm": SharedMemoryRing, "device": DeviceTransport}
    if kind not in kinds:
        raise NetworkError(
            f"unknown transport {kind!r}; pick one of {sorted(kinds)}")
    coalesce = kw.pop("coalesce_bytes", 0)
    t = kinds[kind](**kw)
    if coalesce:
        t.coalesce_bytes = int(coalesce)
    return t
