"""Pluggable channel transports: how a cut channel moves chunks between hosts.

A :class:`ChannelTransport` realises the cut channels of a
:class:`.partition.PartitionPlan` as bounded FIFO pipes.  The bound is the
channel's CSP ``capacity`` (``ChannelDef.capacity``; rendezvous channels get
``DEFAULT_CAPACITY``), and ``send`` *blocks* when the pipe is full — the
streaming executor's backpressure extended across the host boundary: a slow
consumer host throttles its producer host through the transport itself,
exactly as a buffered CSP channel chain would.

Three implementations:

* :class:`InProcess` — ``queue.Queue``-backed loopback; hosts are threads in
  this interpreter.  Always available; the reference semantics.
* :class:`MultiProcessPipe` — ``multiprocessing`` queues between *real OS
  processes* (spawn start method: each host is a fresh interpreter with its
  own CUDA context), so the tests exercise genuine host boundaries.  Values
  cross as raw bytes with a dtype tag (:func:`pack_raw`) and are rebuilt on
  the consumer host's device.
* :class:`DeviceTransport` — thread hosts whose tensors stay on the card:
  host *h* runs on ``cuda:(h % device_count)``, and a send places the chunk
  on the consumer host's device (a no-op when producer and consumer share
  a card).

The shared-memory ring (``"shm"``) is the next cluster slice's work:
:func:`make_transport` refuses it with ``NotImplementedError``.

All transports carry a per-chunk SKIP marker so upstream COMBINE reducers
(which emit nothing until their final chunk) stay chunk-aligned across the
cut, and an EOS marker as a defensive stream terminator.

Every record on the wire is stamped ``(epoch, ci, payload)``.  The
deployment epoch is what a recovery bumps (the elastic slice's work), so a
consumer discards records left over from an older stream (stale epoch) and
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

    def close(self) -> None:
        pass


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
    """A transport by name: ``"inprocess"``, ``"pipe"`` or ``"device"``.
    ``coalesce_bytes=`` is accepted by every kind."""
    if kind == "shm":
        raise NotImplementedError(
            "the shared-memory ring transport ('shm') comes with the next "
            "cluster slice of the port (SharedMemoryRing); use 'pipe' for "
            "process hosts or 'device' for thread hosts on the card")
    kinds = {"inprocess": InProcess, "pipe": MultiProcessPipe,
             "device": DeviceTransport}
    if kind not in kinds:
        raise NetworkError(
            f"unknown transport {kind!r}; pick one of {sorted(kinds)}")
    coalesce = kw.pop("coalesce_bytes", 0)
    t = kinds[kind](**kw)
    if coalesce:
        t.coalesce_bytes = int(coalesce)
    return t
