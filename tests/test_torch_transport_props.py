"""Property tests of the port's transports: pack/unpack round-trips, the
epoch protocol, coalescing, and drain/requeue losslessness — across
``inprocess``, ``pipe``, ``shm`` and ``device``, mirroring the JAX
package's ``tests/test_transport_props.py`` with torch leaves (bfloat16
and 0-d tensors included) beside numpy ones.

Runs through ``tests/_hypothesis_compat.py``: with hypothesis installed
these are real property sweeps; without it ``@given`` degrades to a
deterministic boundary grid.  Nothing here spawns a process: the
``pipe`` and ``shm`` transports are driven from this one, through their
real ``multiprocessing`` queues and ``/dev/shm`` slots.
"""

import random
import time

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro_torch.cluster.transport import (EOS, DeviceTransport, InProcess,
                                           MultiProcessPipe,
                                           SharedMemoryRing, _PipeEndpoint,
                                           _RawLeaf, pack_raw, unpack_raw)

_TORCH_DTYPES = ["float32", "bfloat16", "float16", "float64", "int8",
                 "int32", "int64", "uint8", "bool"]
_NP_DTYPES = ["<f4", ">f4", "<f8", ">i2", "<i8", ">u4", "bool"]
_SHAPES = [(), (1,), (3,), (0,), (2, 3), (0, 4), (4, 1, 2)]
_TRANSPORTS = ["inprocess", "pipe", "shm", "device"]
CHAN = ("a", "b")


def _make_tensor(dtype: str, shape: tuple, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    if dt == torch.bool:
        return torch.randint(0, 2, shape, generator=g).bool()
    if not dt.is_floating_point:
        return torch.randint(0, 100, shape, generator=g).to(dt)
    return torch.randn(shape, generator=g).to(dt)


def _make_array(dtype: str, shape: tuple, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    dt = np.dtype(dtype)
    if dt == np.bool_:
        a = rng.integers(0, 2, size=n).astype(bool)
    elif dt.kind in "iu":
        a = rng.integers(0, 100, size=n).astype(dt)
    else:
        a = rng.standard_normal(n).astype(dt)
    return a.reshape(shape)


def _same_tensor(got, want) -> bool:
    return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
            and got.shape == want.shape and torch.equal(got, want))


def _mk_transport(kind: str):
    if kind == "inprocess":
        return InProcess()
    if kind == "pipe":
        return MultiProcessPipe()
    if kind == "shm":
        return SharedMemoryRing(slot_bytes=1 << 12)
    return DeviceTransport()  # unbound: the CPU, as with device="cpu"


def _payload(ci: int):
    return {"v": torch.full((3,), float(ci)),
            "h": torch.tensor(float(ci), dtype=torch.bfloat16)}


def _check(got, ci: int) -> None:
    want = _payload(ci)
    assert _same_tensor(got["v"], want["v"])
    assert _same_tensor(got["h"], want["h"])  # 0-d bf16 survives


def _fifo_len(t, chan) -> int:
    if isinstance(t, SharedMemoryRing):
        return t._rings[chan].data_q.qsize()
    return t._queues[chan].qsize()


def _settle(t, chan, n: int) -> None:
    """mp queues publish through a feeder thread: wait until the FIFO
    really holds ``n`` records, so the model and the transport agree on
    what drain sees."""
    deadline = time.monotonic() + 5.0
    while _fifo_len(t, chan) != n and time.monotonic() < deadline:
        time.sleep(0.005)
    assert _fifo_len(t, chan) == n


class TestPackRoundTripProperties:
    """``pack_raw``/``unpack_raw`` — what the pipe ships and the ring's
    inline path carries — over torch dtypes (bf16 included), numpy byte
    orders, 0-d and empty shapes."""

    @given(dtype=st.sampled_from(_TORCH_DTYPES),
           shape=st.sampled_from(_SHAPES), seed=st.integers(0, 7))
    @settings(max_examples=40, deadline=None)
    def test_tensor_roundtrip(self, dtype, shape, seed):
        t = _make_tensor(dtype, shape, seed)
        packed = pack_raw({"x": t})
        assert isinstance(packed["x"], _RawLeaf)
        assert _same_tensor(unpack_raw(packed)["x"], t)

    @given(dtype=st.sampled_from(_NP_DTYPES), shape=st.sampled_from(_SHAPES),
           seed=st.integers(0, 7))
    @settings(max_examples=40, deadline=None)
    def test_pipe_endpoint_roundtrip(self, dtype, shape, seed):
        """The exact _pack/_unpack pair a pipe endpoint applies, with
        numpy and torch leaves side by side and a transposed view."""
        ep = _PipeEndpoint({})
        a = _make_array(dtype, shape, seed)
        t = torch.from_numpy(np.ascontiguousarray(a).astype(
            a.dtype.newbyteorder("=")))
        out = ep._unpack(ep._pack({"x": a, "nested": (a, a.T), "t": t}))
        for got, want in ((out["x"], a), (out["nested"][0], a),
                          (out["nested"][1], a.T)):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == np.ascontiguousarray(want).tobytes()
        assert _same_tensor(out["t"], t)

    @given(nbytes=st.sampled_from([0, 8, 63, 64, 65, 256, 4096]),
           seed=st.integers(0, 3))
    @settings(max_examples=30, deadline=None)
    def test_shm_oversize_inline(self, nbytes, seed):
        """Chunks larger than slot_bytes ship inline through the header
        queue: bit-identical either way, counted by path, and the ring
        never leaks a slot."""
        t = SharedMemoryRing(slot_bytes=64)
        try:
            t.setup([CHAN], {CHAN: 2})
            x = _make_tensor("bfloat16", (nbytes // 2,), seed)
            t.send(CHAN, 0, {"x": x})
            assert _same_tensor(t.recv(CHAN, 0)["x"], x)
            fits = x.numel() * x.element_size() <= 64
            assert t.ring_counts()[CHAN] == ((1, 0) if fits else (0, 1))
            assert t._rings[CHAN].free_q.qsize() == 2
        finally:
            t.close()

    @given(dtype=st.sampled_from(_TORCH_DTYPES),
           shape=st.sampled_from(_SHAPES), seed=st.integers(0, 7))
    @settings(max_examples=40, deadline=None)
    def test_shm_slot_roundtrip(self, dtype, shape, seed):
        """Through a slot: same bits, dtype and shape (0-d stays 0-d), a
        writable tensor that does not alias the slot."""
        t = SharedMemoryRing(slot_bytes=1 << 12)
        try:
            t.setup([CHAN], {CHAN: 1})
            x = _make_tensor(dtype, shape, seed)
            t.send(CHAN, 0, (x, x.t() if x.ndim == 2 else x))
            got = t.recv(CHAN, 0)
            assert _same_tensor(got[0], x)
            assert _same_tensor(got[1], x.t() if x.ndim == 2 else x)
            if x.numel():
                got[0].view(-1)[0] = got[0].view(-1)[-1]  # writable
            t.send(CHAN, 1, torch.zeros_like(x))  # reuses the one slot
            t.recv(CHAN, 1)
            assert t.ring_counts()[CHAN] == (2, 0)
        finally:
            t.close()


class TestEpochProtocolProperty:
    """For any interleaving of send / duplicate-send / drain / requeue /
    epoch-bump, recv never yields a stale-epoch or duplicate
    ``(epoch, ci)`` record — checked against an exact model of the FIFO,
    on all four transports."""

    @given(kind=st.sampled_from(_TRANSPORTS), seed=st.integers(0, 9))
    @settings(max_examples=40, deadline=None)
    def test_interleavings_never_deliver_stale_or_duplicate(self, kind,
                                                            seed):
        rng = random.Random(seed)
        cap = 8
        t = _mk_transport(kind)
        try:
            t.setup([CHAN], {CHAN: cap})
            pending = []      # model of the FIFO: [(epoch, ci), ...]
            send_ci = 0       # producer's next fresh chunk
            expect_ci = 0     # consumer's next expected chunk
            delivered = set()  # every (epoch, ci) recv handed out
            for _ in range(rng.randrange(8, 20)):
                op = rng.choice(("send", "send", "send", "dup", "recv",
                                 "recv", "bump", "discard"))
                if op == "send" and len(pending) < cap:
                    t.send(CHAN, send_ci, _payload(send_ci))
                    pending.append((t.epoch, send_ci))
                    send_ci += 1
                elif op == "dup" and expect_ci > 0 and len(pending) < cap:
                    ci = rng.randrange(expect_ci)  # replayed duplicate
                    t.send(CHAN, ci, _payload(ci))
                    pending.append((t.epoch, ci))
                elif op == "recv":
                    live = [(e, c) for e, c in pending
                            if e == t.epoch and c >= expect_ci]
                    if not (live and live[0][1] == expect_ci):
                        continue  # recv would block on the FIFO
                    _check(t.recv(CHAN, expect_ci), expect_ci)
                    rec = (t.epoch, expect_ci)
                    assert rec not in delivered, f"duplicate {rec}"
                    delivered.add(rec)
                    pending = pending[pending.index(rec) + 1:]
                    expect_ci += 1
                elif op in ("bump", "discard"):
                    _settle(t, CHAN, len(pending))
                    keep = {CHAN} if op == "bump" else frozenset()
                    drained = t.drain([CHAN], keep=keep)[CHAN][0]
                    want = [c for _, c in pending] if op == "bump" else []
                    assert [ci for ci, _ in drained] == want  # FIFO order
                    t.set_epoch(t.epoch + 1)
                    pending = []
                    if op == "bump" and drained:
                        assert t.requeue(CHAN, drained) == len(drained)
                        pending = [(t.epoch, ci) for ci, _ in drained]
                        expect_ci = min(ci for ci, _ in drained)
            assert all(e <= t.epoch for e, _ in delivered)
        finally:
            t.close()

    @pytest.mark.parametrize("kind", _TRANSPORTS)
    def test_future_epoch_is_a_protocol_error(self, kind):
        from repro_torch.cluster.transport import TransportError
        t = _mk_transport(kind)
        try:
            t.setup([CHAN], {CHAN: 4})
            t.set_epoch(3)
            t.send(CHAN, 0, _payload(0))
            t.set_epoch(2)  # the consumer behind the controller
            with pytest.raises(TransportError, match="epoch"):
                t.recv(CHAN, 0)
        finally:
            t.close()


class TestCoalescingProperties:
    """The batching fast path is protocol-invisible: same records in the
    same order, EOS and epoch bumps flush the buffer, and drain/requeue
    stay lossless over partially-coalesced state."""

    @given(kind=st.sampled_from(["pipe", "shm"]),
           dtype=st.sampled_from(_TORCH_DTYPES),
           shape=st.sampled_from(_SHAPES), seed=st.integers(0, 5))
    @settings(max_examples=40, deadline=None)
    def test_batched_roundtrip(self, kind, dtype, shape, seed):
        t = _mk_transport(kind)
        t.coalesce_bytes = 1 << 12
        try:
            t.setup([CHAN], {CHAN: 8})
            xs = [_make_tensor(dtype, shape, seed + i) for i in range(5)]
            for ci, x in enumerate(xs):
                t.send(CHAN, ci, {"x": x, "pair": (x, x)})
            t.flush_sends()
            for ci, x in enumerate(xs):
                got = t.recv(CHAN, ci)
                for g in (got["x"], *got["pair"]):
                    assert _same_tensor(g, x)
            assert _fifo_len(t, CHAN) == 0
        finally:
            t.close()

    @given(kind=st.sampled_from(_TRANSPORTS), seed=st.integers(0, 9))
    @settings(max_examples=30, deadline=None)
    def test_eos_flushes_pending(self, kind, seed):
        k = random.Random(seed).randrange(1, 6)
        t = _mk_transport(kind)
        t.coalesce_bytes = 1 << 12  # nothing auto-flushes before the EOS
        try:
            t.setup([CHAN], {CHAN: 8})
            for ci in range(k):
                t.send(CHAN, ci, _payload(ci))
            t.send(CHAN, k, EOS)
            for ci in range(k):
                _check(t.recv(CHAN, ci), ci)
            assert t.recv(CHAN, k) == EOS
        finally:
            t.close()

    @given(kind=st.sampled_from(_TRANSPORTS), seed=st.integers(0, 9))
    @settings(max_examples=30, deadline=None)
    def test_epoch_bump_flushes_under_old_epoch(self, kind, seed):
        k = random.Random(seed).randrange(1, 5)
        t = _mk_transport(kind)
        t.coalesce_bytes = 1 << 12
        try:
            t.setup([CHAN], {CHAN: 8})
            for ci in range(k):  # abandoned epoch-1 records, buffered
                t.send(CHAN, ci, {"v": torch.full((3,), -1.0),
                                  "h": torch.tensor(-1.0,
                                                    dtype=torch.bfloat16)})
            assert _fifo_len(t, CHAN) == 0
            t.set_epoch(2)  # the bump flushes them stamped epoch 1
            _settle(t, CHAN, 1)
            for ci in range(k):  # the replay, under epoch 2
                t.send(CHAN, ci, _payload(ci))
            t.flush_sends()
            for ci in range(k):  # the stale batch is dropped silently
                _check(t.recv(CHAN, ci), ci)
        finally:
            t.close()

    @given(kind=st.sampled_from(_TRANSPORTS), seed=st.integers(0, 9))
    @settings(max_examples=30, deadline=None)
    def test_drain_sweeps_partial_coalesce_buffer(self, kind, seed):
        rng = random.Random(seed)
        t = _mk_transport(kind)
        t.coalesce_bytes = 1 << 12
        try:
            t.setup([CHAN], {CHAN: 8})
            k = rng.randrange(2, 7)
            j = rng.randrange(0, k)  # flushed prefix; the rest stays local
            for ci in range(j):
                t.send(CHAN, ci, _payload(ci))
            if j:
                t.flush_sends()
                _settle(t, CHAN, 1)
            for ci in range(j, k):
                t.send(CHAN, ci, _payload(ci))
            kept, dropped = t.drain([CHAN], keep={CHAN})[CHAN]
            assert [ci for ci, _ in kept] == list(range(k)) and dropped == 0
            t.set_epoch(2)
            assert t.requeue(CHAN, kept) == k
            for ci in range(k):  # exactly once, in order
                _check(t.recv(CHAN, ci), ci)
            assert _fifo_len(t, CHAN) == 0
        finally:
            t.close()

    @given(n=st.integers(10, 60), nbytes=st.integers(1, 63),
           seed=st.integers(0, 5))
    @settings(max_examples=30, deadline=None)
    def test_shm_many_small_records_fit_or_go_one_by_one(self, n, nbytes,
                                                         seed):
        """Many records under 64 bytes, coalesced against a tight slot and
        flushed by EOS: a batch is sized as the ring lays it out (each leaf
        on a 64-byte boundary), so one that does not fit ships record by
        record.  Every record arrives, each through a slot, and every slot
        comes back."""
        cap, slot = 64, 1024
        t = SharedMemoryRing(slot_bytes=slot)
        t.coalesce_bytes = slot
        try:
            t.setup([CHAN], {CHAN: cap})
            xs = [_make_tensor("uint8", (nbytes,), seed + i)
                  for i in range(n)]
            for ci, x in enumerate(xs):
                t.send(CHAN, ci, x)
            t.send(CHAN, n, EOS)
            for ci, x in enumerate(xs):
                assert _same_tensor(t.recv(CHAN, ci), x)
            assert t.recv(CHAN, n) == EOS
            assert t.ring_counts()[CHAN] == (n, 0)
            assert t._rings[CHAN].free_q.qsize() == cap
        finally:
            t.close()

    def test_shm_failed_write_returns_its_slot(self, monkeypatch):
        """A write into a slot that raises hands the slot back: the ring
        keeps its capacity and the next send goes through."""
        from repro_torch.cluster import transport as tr
        t = SharedMemoryRing(slot_bytes=1 << 12)
        try:
            t.setup([CHAN], {CHAN: 2})
            real = tr._write_slot

            def broken(buf, tree):
                raise ValueError("write failed")
            monkeypatch.setattr(tr, "_write_slot", broken)
            with pytest.raises(ValueError, match="write failed"):
                t.send(CHAN, 0, _payload(0))
            assert t._rings[CHAN].free_q.qsize() == 2
            monkeypatch.setattr(tr, "_write_slot", real)
            t.send(CHAN, 0, _payload(0))
            _check(t.recv(CHAN, 0), 0)
        finally:
            t.close()


class TestDrainRequeueLosslessness:
    """Every undelivered chunk reappears exactly once under the new epoch;
    nothing is delivered twice, nothing is lost."""

    @given(kind=st.sampled_from(_TRANSPORTS), seed=st.integers(0, 9))
    @settings(max_examples=40, deadline=None)
    def test_undelivered_chunks_survive_exactly_once(self, kind, seed):
        rng = random.Random(seed)
        cap = rng.randrange(4, 9)
        k = rng.randrange(1, cap + 1)       # chunks sent
        j = rng.randrange(0, k + 1)         # chunks the consumer folded
        t = _mk_transport(kind)
        try:
            t.setup([CHAN], {CHAN: cap})
            for ci in range(k):
                t.send(CHAN, ci, _payload(ci))
            for ci in range(j):
                _check(t.recv(CHAN, ci), ci)
            _settle(t, CHAN, k - j)
            kept, dropped = t.drain([CHAN], keep={CHAN})[CHAN]
            assert [ci for ci, _ in kept] == list(range(j, k))
            assert dropped == 0
            t.set_epoch(2)
            assert t.requeue(CHAN, kept) == k - j
            for ci in range(j, k):
                _check(t.recv(CHAN, ci), ci)
            assert _fifo_len(t, CHAN) == 0
            if kind == "shm":  # every slot back on the ring
                assert t._rings[CHAN].free_q.qsize() == cap
        finally:
            t.close()


class TestThreadEndpoints:
    """Thread transports hand each host its own endpoint over the shared
    FIFOs; the device transport's placement survives the move."""

    @pytest.mark.parametrize("kind", ["inprocess", "device"])
    def test_endpoints_distinct_stable_share_fifos(self, kind):
        t = _mk_transport(kind)
        try:
            t.setup([CHAN], {CHAN: 4})
            ep0, ep1 = t.endpoint(0), t.endpoint(1)
            assert ep0 is not ep1 and t.endpoint(0) is ep0
            assert ep0._queues is t._queues
            ep0.send(CHAN, 0, _payload(0))
            _check(ep1.recv(CHAN, 0), 0)
        finally:
            t.close()

    def test_device_endpoint_send_places_on_the_consumer(self):
        t = DeviceTransport()
        t.coalesce_bytes = 1 << 12
        try:
            t.setup([CHAN], {CHAN: 4})
            t.bind({CHAN: torch.device("cpu")})
            ep = t.endpoint(0)
            ep.send(CHAN, 0, {"v": torch.arange(3.0, dtype=torch.float64)})
            ep.flush_sends()
            got = t.endpoint(1).recv(CHAN, 0)["v"]
            assert got.device.type == "cpu" and torch.equal(
                got, torch.arange(3.0, dtype=torch.float64))
        finally:
            t.close()
