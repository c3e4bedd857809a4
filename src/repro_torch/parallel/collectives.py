"""Connector-semantics collectives + gradient compression, over a mesh.

The JAX package's ``parallel/collectives.py``.  The GPP connector taxonomy
maps onto collectives of the ranks along one mesh axis; these helpers name
that mapping explicitly so distributed code reads like the paper's
networks:

    spread_fan   → block of the batch (:func:`block`, no communication)
    cast         → replication
    merge        → ordered all-gather (:func:`merge_gather`)
    combine      → all-reduce (:func:`combine_psum`, only where the
                   reference itself names a psum: a fold over the batch
                   is a gather, then the fold in item order)
    ppermute     → point-to-point sends (:func:`ppermute`)

Every rank runs the same program (SPMD); ``mesh`` is a
:class:`repro_torch.launch.mesh.Mesh` inside a world of its size, ``axis``
one of its axes or a tuple of them.

Gradient compression: :func:`psum_bf16` (a bf16 all-reduce) and
:func:`ring_allreduce_int8` (a ring reduce-scatter + all-gather whose every
hop carries blockwise-int8 payloads + f32 scales, with the error-feedback
residue returned to the caller).

**Transport.**  Over NCCL every collective goes as it is, and so does a
CPU tensor over gloo.  Ranks that share one card cannot take NCCL (it
refuses two ranks of one communicator on one GPU), and gloo on CUDA
tensors writes a sent CUDA pointer as if it were host memory and crashes
in the functional collectives that ``DTensor`` runs.  Such a world runs
the ``hoststaged`` backend (:class:`HostStagedGroup`): a process group
over gloo that copies each CUDA tensor to host memory, runs gloo's
collective on the copy and copies the result back — the one place where a
CUDA collective is staged through the host.  :data:`STATS` counts each
kind of collective of these helpers and its bytes, and, under
``staged:<op>``, each collective the backend staged: its output bytes and
the bytes it copied between the card and the host (:func:`stats`,
:func:`reset_stats`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["merge_gather", "combine_psum", "psum_bf16", "quantize_int8",
           "dequantize_int8", "ring_allreduce_int8", "ppermute", "block",
           "broadcast", "stats", "reset_stats", "HostStagedGroup",
           "register_host_staged"]

STATS: dict[str, dict[str, int]] = {}


def stats() -> dict:
    """``{kind: {"calls", "bytes", "staged_bytes"}}`` since the last
    :func:`reset_stats`, in this process."""
    return {k: dict(v) for k, v in STATS.items()}


def reset_stats() -> None:
    STATS.clear()


def _count(kind: str, nbytes: int, staged: int = 0) -> None:
    s = STATS.setdefault(kind, {"calls": 0, "bytes": 0, "staged_bytes": 0})
    s["calls"] += 1
    s["bytes"] += nbytes
    s["staged_bytes"] += staged


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _axes(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def _index(mesh, axis) -> tuple[int, int]:
    """(this rank's linear index along ``axis``, the axis' size)."""
    idx, size = 0, 1
    for a in _axes(axis):
        idx = idx * mesh.shape[a] + mesh.coord(a)
        size *= mesh.shape[a]
    return idx, size


def block(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` when ``x`` is sharded over
    ``axis`` (block sharding, the first rank the first block)."""
    idx, n = _index(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"block: dim {dim} of {tuple(x.shape)} does not "
                         f"split into {n} blocks")
    m = x.shape[dim] // n
    return x.narrow(dim, idx * m, m)


def _gather_one(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    _count("all_gather", _nbytes(src) * n)
    return torch.cat(outs, dim=dim)


def merge_gather(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    """GPP merge reducer (ListSeqOne): the blocks of the ranks along
    ``axis`` concatenated on ``dim`` in rank order."""
    for a in reversed(_axes(axis)):  # inner axis first: row-major blocks
        x = _gather_one(x, mesh.group(a), dim)
    return x


def combine_psum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """GPP CombineNto1 with an additive combine: the sum over the ranks
    along ``axis`` (a new tensor)."""
    out = x.detach().clone()
    for a in _axes(axis):
        dist.all_reduce(out, group=mesh.group(a))
        _count("all_reduce", _nbytes(out))
    return out


def psum_bf16(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """2×-compressed all-reduce: bf16 payload, result in ``x``'s dtype."""
    return combine_psum(x.to(torch.bfloat16), mesh, axis).to(x.dtype)


def broadcast(x: torch.Tensor, mesh, axis, src: int) -> torch.Tensor:
    """The tensor of the rank at index ``src`` along the single ``axis``,
    on every rank of that line (a new tensor)."""
    group = mesh.group(axis)
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    _count("broadcast", _nbytes(out))
    return out


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: list[tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: the rank at index i along ``axis`` sends ``x``
    to index j for each (i, j) in ``perm``; a rank receives its source's
    tensor, or zeros when no pair names it as destination."""
    group = mesh.group(axis)
    me = mesh.coord(axis)
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    payload = x.detach().contiguous()
    recv = torch.zeros_like(payload)
    ops = [dist.P2POp(dist.isend, payload,
                      dist.get_global_rank(group, j), group) for j in dst]
    ops += [dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, i),
                       group) for i in src]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    for _ in dst:
        _count("send", _nbytes(payload))
    return recv


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Blockwise symmetric int8 quantisation.  Returns (q, scales)."""
    blocks = x.reshape(-1, block).float()
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)


def ring_allreduce_int8(x: torch.Tensor, mesh, axis: str, n_shards: int, *,
                        block: int = 256,
                        error: Optional[torch.Tensor] = None):
    """Ring all-reduce with int8+scale payloads on every hop.

    ``x`` is this rank's local gradient (f32, any shape), ``axis`` a mesh
    axis of size ``n_shards``.  Returns (reduced, new_error) where
    new_error is this rank's initial quantisation residue (feed it back
    into the next step's gradient, EF-SGD).  Traffic per rank: 2·(n-1)/n ·
    |x| bytes of int8 (+1/block f32 scales), a 4× cut against f32.
    """
    if mesh.shape[axis] != n_shards:
        raise ValueError(f"ring_allreduce_int8: axis {axis!r} has "
                         f"{mesh.shape[axis]} ranks, not {n_shards}")
    shape = x.shape
    n = x.numel()
    padded = n + ((-n) % (n_shards * block))
    flat = torch.nn.functional.pad(x.reshape(-1).float(), (0, padded - n))
    if error is not None:
        flat = flat + error
    chunks = flat.reshape(n_shards, -1)
    # initial quantisation (the only residue the caller must feed back)
    q0, s0 = quantize_int8(chunks.reshape(-1), block)
    deq0 = dequantize_int8(q0, s0)
    new_error = flat - deq0
    acc = deq0.reshape(n_shards, -1).clone()

    idx = mesh.coord(axis)
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def hop(payload):
        q, s = quantize_int8(payload, block)
        q_r = ppermute(q, mesh, axis, fwd)
        s_r = ppermute(s, mesh, axis, fwd)
        return dequantize_int8(q_r, s_r).reshape(payload.shape)

    # reduce-scatter: after n-1 hops, rank r holds the full sum of chunk r.
    for i in range(n_shards - 1):
        recv = hop(acc[(idx - i) % n_shards])
        acc[(idx - i - 1) % n_shards] += recv
    # all-gather: circulate each completed chunk n-1 hops.
    for i in range(n_shards - 1):
        recv = hop(acc[(idx - i + 1) % n_shards])
        acc[(idx - i) % n_shards] = recv
    out = acc.reshape(-1)[:n].reshape(shape)
    return out.to(x.dtype), new_error.float()


# --------------------------------------------------------------------------
# the host-staged backend: ranks that share one card
# --------------------------------------------------------------------------

def _done(result):
    """A finished ``Work`` whose future holds ``result``."""
    from torch._C._distributed_c10d import _create_work_from_future
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


class HostStagedGroup(dist.ProcessGroup):
    """A process group over gloo for ranks that share one card.

    A CPU tensor goes to gloo as it is.  A CUDA tensor is copied to host
    memory, gloo runs the collective on the copy, and the result is copied
    back before the call returns (the returned ``Work`` is finished).  Each
    staged byte is counted in :data:`STATS` under ``staged:<op>``."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._rank, self._size, self._name = rank, size, ""
        self._gloo = dist.ProcessGroupGloo(
            dist.PrefixStore("hoststaged", store), rank, size, timeout)

    def getBackendName(self) -> str:
        return "hoststaged"

    def setGroupName(self, name: str) -> None:
        self._name = name

    def getGroupName(self) -> str:
        return self._name

    @property
    def group_name(self) -> str:
        return self._name

    def size(self) -> int:
        return self._size

    def rank(self) -> int:
        return self._rank

    @staticmethod
    def _staged(tensors: list) -> bool:
        """Do these tensors cross through host copies?"""
        return any(t.is_cuda for t in tensors)

    def _run(self, op: str, outs: list, ins: list, call, *,
             inplace: bool = False):
        """``call(host_outs, host_ins)`` runs gloo's op; CUDA tensors among
        ``outs``/``ins`` cross through host copies (``outs`` too when the
        op reads them: ``inplace``).  Counts the op's output bytes and the
        bytes copied each way."""
        if not self._staged(outs + ins):
            return call(outs, ins)
        if inplace and self._size == 1:  # a sum or copy over one rank
            return _done(outs)
        h_ins = [t.detach().cpu().clone() for t in ins]
        h_outs = [t.detach().cpu().clone() if inplace
                  else torch.empty_like(t, device="cpu") for t in outs]
        call(h_outs, h_ins).wait()
        for t, h in zip(outs, h_outs):
            t.copy_(h)
        out_bytes = sum(map(_nbytes, outs))
        _count(f"staged:{op}", out_bytes, sum(map(_nbytes, ins))
               + out_bytes * (2 if inplace else 1))
        return _done(outs)

    def allreduce(self, tensors, opts=None):
        opts = opts or dist.AllreduceOptions()
        return self._run("all_reduce", list(tensors), [],
                         lambda o, i: self._gloo.allreduce(o, opts),
                         inplace=True)

    def allreduce_coalesced(self, tensors, opts=None):
        opts = opts or dist.AllreduceCoalescedOptions()
        return self._run("all_reduce", list(tensors), [],
                         lambda o, i: self._gloo.allreduce_coalesced(o, opts),
                         inplace=True)

    def broadcast(self, tensors, opts=None):
        opts = opts or dist.BroadcastOptions()
        return self._run("broadcast", list(tensors), [],
                         lambda o, i: self._gloo.broadcast(o, opts),
                         inplace=True)

    def allgather(self, output_lists, inputs, opts=None):
        opts = opts or dist.AllgatherOptions()
        n = len(output_lists[0])
        flat = [t for lst in output_lists for t in lst]

        def call(o, i):
            return self._gloo.allgather(
                [o[k * n:(k + 1) * n] for k in range(len(i))], i, opts)
        return self._run("all_gather", flat, list(inputs), call)

    def all_gather_single(self, output, input, opts=None):
        return self.allgather([list(output.chunk(self._size))], [input],
                              opts)

    # the names other PyTorch versions call these by
    _allgather_base = all_gather_single

    def all_gather_single_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return _done(outputs)

    allgather_into_tensor_coalesced = all_gather_single_coalesced

    def reduce_scatter(self, outputs, input_lists, opts=None):
        opts = opts or dist.ReduceScatterOptions()
        n = len(input_lists[0])
        flat = [t for lst in input_lists for t in lst]

        def call(o, i):
            return self._gloo.reduce_scatter(
                o, [i[k * n:(k + 1) * n] for k in range(len(o))], opts)
        return self._run("reduce_scatter", list(outputs), flat, call)

    def reduce_scatter_single(self, output, input, opts=None):
        return self.reduce_scatter([output], [list(input.chunk(self._size))],
                                   opts)

    _reduce_scatter_base = reduce_scatter_single

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done(outputs)

    reduce_scatter_tensor_coalesced = reduce_scatter_single_coalesced

    def all_to_all_single(self, output, input, output_split_sizes,
                          input_split_sizes, opts=None):
        opts = opts or dist.AllToAllOptions()
        return self._run(
            "all_to_all", [output], [input],
            lambda o, i: self._gloo.alltoall_base(
                o[0], i[0], output_split_sizes, input_split_sizes, opts))

    alltoall_base = all_to_all_single

    def send(self, tensors, dst: int, tag: int = 0):
        if not self._staged(tensors):
            return self._gloo.send(tensors, dst, tag)
        host = [t.detach().cpu().clone() for t in tensors]
        _count("staged:send", sum(map(_nbytes, host)),
               sum(map(_nbytes, host)))
        return self._gloo.send(host, dst, tag)  # the work holds the copies

    def recv(self, tensors, src: int, tag: int = 0):
        return self._run("recv", list(tensors), [],
                         lambda o, i: self._gloo.recv(o, src, tag))

    def barrier(self, opts=None):
        return self._gloo.barrier(opts or dist.BarrierOptions())


def register_host_staged() -> str:
    """Make the ``hoststaged`` backend known to ``torch.distributed`` in
    this process (each rank calls this before it joins a world); returns
    its name."""
    if "HOSTSTAGED" not in dist.Backend._plugins:
        dist.Backend.register_backend("hoststaged", HostStagedGroup,
                                      devices=["cpu", "cuda"])
    return "hoststaged"
