"""Meshes of ranks, and worlds of local ranks to run them in.

The JAX package's ``launch/mesh.py``.  A :class:`Mesh` names the axes of a
grid of ranks and their sizes; ``shape`` is an ordered ``{axis: size}``
mapping, as on a JAX mesh, so the spec derivation of
:mod:`repro_torch.parallel.sharding` reads it the same way.  The ranks run
SPMD, every rank the same program, as under ``torchrun``.  A mesh binds a
``DeviceMesh`` only inside a world of its size (:meth:`Mesh.device_mesh`),
so :func:`make_production_mesh` gives the shape of a 256- or 512-rank mesh
without a world; running over it raises and names the world it needs.

:func:`run_world` runs a function in a world of ``n`` local ranks: the
port's ``--virtual-devices N`` (the JAX package fakes N XLA host devices
instead).  Its ranks meet through a file in a fresh temporary directory,
never a fixed port.  Ranks on the CPU talk over gloo.  Ranks that share one
card talk over gloo with every CUDA tensor staged through host memory (the
``hoststaged`` backend of :mod:`repro_torch.parallel.collectives`): NCCL
refuses two ranks of one communicator on one GPU.  With one card per rank
(:func:`run_world`'s ``backend="nccl"``) the same code takes NCCL.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree

__all__ = ["Mesh", "make_production_mesh", "make_mesh", "serve_rules",
           "train_rules", "run_world", "world_backend", "fake_world"]


class Mesh:
    """A named grid of ranks: ``shape`` maps each axis to its size in
    order, ``axis_names`` and ``size`` as on a JAX mesh.  ``device`` is the
    device type each rank computes on (``None``: the card)."""

    def __init__(self, shape, axes, *, device=None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh: {len(shape)} sizes for axes {axes}")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.size = math.prod(shape)
        self._device = device
        self._dm = None

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    @property
    def device(self) -> torch.device:
        from ..device import resolve_device
        return resolve_device(self._device)

    def in_world(self) -> bool:
        """Is this process a rank of a world of exactly ``size`` ranks?"""
        import torch.distributed as dist
        return dist.is_initialized() and dist.get_world_size() == self.size

    def device_mesh(self):
        """The ``DeviceMesh`` over the ranks of the running world; raises
        unless a world of exactly ``size`` ranks is up."""
        import torch.distributed as dist
        if self._dm is None:
            if not self.in_world():
                world = dist.get_world_size() if dist.is_initialized() else 1
                raise RuntimeError(
                    f"mesh {self.shape} needs a world of {self.size} ranks, "
                    f"this process is in one of {world} "
                    "(repro_torch.launch.mesh.run_world starts one)")
            from torch.distributed.device_mesh import DeviceMesh
            grid = torch.arange(self.size).reshape(tuple(self.shape.values()))
            self._dm = DeviceMesh(self.device.type, grid,
                                  mesh_dim_names=self.axis_names)
        return self._dm

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh().get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh().get_group(axis)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production target's mesh: 16×16 ``data × model`` (256 ranks), or
    2×16×16 ``pod × data × model`` (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, *, device=None) -> Mesh:
    """Arbitrary mesh (tests, examples, elastic re-mesh)."""
    return Mesh(shape, axes, device=device)


def train_rules(seq_shard: bool = False, fsdp: bool = False,
                tp: bool = True):
    """seq_shard: Megatron-style sequence parallelism on activations;
    fsdp: ZeRO-3 weight sharding over the data axis (weights gather at
    use); tp=False: no tensor parallelism (heads/ff replicated)."""
    from ..parallel.axes import ShardingRules
    return ShardingRules(
        seq="model" if seq_shard else None,
        d="data" if fsdp else None,
        heads="model" if tp else None,
        ff="model" if tp else None,
    )


def serve_rules(*, kv_seq_shard: bool = True):
    """Decode: shard the KV-cache sequence over 'model' (flash-decoding
    style)."""
    from ..parallel.axes import ShardingRules
    return ShardingRules(kv_seq="model" if kv_seq_shard else None)


# --------------------------------------------------------------------------
# worlds of local ranks
# --------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a world of ``n`` ranks over the ``fake``
    backend: collectives return at once and move nothing, so a
    ``DeviceMesh`` of any size comes up (each axis its sub-groups) and
    ``DTensor`` gives rank 0's shards.  Refuses when a process group is
    already up; destroys its own on exit, also after an error."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            f"fake_world({n}): a process group of "
            f"{dist.get_world_size()} ranks is already up in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _forget_meshes()


def _forget_meshes() -> None:
    """Empty ``DTensor``'s caches of sharding propagations (the Python one
    and, where the running torch has it, the native one).  Their entries
    hold the ``DeviceMesh`` they were made on, and a mesh of a later world
    of the same shape compares equal to it, so a hit would hand back a mesh
    whose process groups are gone."""
    from torch.distributed.tensor import DTensor
    DTensor._op_dispatcher.sharding_propagator \
        .propagate_op_sharding.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()


def world_backend(device_type: str) -> str:
    """The backend of a world whose ranks compute on ``device_type`` and
    share one host: gloo on the CPU; for ranks that share the card, gloo
    with each CUDA tensor staged through host memory
    (:class:`repro_torch.parallel.collectives.HostStagedGroup`), since
    NCCL refuses two ranks of one communicator on one GPU."""
    return "gloo" if device_type == "cpu" else "hoststaged"


def _host_tree(tree):
    return pytree.tree_map(
        lambda l: l.detach().cpu() if isinstance(l, torch.Tensor) else l,
        tree)


def _rank_main(fn, rank: int, n: int, init: str, backend: str,
               device_type: str, timeout: float, args: tuple, out) -> None:
    import faulthandler

    import torch.distributed as dist
    faulthandler.enable()  # a rank that crashes prints where
    torch.set_num_threads(1)
    try:
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: no CUDA device")
            torch.cuda.set_device(0 if backend != "nccl"
                                  else rank % torch.cuda.device_count())
        if backend == "hoststaged":
            from ..parallel.collectives import register_host_staged
            register_host_staged()
        dist.init_process_group(
            backend, init_method=init, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            res = _host_tree(fn(rank, *args))
        finally:
            dist.destroy_process_group()
        out.put((rank, True, pickle.dumps(res)))
    except BaseException:  # reported to the parent, which fails the world
        out.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn: Callable, n: int, *args, device=None,
              backend: Optional[str] = None, timeout: float = 60.0,
              join_timeout: float = 600.0) -> list:
    """``[fn(rank, *args) for rank in range(n)]``, each call in its own
    spawned process, all in one ``torch.distributed`` world of ``n`` ranks.

    ``fn`` is a module-level function (it is pickled to each rank); its
    result comes back with its tensors on the CPU.  ``device`` is where the
    ranks compute (``None``: the card, as for every entry point of the
    port, which raises here and in each rank where there is none; "cpu"
    on request).  Collectives time out after ``timeout``
    seconds.  If a rank fails or the world outlives ``join_timeout``, every
    rank is killed and a ``RuntimeError`` carries the failing rank's
    traceback.  No rank process outlives the call."""
    from ..device import resolve_device
    device_type = resolve_device(device).type
    backend = backend or world_backend(device_type)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_world_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    procs = []
    try:
        os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        for r in range(n):
            p = ctx.Process(target=_rank_main, name=f"rank{r}",
                            args=(fn, r, n, init, backend, device_type,
                                  timeout, args, out), daemon=True)
            p.start()
            procs.append(p)
        results: dict[int, Any] = {}
        deadline = time.monotonic() + join_timeout
        while len(results) < n:
            try:
                rank, ok, payload = out.get(timeout=0.2)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and all(p.exitcode is not None for p in dead):
                    # a rank that died without a word (killed, segfault)
                    time.sleep(0.5)
                    if out.empty():
                        raise RuntimeError(
                            f"world of {n}: {dead[0].name} exited with "
                            f"code {dead[0].exitcode}")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"world of {n}: no result after {join_timeout} s "
                        f"(ranks done: {sorted(results)})")
                continue
            if not ok:
                raise RuntimeError(f"world of {n}: rank {rank} failed:\n"
                                   f"{payload}")
            results[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [results[r] for r in range(n)]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        out.close()
        out.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
