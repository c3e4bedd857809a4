"""Data pipeline: the Emit terminal at framework scale.

A :class:`TokenSource` is the paper's Emit process: ``create(i)`` returns
the i-th global batch.  :class:`Prefetcher` is an Emit with a buffered
output channel (a bounded queue and a worker thread), so host batch
synthesis overlaps device compute.  The JAX package's ``data/pipeline.py``:
:class:`SyntheticLM` draws the same numpy integers from the same seed, and
hands them over as tensors on an explicit device (the card by default).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device, to_device

__all__ = ["TokenSource", "SyntheticLM", "Prefetcher", "shard_batch"]


class TokenSource:
    """Interface: ``create(step) -> {"tokens": (B, S) int32, "labels":
    (B, S) int32}``."""

    def create(self, step: int) -> dict:  # pragma: no cover - interface
        raise NotImplementedError


class SyntheticLM(TokenSource):
    """Deterministic synthetic LM stream with learnable structure.

    Tokens follow a noisy periodic pattern so a real model can reduce its
    loss on it; ``labels`` are ``tokens`` shifted by one.  The integers are
    the JAX package's for the same arguments; they land on ``device``
    (``None``: the card) as int32 tensors.
    """

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0,
                 period: int = 7, device=None):
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.seed, self.period = seed, period
        self.device = resolve_device(device)

    def create(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed + step)
        base = rng.integers(0, self.vocab, size=(self.batch, 1))
        t = np.arange(self.seq + 1)[None, :]
        toks = (base + t * t % self.period) % self.vocab
        noise = rng.integers(0, self.vocab, size=toks.shape)
        mask = rng.random(toks.shape) < 0.1
        toks = torch.from_numpy(np.where(mask, noise, toks).astype(np.int32))
        return {"tokens": toks[:, :-1].to(self.device),
                "labels": toks[:, 1:].to(self.device)}


def shard_batch(batch: dict, mesh=None, batch_axes=("pod", "data"),
                device=None) -> dict:
    """Place a host batch on ``device`` (``None``: the card) or, given a
    mesh (inside a world of its ranks), as DTensors sharded over the batch
    axes the mesh has (``batch_specs``: a leaf whose batch does not divide
    them, or a 0-d one, is replicated).  Every rank passes the same whole
    batch and keeps its own rows."""
    if mesh is None:
        return to_device(batch, resolve_device(device))
    from ..parallel.axes import ShardingRules
    from ..parallel.sharding import batch_specs, place, to_shardings
    rules = ShardingRules(batch=batch_axes)
    return place(batch, to_shardings(batch_specs(batch, mesh, rules), mesh))


class Prefetcher:
    """Emit with a buffered channel: background thread + bounded queue.
    Iterating yields ``(step, batch)`` in order, each batch on ``device``
    (or sharded over ``mesh``, :func:`shard_batch`), then stops (the
    universal terminator)."""

    def __init__(self, source: TokenSource, *, mesh=None, depth: int = 2,
                 start_step: int = 0, n_steps: Optional[int] = None,
                 device=None):
        self.source = source
        self.mesh = mesh
        # the source's own device unless one is given (None: the card)
        self.device = resolve_device(
            device if device is not None else getattr(source, "device", None)
            if mesh is None else mesh.device)
        if mesh is not None:  # bind it here, not in the worker thread
            mesh.device_mesh()
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(start_step, n_steps), daemon=True)
        self._thread.start()

    def _run(self, start: int, n: Optional[int]):
        step = start
        while not self._stop.is_set() and (n is None or step < start + n):
            batch = shard_batch(self.source.create(step), self.mesh,
                                device=self.device)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1
        self.q.put(None)  # UniversalTerminator

    def __iter__(self) -> Iterator:
        while True:
            item = self.q.get()
            if item is None:  # UT
                return
            yield item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
