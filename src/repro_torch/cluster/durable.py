"""Durable deployments: on-disk state for a :class:`ClusterDeployment`.

A deployment's durable state has two halves, both written through
:class:`..train.checkpoint.Checkpointer` (manifest + async write +
crash-atomic ``os.replace`` rename-last semantics, ``keep=N`` GC):

* **controller meta** (``<root>/meta``) — the epoch-stamped plan
  assignment, the picklable ``ExecConfig``, the undelivered-chunk ledger
  (``_kept``), the pending-batch descriptor and cached per-host results.
  Written by the controller at batch boundaries and around every
  recovery, so a brand-new controller process can
  :meth:`ClusterDeployment.adopt` the deployment.
* **per-host fold snapshots** (``<root>/host_<h>``) — each executor's
  accumulator/fold state (``jit_accs``/``host_accs``/``_combine_carry``)
  plus the chunk index it covers, written by the *host* at the stream's
  snapshot cadence.  ``recover()`` replays a long batch from the last
  snapshot instead of chunk 0.

Arbitrary host-side accumulators (ints, lists, nested pytrees) do not fit
a fixed ``restore(like=...)`` structure, so state rides as a single
pickled uint8 leaf — the Checkpointer still provides atomicity, the
LATEST pointer, GC and the corrupt-latest fallback.  Every tensor is moved
to the CPU before it is pickled (:func:`to_host`): a snapshot names no
device, so a process without a card, or with another card index, reads
it; whoever resumes from it puts the tensors back on its own device.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..train.checkpoint import Checkpointer

__all__ = ["DeploymentStore", "DurabilityEvent", "to_host", "reclaim"]

_BLOB_LIKE = {"blob": np.zeros((0,), np.uint8)}


def _to_blob(obj: Any) -> dict:
    return {"blob": np.frombuffer(pickle.dumps(obj), np.uint8).copy()}


def _from_blob(tree: dict) -> Any:
    return pickle.loads(np.asarray(tree["blob"]).tobytes())


def to_host(tree: Any) -> Any:
    """Every tensor leaf on the CPU (``.detach().cpu()``, which waits for
    the card's pending writes to it), so fold state pickles portably;
    host-side accumulator leaves (ints, lists, numpy arrays, ...) pass
    through untouched."""
    return pytree.tree_map(
        lambda l: l.detach().cpu() if isinstance(l, torch.Tensor) else l,
        tree)


def reclaim(named: dict) -> tuple[int, int]:
    """Unlink the named semaphores and ``/dev/shm`` segments a dead
    deployment left behind (``named``: ``{"controller_pid", "sem",
    "shm"}`` as its controller recorded them).  A process killed without a
    clean close cannot unlink them itself, and every crash would strand
    more.  Nothing is touched while that controller's process still
    lives.  Returns how many semaphores and segments were unlinked."""
    pid = named.get("controller_pid")
    if pid is None:
        return 0, 0
    try:
        os.kill(pid, 0)
        return 0, 0  # still alive: its objects are in use
    except ProcessLookupError:
        pass
    except PermissionError:
        return 0, 0  # someone else's process has that id now
    import _multiprocessing
    from multiprocessing import shared_memory
    sems = shms = 0
    for name in named.get("sem", ()):
        try:
            _multiprocessing.sem_unlink(name)
            sems += 1
        except OSError:
            pass  # unlinked at a clean exit
    for name in named.get("shm", ()):
        try:
            seg = shared_memory.SharedMemory(name=name)
        except OSError:
            continue
        seg.close()
        seg.unlink()
        shms += 1
    return sems, shms


@dataclasses.dataclass
class DurabilityEvent:
    """One snapshot / restore / adopt action, rendered by
    :func:`..core.netlog.cluster_report` next to recovery events."""

    kind: str                 # "snapshot" | "restore" | "adopt"
    epoch: int
    step: int                 # checkpointer step the action wrote/read
    hosts: dict = dataclasses.field(default_factory=dict)  # host -> chunk
    note: str = ""

    def describe(self) -> str:
        bits = [f"{self.kind} (epoch {self.epoch}, step {self.step})"]
        if self.hosts:
            at = ", ".join(f"host {h}@chunk {self.hosts[h]}"
                           for h in sorted(self.hosts))
            bits.append(at)
        if self.note:
            bits.append(self.note)
        return "; ".join(bits)


class DeploymentStore:
    """Filesystem layout + (de)serialisation for one deployment's state."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._meta = Checkpointer(os.path.join(root, "meta"), keep=keep,
                                  async_save=True)
        self._serve: Optional[Checkpointer] = None

    # -- controller meta ------------------------------------------------------
    def save_meta(self, step: int, state: dict) -> int:
        """Enqueue a meta write (async); returns its bytes.  Call
        :meth:`flush` afterwards when a reader in another store instance
        must observe it — the write-ahead batch record skips that (losing
        it to a crash only costs the replay, never correctness)."""
        blob = _to_blob(state)
        self._meta.save(step, blob)
        return blob["blob"].nbytes

    def flush(self) -> None:
        """Block until every enqueued meta write is durably renamed."""
        self._meta.wait()

    def load_meta(self) -> Optional[dict]:
        self._meta.wait()  # same-instance readers see their own writes
        try:
            _, tree = self._meta.restore(_BLOB_LIKE, device="cpu")
        except FileNotFoundError:
            return None
        return _from_blob(tree)

    def meta_step(self) -> Optional[int]:
        self._meta.wait()
        return self._meta.latest_step()

    # -- per-host fold snapshots ----------------------------------------------
    def host_dir(self, host: int) -> str:
        return os.path.join(self.root, f"host_{host}")

    def host_checkpointer(self, host: int, *,
                          async_save: bool = True) -> Checkpointer:
        return Checkpointer(self.host_dir(host), keep=2,
                            async_save=async_save)

    def load_host_snapshot(self, host: int) -> Optional[dict]:
        """Latest complete fold snapshot for ``host`` (corrupt-latest falls
        back to the previous step via the Checkpointer), or None."""
        if not os.path.isdir(self.host_dir(host)):
            return None
        ckpt = Checkpointer(self.host_dir(host), keep=2)
        try:
            _, tree = ckpt.restore(_BLOB_LIKE, device="cpu")
        except (FileNotFoundError, OSError):
            return None
        return _from_blob(tree)

    # -- serve-engine request table -------------------------------------------
    def serve_checkpointer(self) -> Checkpointer:
        # cached: the Checkpointer serialises its async writes internally
        if self._serve is None:
            self._serve = Checkpointer(os.path.join(self.root, "serve"),
                                       keep=self.keep)
        return self._serve

    def save_serve(self, step: int, state: dict) -> int:
        """Write the serving state (synchronously); returns its bytes."""
        blob = _to_blob(state)
        self.serve_checkpointer().save(step, blob)
        return blob["blob"].nbytes

    def load_serve(self) -> Optional[dict]:
        try:
            _, tree = self.serve_checkpointer().restore(_BLOB_LIKE,
                                                        device="cpu")
        except FileNotFoundError:
            return None
        return _from_blob(tree)

    def serve_step(self) -> Optional[int]:
        return self.serve_checkpointer().latest_step()
