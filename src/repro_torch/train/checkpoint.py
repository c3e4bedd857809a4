"""Crash-atomic checkpoints of tensor trees, with one async write in flight.

Layout (the JAX package's, so either package reads the other's files)::

    <dir>/step_000123/
        manifest.json        # treedef + leaf dtypes/shapes + step
        leaf_00000.npy ...   # one file per leaf, in the JAX leaf order
    <dir>/LATEST             # atomic pointer (os.replace)

A write goes to ``step_X.tmp`` and is renamed last, so a crash mid-write
never corrupts the restore path; ``restore`` skips a torn latest step and
falls back to the previous complete one.  ``async_save`` copies the tree to
the host first (which waits for the card's pending writes to it), then
writes on a worker thread, so the caller never blocks on disk.

Leaves are torch tensors or numpy arrays.  Dict keys are flattened in
sorted order and ``None`` holds no leaf, as JAX flattens a pytree.
bfloat16 has no numpy type: it is saved as its uint16 bits with
``"bfloat16"`` in the manifest, and viewed back on load.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..device import resolve_device

__all__ = ["Checkpointer"]


def _canonical(tree):
    """``tree`` with every dict's keys in sorted order (JAX's leaf order)."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_canonical(v) for v in tree]
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_canonical(v) for v in tree)
    return tree


def _flatten(tree) -> tuple[list, Any]:
    """Leaves without the ``None`` placeholders, and what rebuilds the tree."""
    leaves, spec = pytree.tree_flatten(_canonical(tree))
    return [l for l in leaves if l is not None], (spec, leaves)


def _unflatten(structure, values: list):
    spec, template = structure
    it = iter(values)
    return pytree.tree_unflatten(
        [None if l is None else next(it) for l in template], spec)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host (bfloat16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, host: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(host.dtype)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any) -> None:
        leaves, structure = _flatten(tree)
        host = [_to_host(l) for l in leaves]
        dtypes = [_dtype_name(l, h) for l, h in zip(leaves, host)]
        self.wait()  # one write in flight at a time — a sync save after an
        # async one must not race it for the LATEST pointer
        args = (step, host, dtypes, str(structure[0]))
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=args,
                                            daemon=True)
            self._thread.start()
        else:
            self._write(*args)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list, dtypes: list,
               treedef: str) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "treedef": treedef,
                    "n_leaves": len(host),
                    "leaves": [{"dtype": d, "shape": list(a.shape)}
                               for a, d in zip(host, dtypes)]}
        for i, leaf in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # atomic LATEST pointer
        ptr_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(name)
        os.replace(ptr_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, d))

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        return int(name.split("_")[1])

    def steps_on_disk(self) -> list[int]:
        """Completed (renamed) step directories, ascending."""
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def restore(self, like: Any, step: Optional[int] = None,
                device=None) -> tuple[int, Any]:
        """Restore into the structure of ``like``, every leaf a tensor on
        ``device`` (``None``: the card).

        When ``step`` is None, a corrupt latest snapshot (a leaf truncated
        by a torn write, an unparseable manifest, a structure mismatch,
        ...) falls back to the previous completed step rather than
        raising; only when *no* step on disk restores is the newest step's
        error raised.  An explicit ``step`` is strict.
        """
        dev = resolve_device(device)
        if step is not None:
            return self._load_step(step, like, dev)
        latest = self.latest_step()
        candidates = self.steps_on_disk()
        if latest is not None and latest not in candidates:
            candidates.append(latest)
        if not candidates:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        first_err: Optional[Exception] = None
        for s in sorted(candidates, reverse=True):
            try:
                return self._load_step(s, like, dev)
            except Exception as e:  # corrupt/partial step: try the previous
                if first_err is None:
                    first_err = e
        raise first_err  # type: ignore[misc]

    def _load_step(self, step: int, like: Any,
                   device: torch.device) -> tuple[int, Any]:
        name = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(name, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like, structure = _flatten(like)
        assert manifest["n_leaves"] == len(leaves_like), \
            "checkpoint/model structure mismatch"
        out = []
        for i, meta in enumerate(manifest["leaves"]):
            arr = np.load(os.path.join(name, f"leaf_{i:05d}.npy"))
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:  # (a 0-d leaf is contiguous: it keeps its shape)
                t = torch.from_numpy(arr if arr.flags.c_contiguous
                                     else np.ascontiguousarray(arr))
            out.append(t.to(device))
        return step, _unflatten(structure, out)
