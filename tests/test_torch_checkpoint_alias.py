"""An async checkpoint holds the values of ``save``'s moment.

``Checkpointer(async_save=True).save`` copies the tree to the host and
returns while a worker thread writes it.  A CPU tensor's ``.cpu()`` and a
numpy array's ``np.asarray`` are the caller's own storage, not copies, so
an in-place write made before the thread finished once reached the disk:
the JAX package's arrays are immutable and its checkpoints cannot alias.
Here the writer thread is held until the caller has written into every
leaf, and ``restore`` must still give the saved values.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.train import Checkpointer


def _held_writer(monkeypatch):
    """Hold ``Checkpointer._write`` until ``release`` is set; ``started`` is
    set once the writer thread is in it."""
    started, release = threading.Event(), threading.Event()
    write = Checkpointer._write

    def held(self, *args):
        started.set()
        assert release.wait(30), "the test never released the writer"
        return write(self, *args)

    monkeypatch.setattr(Checkpointer, "_write", held)
    return started, release


def _trees(kind):
    """(the tree saved, an in-place write into it, the values saved)."""
    if kind == "numpy":
        tree = {"w": np.zeros(4, np.float32),
                "b": {"c": np.arange(3, dtype=np.int32)}}

        def write():
            tree["w"] += 1.0
            tree["b"]["c"][:] = 7
        want = {"w": np.zeros(4, np.float32),
                "b": {"c": np.arange(3, dtype=np.int32)}}
        return tree, write, want
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    tree = {"w": torch.zeros(4, dtype=dtype),
            "b": {"c": torch.arange(3, dtype=torch.int32)},
            "step": torch.zeros((), dtype=torch.int32)}

    def write():
        tree["w"].add_(1.0)
        tree["b"]["c"].fill_(7)
        tree["step"].add_(5)
    want = {k: (v.clone() if isinstance(v, torch.Tensor)
                else {"c": v["c"].clone()}) for k, v in tree.items()}
    return tree, write, want


@pytest.mark.parametrize("kind", ["tensor", "bf16", "numpy"])
def test_async_save_unaffected_by_later_in_place_writes(tmp_path,
                                                         monkeypatch, kind):
    started, release = _held_writer(monkeypatch)
    tree, write, want = _trees(kind)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, tree)
    assert started.wait(30)
    write()  # the caller moves on while the write is in flight
    release.set()
    ck.wait()
    like = {"w": torch.zeros(4),
            "b": {"c": torch.zeros(3, dtype=torch.int32)}}
    if kind != "numpy":
        like["step"] = torch.zeros((), dtype=torch.int32)
    step, got = ck.restore(like, device="cpu")
    assert step == 1
    pairs = [(got["w"], want["w"]), (got["b"]["c"], want["b"]["c"])]
    if kind != "numpy":
        pairs.append((got["step"], want["step"]))
    for g, w in pairs:
        w = torch.as_tensor(w)
        assert g.dtype == w.dtype and torch.equal(g, w), (g, w)


def test_sync_save_still_writes_the_tree(tmp_path):
    tree = {"w": torch.arange(4.0)}
    ck = Checkpointer(str(tmp_path))
    ck.save(2, tree)
    tree["w"].zero_()
    _, got = ck.restore({"w": torch.zeros(4)}, device="cpu")
    assert torch.equal(got["w"], torch.arange(4.0))
