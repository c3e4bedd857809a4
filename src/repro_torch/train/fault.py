"""Fault tolerance: restart from a checkpoint, re-placement, straggler
notes.

The JAX package's ``train/fault.py``.  Large fleets lose nodes; the
contract here is:

* **checkpoint/restart**: :class:`FaultTolerantRunner` wraps the step loop;
  any step exception (device loss, preemption, an injected fault) triggers
  a restore from the last atomic checkpoint and a retry, with bounded
  restarts.  A restored leaf lands on the device of its leaf in the state
  the runner was given.
* **elastic re-mesh**: :func:`remesh` re-places a (params, opt_state)
  tree onto *new* shardings, possibly of a different mesh (fewer or more
  hosts): each leaf is gathered whole, then placed by its new
  :class:`~repro_torch.parallel.sharding.NamedSharding`.  Because
  optimizer state shards like params, shrinking the data axis just works.
  Given a device instead, it re-places the tree on that one device.
* **straggler mitigation**: within one step there is nothing to mitigate;
  at the host layers the GPP any-channel semantics give work stealing (the
  serving scheduler hands a request to the first free slot, and the data
  :class:`~repro_torch.data.Prefetcher` keeps a buffered channel so a slow
  host thread never stalls the device).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree

from ..device import resolve_device, to_device
from ..parallel.axes import is_dtensor
from ..parallel.sharding import place
from .checkpoint import Checkpointer

__all__ = ["remesh", "FaultTolerantRunner", "FaultInjector"]

log = logging.getLogger("repro_torch.fault")


def remesh(tree: Any, new_shardings: Any = None) -> Any:
    """Re-place ``tree`` onto ``new_shardings`` (a tree of the same
    structure of :class:`~repro_torch.parallel.sharding.NamedSharding`,
    possibly of a different mesh), or, given a device (``None``: the
    card), move every tensor leaf to it."""
    if new_shardings is None or isinstance(new_shardings,
                                           (str, torch.device)):
        return to_device(_whole(tree), resolve_device(new_shardings))
    return place(_whole(tree), new_shardings)


def _whole(tree):
    """Every DTensor leaf gathered whole (a collective over its mesh)."""
    return pytree.tree_map(
        lambda l: l.full_tensor() if is_dtensor(l) else l, tree)


def _device_of(tree) -> Optional[torch.device]:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


class FaultInjector:
    """Deterministic fault injection for tests: raises at given steps."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class FaultTolerantRunner:
    """Wraps a step loop with checkpoint/restart semantics.

    ``step_fn(i, state) -> state`` runs one step; the runner saves through
    ``self.ckpt`` every ``save_every`` steps and at the end.  On failure it
    waits for a write in flight (an async save), restores the latest
    checkpoint and resumes from there; with no checkpoint yet it restarts
    from step 0 with the state it was given.  (The reference restarts from
    step 0 with the state the failed step left, and reads the latest step
    without waiting for an async write.)
    """

    def __init__(self, ckpt: Checkpointer, *, max_restarts: int = 3):
        self.ckpt = ckpt
        self.max_restarts = max_restarts
        self.restarts = 0

    def _restore(self, state):
        dev = _device_of(state) or torch.device("cpu")
        return self.ckpt.restore(state, self.ckpt.latest_step(), device=dev)

    def run(self, *, total_steps: int, state: Any,
            step_fn: Callable[[int, Any], Any],
            save_every: int = 10,
            injector: Optional[FaultInjector] = None) -> Any:
        """state: {"params", "opt_state", ...} tree; step_fn(i, state) →
        state.  Returns the final state."""
        step, initial = 0, state
        if self.ckpt.latest_step() is not None:  # resume from a checkpoint
            step, state = self._restore(state)
            log.info("resuming from step %d", step)
        while step < total_steps:
            try:
                if injector is not None:
                    injector.check(step)
                state = step_fn(step, state)
                step += 1
                if step % save_every == 0 or step == total_steps:
                    self.ckpt.save(step, state)
            except Exception as e:  # noqa: BLE001 — any node fault
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.max_restarts}") from e
                log.warning("step %d failed (%s); restoring", step, e)
                self.ckpt.wait()
                if self.ckpt.latest_step() is None:
                    step, state = 0, initial  # restart from scratch
                else:
                    step, state = self._restore(state)
        return state
