"""Fault tolerance: restart from a checkpoint, re-placement, straggler
notes.

The JAX package's ``train/fault.py``.  Large fleets lose nodes; the
contract here is:

* **checkpoint/restart**: :class:`FaultTolerantRunner` wraps the step loop;
  any step exception (device loss, preemption, an injected fault) triggers
  a restore from the last atomic checkpoint and a retry, with bounded
  restarts.  A restored leaf lands on the device of its leaf in the state
  the runner was given.
* **re-placement**: :func:`remesh` re-places a (params, opt_state) tree on
  a device.  The reference re-places it on new shardings of a mesh (fewer
  or more hosts); shardings come with the port's multi-device slice.
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
from .checkpoint import Checkpointer

__all__ = ["remesh", "FaultTolerantRunner", "FaultInjector"]

log = logging.getLogger("repro_torch.fault")


def remesh(tree: Any, device=None) -> Any:
    """``tree`` with every tensor leaf on ``device`` (``None``: the card).
    One device only: the reference's new shardings of a mesh wait for the
    multi-device slice (ROADMAP §1 item 12)."""
    if device is not None and not isinstance(device, (str, torch.device)):
        raise NotImplementedError(
            "remesh: shardings over a mesh come with the multi-device "
            "slice; pass a device")
    return to_device(tree, resolve_device(device))


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
