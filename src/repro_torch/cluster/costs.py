"""Measured per-process cost profiles — the input to cost-balanced cuts.

The paper's cluster capstone (§7) splits the network across workstations by
hand and the bottleneck host sets the pace; ``auto_assignment`` balances
process *counts*, which is the same failure dressed up.  This module
measures what each stage actually costs so
:func:`.partition.cost_assignment` can cut by *time*:

* :func:`calibrate` runs a short seeded calibration pass of the network —
  one tiny batch through a :class:`..core.stream.StreamExecutor` with
  chain fusion off, capturing each stage's first real arguments — then
  times every captured stage on its device (a warm call outside the
  clock, which also pays any kernel build at first use, then the best of
  ``repeats`` calls, each between two ``torch.cuda.synchronize``) and
  records its output size.  The measured wall is ground truth.  A flops
  and bytes *prior* rides along (used to estimate stages the calibration
  never executed), counted over one more eager call of the stage under a
  ``TorchDispatchMode``: matmul-like aten ops by
  ``torch.utils.flop_counter``'s formulas, one flop per output element
  for every other aten op, and each op's input and output bytes as
  ``bytes_accessed`` — about what XLA's HLO cost analysis counts for the
  JAX package.  A hand-written kernel launched through ``ctypes`` is no
  aten op and adds no flops, as a Pallas call without a ``cost_estimate``
  adds none to the JAX package's prior (0 means unavailable there too).
* :func:`calibrate_bandwidth` times one transport round trip per kind so a
  plan can price cut-channel traffic in seconds, not bytes.  The port's
  ``"device"`` transport stands where the JAX package has ``"jaxmesh"``.

Everything lands in a :class:`CostProfile` — cached per ``(process, shape,
dtype)`` so re-calibrating an unchanged stage is free — which
``cost_assignment`` consumes.  Its JSON is the JAX package's, so a profile
saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import time as _time
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.dataflow import NetworkError

__all__ = ["ProcessCost", "CostProfile", "calibrate", "calibrate_bandwidth"]


@dataclasses.dataclass
class ProcessCost:
    """Measured (or estimated) cost of one process at one input signature."""

    name: str
    shape: tuple = ()
    dtype: str = ""
    wall_s: float = 0.0       # best-of-repeats measured chunk time
    out_bytes: int = 0        # bytes one output chunk puts on the wire
    flops: float = 0.0        # counted prior (0 = unavailable)
    bytes_accessed: float = 0.0
    source: str = "measured"  # "measured" | "estimated" | "default"

    def signature(self) -> tuple:
        return (tuple(self.shape), self.dtype)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ProcessCost":
        d = dict(d)
        d["shape"] = tuple(d.get("shape", ()))
        return cls(**d)


@dataclasses.dataclass
class CostProfile:
    """Per-process measured costs + per-transport calibrated bandwidths.

    ``costs`` maps process name -> :class:`ProcessCost`; ``bandwidths`` maps
    transport kind -> bytes/s.  ``default_wall_s`` prices the structural
    stages calibration never runs (Emit, spreaders, MERGE, a host-side
    Collect) — small but non-zero, so a host of pure wiring is never free.
    ``flops_per_s`` is the achieved rate across measured stages, used to
    *estimate* a stage that only has a counted prior.
    """

    costs: dict = dataclasses.field(default_factory=dict)
    bandwidths: dict = dataclasses.field(default_factory=dict)
    microbatch_size: int = 8
    seed: int = 0
    default_wall_s: float = 1e-6
    flops_per_s: float = 0.0

    def time_of(self, name: str) -> float:
        """Seconds one chunk spends in ``name`` — measured when we have it,
        flops/rate estimate when only the prior exists, default otherwise."""
        c = self.costs.get(name)
        if c is None:
            return self.default_wall_s
        if c.wall_s > 0:
            return c.wall_s
        if c.flops > 0 and self.flops_per_s > 0:
            return c.flops / self.flops_per_s
        return self.default_wall_s

    def out_bytes_of(self, name: str) -> int:
        c = self.costs.get(name)
        return c.out_bytes if c is not None else 0

    def transfer_s(self, nbytes: int,
                   transport: Optional[str] = None) -> float:
        """Seconds ``nbytes`` spend crossing a cut channel.  Falls back to
        the fastest calibrated transport, then to free (no bandwidth data
        means transfer cost cannot be priced honestly)."""
        if nbytes <= 0:
            return 0.0
        bw = self.bandwidths.get(transport, 0.0)
        if bw <= 0 and self.bandwidths:
            bw = max(self.bandwidths.values())
        return nbytes / bw if bw > 0 else 0.0

    def describe(self) -> str:
        lines = [f"== cost profile (mb={self.microbatch_size}, "
                 f"seed={self.seed}) =="]
        for name in sorted(self.costs):
            c = self.costs[name]
            f = f"{c.flops:.3e}" if c.flops else "-"
            lines.append(
                f"{name:<24} {c.wall_s * 1e6:10.1f}us  "
                f"out={c.out_bytes:>8}B  flops={f}  [{c.source}]")
        for kind in sorted(self.bandwidths):
            lines.append(f"bandwidth[{kind:<9}] "
                         f"{self.bandwidths[kind] / 1e6:10.1f} MB/s")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "costs": {n: c.to_json() for n, c in self.costs.items()},
            "bandwidths": dict(self.bandwidths),
            "microbatch_size": self.microbatch_size,
            "seed": self.seed,
            "default_wall_s": self.default_wall_s,
            "flops_per_s": self.flops_per_s,
        }

    @classmethod
    def from_json(cls, d: dict) -> "CostProfile":
        return cls(
            costs={n: ProcessCost.from_json(c)
                   for n, c in d.get("costs", {}).items()},
            bandwidths=dict(d.get("bandwidths", {})),
            microbatch_size=int(d.get("microbatch_size", 8)),
            seed=int(d.get("seed", 0)),
            default_wall_s=float(d.get("default_wall_s", 1e-6)),
            flops_per_s=float(d.get("flops_per_s", 0.0)),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CostProfile":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _tensors(value) -> list:
    return [leaf for leaf in pytree.tree_leaves(value)
            if isinstance(leaf, torch.Tensor)]


def _dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the JAX package's spelling, so
    a signature (and a saved profile's cache hit) means the same in both."""
    return str(dtype).removeprefix("torch.")


def _leaf_signature(xs) -> tuple:
    """(shape, dtype) of the first tensor leaf of the stage's inputs — the
    cache key deciding whether an old measurement still applies."""
    leaves = _tensors(list(xs))
    if not leaves:
        return ((), "")
    return (tuple(leaves[0].shape), _dtype_name(leaves[0].dtype))


def _tree_nbytes(value) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(value))


def _count_prior(fn, xs) -> tuple[float, float]:
    """(flops, bytes accessed) of one eager call of ``fn(*xs)``, counted
    op by op under a ``TorchDispatchMode`` (see the module docstring)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    tally = [0.0, 0.0]

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            outs = _tensors(out)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                tally[0] += formula(*args, **kwargs, out_val=out)
            else:
                tally[0] += sum(t.numel() for t in outs)
            tally[1] += _tree_nbytes((args, kwargs)) + _tree_nbytes(outs)
            return out

    with _Count():
        fn(*xs)
    return float(tally[0]), float(tally[1])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate(net, *, instances: Optional[int] = None,
              microbatch_size: int = 4, repeats: int = 3, seed: int = 0,
              transports=(), profile: Optional[CostProfile] = None,
              payload_bytes: int = 1 << 16, device=None) -> CostProfile:
    """Short seeded calibration run → :class:`CostProfile`.

    One tiny batch (``instances`` items, default one microbatch per lane)
    streams through the net on ``device`` (``None``: the card) with chain
    fusion off; every stage's first real arguments are captured, then each
    stage is re-timed best-of-``repeats``.  ``transports`` names the kinds
    to bandwidth-time (on the same device).  Pass ``profile`` to
    re-calibrate incrementally: stages whose input signature is unchanged
    keep their old measurement.
    """
    from ..core.builder import build
    from ..core.stream import StreamExecutor

    class _CalibratingExecutor(StreamExecutor):
        """Capture each stage's first real arguments as they stream."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.captured: dict = {}

        def _stage_call(self, name):
            real = super()._stage_call(name)

            def probe(*xs, _name=name, _real=real):
                self.captured.setdefault(_name, (_real, xs))
                return _real(*xs)

            return probe

    cn = build(net, device=device)
    dev = cn.device
    ex = _CalibratingExecutor(cn, microbatch_size=microbatch_size,
                              fuse=False)
    if instances is None:
        # enough chunks that every lane/branch sees at least one
        instances = microbatch_size * max(2, ex.lanes)
    np.random.seed(seed)
    torch.manual_seed(seed)
    batch = cn.make_batch(instances)
    ex.run(batch)
    _sync(dev)
    if not ex.captured:
        raise NetworkError(
            f"calibration run of {net.name!r} executed no stages")

    out = profile if profile is not None else CostProfile()
    out.microbatch_size = microbatch_size
    out.seed = seed
    total_wall = total_flops = 0.0
    for name, (fn, xs) in ex.captured.items():
        sig = _leaf_signature(xs)
        old = out.costs.get(name)
        if old is not None and old.signature() == sig and old.wall_s > 0:
            total_wall += old.wall_s
            total_flops += old.flops
            continue  # cache hit: same (process, shape, dtype)
        fn(*xs)  # warm: first-use builds stay outside the clock
        _sync(dev)
        best = float("inf")
        for _ in range(max(1, repeats)):
            _sync(dev)
            t0 = _time.perf_counter()
            fn(*xs)
            _sync(dev)
            best = min(best, _time.perf_counter() - t0)
        result = fn(*xs)
        flops = bytes_accessed = 0.0
        try:  # counted prior — best effort, like the JAX package's
            flops, bytes_accessed = _count_prior(fn, xs)
        except Exception:
            pass
        out.costs[name] = ProcessCost(
            name=name, shape=sig[0], dtype=sig[1], wall_s=best,
            out_bytes=_tree_nbytes(result), flops=flops,
            bytes_accessed=bytes_accessed, source="measured")
        total_wall += best
        total_flops += flops
    if total_wall > 0 and total_flops > 0:
        out.flops_per_s = total_flops / total_wall
    # structural stages cost "one dispatch", not zero: an order of magnitude
    # under the cheapest measured stage
    cheapest = min((c.wall_s for c in out.costs.values() if c.wall_s > 0),
                   default=1e-5)
    out.default_wall_s = max(cheapest / 10.0, 1e-7)
    for kind in transports:
        out.bandwidths[kind] = calibrate_bandwidth(
            kind, payload_bytes=payload_bytes, device=dev)
    return out


def calibrate_bandwidth(kind: str = "inprocess", *,
                        payload_bytes: int = 1 << 16,
                        repeats: int = 16, device=None) -> float:
    """Bytes/s of one transport kind: time ``repeats`` same-process
    send+recv round trips of a ``payload_bytes`` float32 tensor on
    ``device`` (``None``: the card) over a private channel.  Includes
    pack/unpack (pickling, the copy to the host over ``pipe``, shm slot
    copies) — the cost a cut channel actually pays, not the theoretical
    link rate.  ``"device"`` is the port's ``"jaxmesh"``."""
    from ..device import resolve_device
    from .transport import make_transport

    dev = resolve_device(device)
    t = make_transport(kind)
    chan = ("__calib_src__", "__calib_dst__")
    t.setup([chan], {chan: 4})
    try:
        x = torch.zeros(max(1, payload_bytes // 4), dtype=torch.float32,
                        device=dev)
        nbytes = x.numel() * x.element_size()
        t.send(chan, 0, x)  # warm the path (feeder threads, shm attach)
        t.recv(chan, 0)
        _sync(dev)
        t0 = _time.perf_counter()
        for i in range(1, repeats + 1):
            t.send(chan, i, x)
            t.recv(chan, i)
        _sync(dev)
        elapsed = _time.perf_counter() - t0
    finally:
        t.close()
    return (repeats * nbytes) / max(elapsed, 1e-9)
