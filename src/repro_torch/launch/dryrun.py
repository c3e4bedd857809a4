"""Multi-pod dry-run: trace every (arch × shape × mesh) cell with tensors
that hold no data.

The JAX package's ``launch/dryrun.py``, which lowers and compiles each
cell's step against 512 fake XLA host devices.  Here each cell's real step
function (the train step with AdamW, or the serving prefill or decode step)
runs eagerly on the production mesh inside :func:`..mesh.fake_world` (rank
0 of a world of 256 or 512 ranks over the ``fake`` backend, whose
collectives move nothing) under ``FakeTensorMode``: every parameter,
optimizer moment, batch and cache is a ``DTensor`` whose local shard is a
fake tensor, so nothing is allocated and ``DTensor`` works out rank 0's
shards.  A :class:`CostCounter` watches every op rank 0 runs on its local
tensors and records, per device:

* ``mem.argument_bytes``: the local bytes of the params, optimizer state,
  batch and cache that the step reads, as the reference's
  ``argument_size_in_bytes`` (``jax.jit`` drops an unused argument, e.g.
  the encoder's weights from a decode step);
* ``mem.output_bytes``: the local bytes of the step's outputs;
* ``mem.temp_bytes``: the peak of the bytes live during the step beyond
  the arguments (every storage an op made that is still referenced);
* ``mem.code_bytes``: 0, since eager PyTorch generates no program;
* ``flops_per_dev``: the FLOPs of ``torch.utils.flop_counter``'s formulas,
  the kernel ops counted by their kernels' own counts;
* ``bytes_per_dev``: the operand plus result bytes of every aten op,
  unfused (views and fresh allocations move nothing and are left out), so
  well above what a fused program reads;
* ``coll_bytes_per_dev`` / ``coll_kinds``: the result bytes of each
  collective, by the reference's kind names, all-reduce weighted ×2 as the
  reference weights it (``_KIND_WEIGHT``).

The full depth is traced: ``probe_layers`` is ``[n_layers]`` (the
reference extrapolates from probes because XLA counts a ``while`` body
once).  ``--device cuda`` (the default) models the card's path: the kernel
ops give their outputs by their fake rules and their kernels' FLOP counts,
and nothing is built or launched, so no card is needed.  On a host without
CUDA the tensors are fake CPU tensors inside
:func:`repro_torch.device.card_model` (PyTorch's autograd cannot take fake
CUDA tensors there); with CUDA they are fake CUDA tensors.  ``--device
cpu`` models the plain path that the reference's dry-run traces
(``use_pallas=False``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

Results are written incrementally to ``results/dryrun_torch/<cell>.json``
so long runs resume for free.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, SHAPES_BY_NAME, applicable, get_config
from ..device import card_model
from ..models import Model
from ..parallel import sharding as shlib
from ..parallel.axes import is_dtensor, shard_ctx
from ..train.optimizer import AdamW
from ..train.train_loop import make_train_step
from .mesh import fake_world, make_production_mesh, serve_rules, train_rules

__all__ = ["input_specs", "input_specs_of", "CostCounter", "step_args",
           "run_step", "tree_bytes", "lower_cell", "run_all", "main",
           "RESULTS_DIR"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

# ring-algorithm per-device traffic relative to the op's result bytes:
# all-reduce moves ~2× its tensor (reduce-scatter + all-gather phases).
_KIND_WEIGHT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# collective ops → the reference's kind names: the functional collectives
# DTensor issues, and the c10d ops of ``parallel.collectives``
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "recv_": "collective-permute",  # a ppermute's received half
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
# a ppermute's sends (their bytes are the receiver's result) and the waits
_UNCOUNTED = {"send", "wait_tensor"}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}
# DTensor runs each op once more on fake tensors of the global shape to
# find its output's metadata; that run is not rank 0's work
_PROPAGATION = {"_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"}


def input_specs(arch: str, shape_name: str) -> dict:
    """Shape-and-dtype stand-ins (meta tensors) for every model input of
    this cell: the token batch (and labels) for train and prefill, the
    single-step tokens for decode (the cache is built separately)."""
    del arch  # shapes are arch-independent for the LM family
    return input_specs_of(SHAPES_BY_NAME[shape_name])


def input_specs_of(shape) -> dict:
    B, S = shape.global_batch, shape.seq_len

    def spec(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "train":
        return {"tokens": spec(B, S), "labels": spec(B, S)}
    if shape.kind == "prefill":
        return {"tokens": spec(B, S)}
    return {"tokens": spec(B, 1)}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def tree_bytes(tree) -> int:
    """Local bytes of every tensor leaf (rank 0's shard of a DTensor)."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _in_propagation() -> bool:
    # the backward's ops may run on autograd's own thread, whose Python
    # stack starts at the dispatch: walk up from this frame
    f = sys._getframe()
    while f is not None:
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


class CostCounter(TorchDispatchMode):
    """Counts what this rank runs, op by op, on its local tensors: FLOPs
    (``flops``), operand and result bytes (``bytes``), the collectives'
    calls and result bytes by kind (``calls``, ``coll``), and the bytes of
    the storages that ops made and that are still referenced (``live``,
    with its ``peak``).

    A ``DTensor`` op is handed back to ``DTensor`` (``NotImplemented``),
    which runs its local ops and collectives through this mode.  Storages
    met before counting starts (:meth:`known`), or first met as an input,
    are not counted.  Works on fake and real tensors alike."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen: dict[int, object] = {}
        self._args: set[int] = set()
        self._read: set[int] = set()

    # -- memory -----------------------------------------------------------
    def known(self, tree) -> None:
        """Mark the storages of ``tree``'s tensors as existing already (the
        step's arguments); :meth:`read_bytes` then tells which of them the
        step read."""
        for t in pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._mark(_local(t), count=False)
                self._args.add(id(_local(t).untyped_storage()))

    def read_bytes(self, tree) -> int:
        """Local bytes of the leaves of ``tree`` (marked by :meth:`known`)
        whose storage some op took as an input: an argument the step never
        reads is not counted, as ``jax.jit`` drops unused arguments."""
        return sum(tree_bytes(t) for t in pytree.tree_leaves(tree)
                   if isinstance(t, torch.Tensor)
                   and id(_local(t).untyped_storage()) in self._read)

    def _mark(self, t: torch.Tensor, count: bool) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        nbytes = st.nbytes() if count else 0

        def freed(_, key=key, nbytes=nbytes):
            self._seen.pop(key, None)
            self.live -= nbytes

        self._seen[key] = weakref.ref(st, freed)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in ins:  # a storage first met as an input existed before
            self._mark(t, count=False)
            key = id(t.untyped_storage())
            if key in self._args:
                self._read.add(key)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self._mark(t, count=True)
        name = func._overloadpacket.__name__
        kind = _COLLECTIVE_KIND.get(name)
        if kind is not None:
            res = outs if outs else ins  # in-place c10d ops write args
            self.coll[kind] = self.coll.get(kind, 0.0) + float(
                sum(t.numel() * t.element_size() for t in res))
            self.calls[kind] = self.calls.get(kind, 0) + 1
            return out
        if name in _UNCOUNTED:
            return out
        pkt = func._overloadpacket
        if pkt in self._flop_registry:
            self.flops += self._flop_registry[pkt](*args, **kwargs,
                                                   out_val=out)
        if not (func.is_view or name in _NO_TRAFFIC):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        return out

    def coll_total(self) -> float:
        return sum(v * _KIND_WEIGHT.get(k, 1.0) for k, v in self.coll.items())


# --------------------------------------------------------------------------
# one step
# --------------------------------------------------------------------------

def _trace_device(device: str) -> tuple[torch.device, bool]:
    """(the device of the fake tensors, whether they stand for the card
    inside ``card_model``)."""
    if device == "cpu":
        return torch.device("cpu"), False
    if device != "cuda":
        raise ValueError(f"dryrun: device cuda or cpu, got {device!r}")
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device()), False
    return torch.device("cpu"), True


def _abstract_params(model: Model, shape, dev: torch.device):
    """The model's parameter tree as fake tensors on ``dev`` (the
    reference's ``eval_shape`` of ``model.init``)."""
    kw = ({"max_dec_len": shape.seq_len} if model.cfg.family == "audio"
          else {})
    params = model.init(seed=0, device="cpu", **kw)
    return params if dev.type == "cpu" else pytree.tree_map(
        lambda t: t.to(dev), params)


def _whole_vocab(logits):
    """(B, S, V) logits with V whole on every rank: the greedy argmax over
    a vocab split over ranks has no ``DTensor`` rule that keeps the value
    on the device."""
    if not is_dtensor(logits):
        return logits
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if p in (Shard(2), Shard(-1)) else p
          for p in logits.placements]
    return logits.redistribute(logits.device_mesh, pl)


def _place(tree, specs, mesh):
    return tree if mesh is None else shlib.place(
        tree, shlib.to_shardings(specs, mesh))


@dataclasses.dataclass
class Traced:
    """What :func:`_trace_variant` records of one step."""

    argument_bytes: int
    output_bytes: int
    output_leaves: int
    temp_bytes: int
    flops: float
    bytes: float
    coll: float
    coll_kinds: dict
    coll_calls: dict
    seconds: float


def step_args(model: Model, shape, mesh, rules, dev: torch.device, *,
              params=None) -> tuple:
    """The arguments of the cell's step, placed on ``mesh`` (``None``: one
    device) by the reference's specs: (params, opt_state, batch) to train,
    (params, batch) to prefill, (params, cache, batch) to decode.  The
    params are the model's seed-0 draw unless given; the batch is zeros of
    :func:`input_specs_of`."""
    if params is None:
        params = _abstract_params(model, shape, dev)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in input_specs_of(shape).items()}
    params = _place(params, mesh and shlib.param_specs(params, mesh, rules),
                    mesh)
    batch = _place(batch, mesh and shlib.batch_specs(batch, mesh, rules),
                   mesh)
    if shape.kind == "train":
        # the moments are made from the placed params: sharded like them
        return params, AdamW().init(params), batch
    if shape.kind == "prefill":
        return params, batch
    cache = model.init_cache(shape.global_batch, shape.seq_len, device=dev)
    cache = _place(cache, mesh and shlib.cache_specs(cache, mesh, rules),
                   mesh)
    return params, cache, batch


def run_step(model: Model, shape, args: tuple, *, grad_accum: int = 1):
    """The cell's step on :func:`step_args`' arguments: the train step with
    AdamW, the prefill forward's logits, or a decode step and its greedy
    tokens with the new cache.  The train step donates its weights and
    moments, as the reference lowers it (``donate_argnums=(0, 1)``) and as
    ``train`` runs it: the update is written into them.  The caller
    installs the mesh's ``shard_ctx``."""
    if shape.kind == "train":
        return make_train_step(model, AdamW(), grad_accum=grad_accum,
                               donate=True)(*args)
    with torch.no_grad():
        if shape.kind == "prefill":
            params, batch = args
            return model.forward(params, batch["tokens"])[0]
        params, cache, batch = args
        logits, new_cache = model.decode_step(params, cache,
                                              batch["tokens"])
        return Model.greedy_token(_whole_vocab(logits)), new_cache


def _trace_variant(cfg, shape, mesh, rules, grad_accum: int = 1, *,
                   device: str = "cuda") -> Traced:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (or on one device
    for ``None``) under ``rules``, with fake tensors; the caller provides a
    world of the mesh's size (:func:`fake_world`).  The serving cells'
    config (bf16 params, no remat) is the caller's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.monotonic()
    dev, card = _trace_device(device)
    if mesh is not None:  # the same axes, on the fake tensors' device
        mesh = type(mesh)(tuple(mesh.shape.values()), mesh.axis_names,
                          device=dev)
        mesh.device_mesh()  # its rank grid is real data: before faking
    model = Model(cfg)
    counter = CostCounter()
    with FakeTensorMode(), \
            (card_model() if card else contextlib.nullcontext()):
        args = step_args(model, shape, mesh, rules, dev)
        counter.known(args)
        with (shard_ctx(mesh, rules) if mesh is not None
              else contextlib.nullcontext()), counter:
            out = run_step(model, shape, args, grad_accum=grad_accum)
        rec = Traced(argument_bytes=counter.read_bytes(args),
                     output_bytes=tree_bytes(out),
                     output_leaves=len(pytree.tree_leaves(out)),
                     temp_bytes=counter.peak, flops=float(counter.flops),
                     bytes=float(counter.bytes), coll=counter.coll_total(),
                     coll_kinds=dict(counter.coll),
                     coll_calls=dict(counter.calls),
                     seconds=time.monotonic() - t0)
        del out, args
    return rec


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               verbose: bool = True, with_costs: bool = True,
               cfg_override=None, rules_override=None, grad_accum: int = 1,
               device: str = "cuda") -> dict:
    """Trace one cell on its production mesh; returns the analysis
    record (the reference's keys).  ``compile_s`` is 0: nothing is
    compiled."""
    shape = SHAPES_BY_NAME[shape_name]
    cfg = cfg_override or get_config(arch)
    is_train = shape.kind == "train"
    if not is_train:  # serving: bf16 params, no optimizer
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16", remat="none")
    if rules_override is not None:
        rules = rules_override
    else:
        rules = (train_rules(cfg.seq_shard, fsdp=cfg.fsdp)
                 if is_train else serve_rules())
    mesh = make_production_mesh(multi_pod=multi_pod)
    with fake_world(mesh.size):
        tr = _trace_variant(cfg, shape, mesh, rules, grad_accum=grad_accum,
                            device=device)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size,
        "kind": shape.kind,
        "device": device,
        "ok": True,
        "lower_s": round(tr.seconds, 1),
        "compile_s": 0.0,
        "mem": {
            "argument_bytes": tr.argument_bytes,
            "output_bytes": tr.output_bytes,
            "temp_bytes": tr.temp_bytes,
            "code_bytes": 0,
        },
    }
    if with_costs:
        rec.update({
            "flops_per_dev": tr.flops,
            "bytes_per_dev": tr.bytes,
            "coll_bytes_per_dev": tr.coll,
            "coll_kinds": tr.coll_kinds,
            "coll_calls": tr.coll_calls,
            "probe_layers": [cfg.n_layers],
        })
    if verbose:
        msg = (f"[dryrun] {arch} × {shape_name} × {rec['mesh']}: "
               f"mem(arg+tmp)="
               f"{(tr.argument_bytes + tr.temp_bytes) / 2**30:.2f}GiB "
               f"(lower {tr.seconds:.0f}s compile 0s)")
        if with_costs:
            msg += (f" flops/dev={tr.flops:.3e} bytes/dev={tr.bytes:.3e} "
                    f"coll/dev={tr.coll:.3e}")
        print(msg, flush=True)
    return rec


def run_all(mesh_mode: str = "both", only_arch: Optional[str] = None,
            only_shape: Optional[str] = None, force: bool = False, *,
            device: str = "cuda", out_dir=None) -> None:
    out_dir = Path(out_dir or RESULTS_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    modes = {"single": [False], "multi": [True],
             "both": [False, True]}[mesh_mode]
    for arch, cfg in ARCHS.items():
        if only_arch and arch != only_arch:
            continue
        for shape_name in SHAPES_BY_NAME:
            if only_shape and shape_name != only_shape:
                continue
            ok, why = applicable(cfg, SHAPES_BY_NAME[shape_name])
            for multi in modes:
                cell = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                out = out_dir / (cell + ".json")
                if out.exists() and not force:
                    print(f"[dryrun] skip {cell} (done)")
                    continue
                if not ok:
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi else "16x16",
                           "ok": False, "skipped": True, "reason": why}
                else:
                    try:
                        # multi-pod: memory only (the roofline is 16x16)
                        rec = lower_cell(arch, shape_name, multi_pod=multi,
                                         with_costs=not multi, device=device)
                    except Exception as e:  # noqa: BLE001
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": "2x16x16" if multi else "16x16",
                               "ok": False, "error": repr(e),
                               "trace": traceback.format_exc()[-2000:]}
                        print(f"[dryrun] FAIL {cell}: {e!r}")
                with open(out, "w") as f:
                    json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="trace every arch × shape cell on the production "
                    "meshes, with tensors that hold no data")
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the path to model: the card's kernels (cuda, "
                         "needs no card) or the plain versions (cpu)")
    args = ap.parse_args(argv)
    if args.all or args.arch is None:
        run_all(args.mesh, only_arch=args.arch, only_shape=args.shape,
                force=args.force, device=args.device)
    else:
        for multi in {"single": [False], "multi": [True],
                      "both": [False, True]}[args.mesh]:
            lower_cell(args.arch, args.shape or "train_4k", multi_pod=multi,
                       device=args.device)


if __name__ == "__main__":
    main()
