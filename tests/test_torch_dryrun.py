"""The dry-run (``repro_torch.launch.dryrun``) against the JAX package's on
the CPU.

The JAX package compiles each cell against fake XLA host devices and reads
``memory_analysis()``; the port traces the same step with fake tensors in a
fake world of ranks.  The JAX side runs in one subprocess with 4 fake
devices (as ``tests/test_torch_distributed.py`` runs it), started first and
read last; the port's fake world of 4 lives in one module fixture, which
tears it down.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.utils._pytree as pytree

import _torch_dryrun_records as records
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, applicable
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_world, make_mesh,
                                     make_production_mesh, serve_rules,
                                     train_rules)

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.join(_HERE, "..")
_SRC = os.path.join(_ROOT, "src")

# reduced archs × step kinds held to JAX's memory analysis on (2, 2)
ARCHS_HELD = ("qwen2-0.5b", "deepseek-moe-16b", "mamba2-2.7b", "zamba2-1.2b",
              "whisper-tiny", "qwen2-vl-2b")
KINDS = ("train", "prefill", "decode")
SMALL = {kind: ShapeConfig(f"small_{kind}", 16, 8, kind) for kind in KINDS}

_JAX_PROG = """
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{src!r}]
import jax
jax.devices()  # 4 devices, before the dry-run module asks for 512
from repro.configs import ShapeConfig, get_config
from repro.launch import dryrun
from repro.launch.mesh import make_mesh, serve_rules, train_rules
mesh = make_mesh((2, 2), ("data", "model"))
out = {{}}
for arch in {archs!r}:
    for kind in {kinds!r}:
        cfg = get_config(arch, reduced=True)
        if kind != "train":
            cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                                      remat="none")
        rules = train_rules() if kind == "train" else serve_rules()
        compiled, _ = dryrun._compile_variant(
            cfg, ShapeConfig("small_" + kind, 16, 8, kind), mesh, rules)
        ma = compiled.memory_analysis()
        out[arch + ":" + kind] = [int(ma.argument_size_in_bytes),
                                  int(ma.output_size_in_bytes)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_memory():
    """JAX's per-device argument and output bytes of each reduced cell on
    (2, 2), from its subprocess (started first, read last)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_PROG).format(
            src=_SRC, archs=ARCHS_HELD, kinds=KINDS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))

    def result():
        if not hasattr(result, "data"):
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            result.data = json.loads(out.strip().splitlines()[-1])
        return result.data

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _serving(cfg, kind):
    import dataclasses
    return cfg if kind == "train" else dataclasses.replace(
        cfg, param_dtype="bfloat16", remat="none")


@pytest.fixture(scope="module")
def port_memory(jax_memory):
    """The port's traces of the same cells in a fake world of 4 (the card's
    path), with the number of output leaves."""
    out = {}
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        for arch in ARCHS_HELD:
            for kind in KINDS:
                cfg = _serving(get_config(arch, reduced=True), kind)
                rules = train_rules() if kind == "train" else serve_rules()
                out[f"{arch}:{kind}"] = dryrun._trace_variant(
                    cfg, SMALL[kind], mesh, rules)
    return out


def test_cells_and_skip_reasons_equal_the_references():
    from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
    from repro.configs import applicable as japplicable
    ours = [(a, s.name, applicable(c, s)) for a, c in ARCHS.items()
            for s in SHAPES]
    theirs = [(a, s.name, japplicable(c, s)) for a, c in JARCHS.items()
              for s in JSHAPES]
    assert ours == theirs
    assert sum(ok for *_, (ok, _) in ours) == 32  # 10 archs, 32 cells


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
def test_input_specs_equal_the_references(shape):
    import jax.numpy as jnp
    from repro.launch import dryrun as jdryrun
    ours = dryrun.input_specs("qwen2-0.5b", shape)
    theirs = jdryrun.input_specs("qwen2-0.5b", shape)
    assert sorted(ours) == sorted(theirs)
    for k, spec in ours.items():
        assert tuple(spec.shape) == tuple(theirs[k].shape)
        assert spec.dtype == torch.int32 and theirs[k].dtype == jnp.int32
        assert spec.device.type == "meta"  # no data, as ShapeDtypeStruct


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS_HELD)
def test_argument_and_output_bytes_equal_jax(port_memory, jax_memory, arch,
                                             kind):
    """Per device on (2, 2): the argument bytes the step reads equal
    ``argument_size_in_bytes`` (``jax.jit`` drops unused arguments, e.g.
    the encoder's weights from whisper's decode step); the outputs' bytes
    plus XLA's output tuple table (one 8-byte pointer a leaf, when the step
    returns more than one array) equal ``output_size_in_bytes``."""
    got = port_memory[f"{arch}:{kind}"]
    arg, out = jax_memory()[f"{arch}:{kind}"]
    assert got.argument_bytes == arg
    table = 8 * got.output_leaves if got.output_leaves > 1 else 0
    assert got.output_bytes + table == out


def test_decode_cell_reads_the_kv_seq_sharded_cache(port_memory):
    """A decode step's collectives include the flash-decoding combine over
    the model axis (all-reduces of the ranks' maxima and sums)."""
    got = port_memory["qwen2-0.5b:decode"]
    assert got.coll_calls.get("all-reduce", 0) >= 2 * get_config(
        "qwen2-0.5b", reduced=True).n_layers


def test_counter_flops_equal_flop_counter_mode():
    """On one device the counter's FLOPs are ``FlopCounterMode``'s, the
    kernel ops by their kernels' formulas: the reduced qwen2 train step
    counted both ways on the same fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.device import card_model
    from repro_torch.models import Model
    model = Model(get_config("qwen2-0.5b", reduced=True))
    shape = SMALL["train"]
    with FakeTensorMode(), card_model():
        args = dryrun.step_args(model, shape, None, None,
                                torch.device("cpu"))
        counter = dryrun.CostCounter()
        with counter:
            dryrun.run_step(model, shape, args)
        with FlopCounterMode(display=False) as fc:
            dryrun.run_step(model, shape, args)
    assert counter.flops == fc.get_total_flops() > 0
    assert counter.peak > 0 and counter.bytes > 0


@pytest.mark.parametrize("multi_pod,size", [(False, 256), (True, 512)])
def test_production_mesh_inside_a_fake_world(multi_pod, size):
    """The production mesh binds a ``DeviceMesh`` (each axis its
    sub-groups) inside a fake world of its size, in well under a second;
    the world refuses a second one and is gone after the block, also after
    an error."""
    import time

    import torch.distributed as dist
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.perf_counter()
    with fake_world(size):
        dm = mesh.device_mesh()
        assert dm.size() == size and mesh.in_world()
        assert [dm.size(i) for i in range(dm.ndim)] == list(
            mesh.shape.values())
        with pytest.raises(RuntimeError, match="already up"):
            with fake_world(2):
                pass
    assert time.perf_counter() - t0 < 5.0
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_world(4):
            raise ValueError("inside")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=f"world of {size} ranks"):
        make_production_mesh(multi_pod=multi_pod, device="cpu").device_mesh()


def test_run_all_writes_a_record_per_cell(tmp_path):
    """An applicable cell (a full-width decode over 512 ranks: memory
    only) and one that is not, each with the reference's record keys."""
    dryrun.run_all("multi", only_arch="mamba2-2.7b", only_shape="long_500k",
                   out_dir=tmp_path)
    dryrun.run_all("single", only_arch="qwen2-0.5b", only_shape="long_500k",
                   out_dir=tmp_path)
    rec = json.loads((tmp_path / "mamba2-2.7b__long_500k__multi.json")
                     .read_text())
    assert rec["ok"] and rec["mesh"] == "2x16x16" and rec["n_devices"] == 512
    assert set(rec["mem"]) == {"argument_bytes", "output_bytes",
                               "temp_bytes", "code_bytes"}
    assert rec["mem"]["code_bytes"] == 0 and "flops_per_dev" not in rec
    skip = json.loads((tmp_path / "qwen2-0.5b__long_500k__single.json")
                      .read_text())
    assert skip["skipped"] and not skip["ok"] and "quadratic" in \
        skip["reason"]


@pytest.mark.parametrize("cell", sorted(records.REDUCED_CELLS))
def test_reduced_cells_give_their_records(cell):
    """Two reduced cells at full shapes on 16x16 (a train step; decode of
    524,288 cached positions): the records the card's host is held to."""
    assert records.reduced_record(*cell) == records.REDUCED_CELLS[cell]


# -- per-device memory as the mesh grows (fake worlds, reduced archs) ---------

def _temp(cfg, shape, dims, axes, rules) -> int:
    """The temp bytes of one step of ``cfg`` at ``shape`` traced on a mesh
    of ``dims`` × ``axes`` in a fake world of its size (the card's path)."""
    import math
    with fake_world(math.prod(dims)):
        return dryrun._trace_variant(_serving(cfg, shape.kind), shape,
                                     make_mesh(dims, axes), rules).temp_bytes


def _wide_vocab(arch: str = "qwen2-0.5b", vocab: int = 8192):
    """A reduced arch whose vocab (8192 × d_model 128) is its largest
    dim."""
    import dataclasses
    return dataclasses.replace(get_config(arch, reduced=True), vocab=vocab)


def test_train_temp_falls_with_the_model_ways():
    """A train step whose vocab is its largest dim, (2, 2) → (2, 4): the
    logits and the loss stay split over the vocab (model) ways, so the
    temp bytes fall to at most 0.6× (whole-vocab logits kept them).  The
    step donates, so its peak is the loss's backward, beside ~4 MB of
    activations split over the data ways only: at vocab 16384 the fall
    reads 0.56× (at 8192, 0.61×; the pure step's peak was its update,
    whose trees split exactly: 0.50×)."""
    cfg, shape = _wide_vocab(vocab=16384), ShapeConfig("t", 64, 8, "train")
    axes = ("data", "model")
    two = _temp(cfg, shape, (2, 2), axes, train_rules())
    four = _temp(cfg, shape, (2, 4), axes, train_rules())
    assert four <= 0.6 * two


def _local_param_bytes(cfg, shape, dims, axes, rules) -> int:
    """Rank 0's bytes of the weights of ``cfg`` placed on a mesh of
    ``dims`` × ``axes`` as the dry-run places them."""
    import math
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.device import card_model
    from repro_torch.models import Model
    with fake_world(math.prod(dims)):
        mesh = make_mesh(dims, axes, device=torch.device("cpu"))
        mesh.device_mesh()
        with FakeTensorMode(), card_model():
            args = dryrun.step_args(Model(cfg), shape, mesh, rules,
                                    torch.device("cpu"))
            return dryrun.tree_bytes(args[0])


def test_train_temp_at_the_update_falls_when_the_step_donates(monkeypatch):
    """Fault 22: a train cell whose peak sits at the update (reduced
    qwen2-0.5b, 4 × 8 tokens on (2, 2), so the activations are small
    beside the weights) holds at least two trees of weights fewer temp
    bytes a device under the donating step the dry-run traces than under
    the pure step, which builds a clipped gradient tree and new weights
    and moments beside the old (2.54 trees fewer)."""
    from repro_torch.train import train_loop
    cfg = get_config("qwen2-0.5b", reduced=True)
    shape = ShapeConfig("t", 8, 4, "train")
    dims, axes = (2, 2), ("data", "model")
    donated = _temp(cfg, shape, dims, axes, train_rules())
    monkeypatch.setattr(dryrun, "make_train_step",
                        lambda model, opt, **kw: train_loop.make_train_step(
                            model, opt, **dict(kw, donate=False)))
    pure = _temp(cfg, shape, dims, axes, train_rules())
    tree = _local_param_bytes(cfg, shape, dims, axes, train_rules())
    assert donated <= pure - 2 * tree, (donated, pure, tree)


def test_decode_temp_below_the_table():
    """A decode step on (1, 4) looks its tokens up in each rank's rows of
    the table: its temp bytes stay below the bf16 table's whole bytes
    (the table gathered whole for the lookup exceeded them)."""
    cfg = _wide_vocab()
    got = _temp(cfg, ShapeConfig("d", 64, 8, "decode"), (1, 4),
                ("data", "model"), serve_rules())
    assert 0 < got < cfg.vocab * cfg.d_model * 2


def test_ssm_prefill_temp_does_not_grow_with_the_world():
    """Fault 17 at reduced width: mamba2's prefill of 16 rows on 8 ranks
    (``data``) and on 16 (``pod × data``, one row a rank) holds at most
    0.6× the temp bytes on the larger world, as the reference's halve (the
    causal conv's zeros took the batch's global shape, and grew)."""
    cfg = get_config("mamba2-2.7b", reduced=True)
    shape = ShapeConfig("p", 64, 16, "prefill")
    n = _temp(cfg, shape, (8,), ("data",), serve_rules())
    two_n = _temp(cfg, shape, (2, 8), ("pod", "data"), serve_rules())
    assert two_n <= 0.6 * n


def test_whisper_prefill_temp_does_not_grow_with_the_world():
    """Fault 18 at reduced width: whisper-tiny's prefill of 16 rows on 8
    ranks (``data``) and on 16 (``pod × data``, one row a rank) holds at
    most 0.75× the temp bytes on the larger world (0.66× once repaired;
    the stub frames took the batch's global shape on every rank, and the
    encoder ran on them whole: 0.99×)."""
    cfg = get_config("whisper-tiny", reduced=True)
    shape = ShapeConfig("p", 64, 16, "prefill")
    n = _temp(cfg, shape, (8,), ("data",), serve_rules())
    two_n = _temp(cfg, shape, (2, 8), ("pod", "data"), serve_rules())
    assert two_n <= 0.75 * n, (n, two_n)


def test_capacity_prefill_temp_falls_with_the_expert_ways():
    """deepseek's capacity path, (1, 2) → (1, 4) with its 4 experts over
    the model axis: each rank builds dispatch and combine for its own
    experts only, so the temp bytes fall to at most 0.6× (whole in E on
    every rank they stayed)."""
    cfg = get_config("deepseek-moe-16b", reduced=True)
    shape = ShapeConfig("p", 256, 2, "prefill")
    axes = ("data", "model")
    two = _temp(cfg, shape, (1, 2), axes, serve_rules())
    four = _temp(cfg, shape, (1, 4), axes, serve_rules())
    assert four <= 0.6 * two


def test_dryrun_cli_single_cell():
    """The reference's launcher test, on the port: one 16x16 cell from the
    command line, with its costs, well inside 120 s."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "single"],
        capture_output=True, text=True, timeout=120, cwd=_ROOT,
        env=dict(os.environ, PYTHONPATH=_SRC)).stdout
    assert "whisper-tiny × decode_32k × 16x16" in out
    assert "flops/dev" in out and "coll/dev" in out


_RSS_PROG = """
import resource, sys
sys.path[:0] = [{src!r}]
from repro_torch.launch import dryrun
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
rec = dryrun.lower_cell("glm4-9b", "train_4k", multi_pod=False,
                        verbose=False)
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(rec["ok"], rec["mem"]["argument_bytes"], (after - before) * 1024)
"""


def test_full_width_train_cell_allocates_nothing():
    """glm4-9b × train_4k × 16x16 at full width (its f32 weights and AdamW
    moments alone are 113 GB whole) traces with the process's peak
    resident memory growing by less than 2 GiB."""
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_RSS_PROG).format(src=_SRC)],
        capture_output=True, text=True, timeout=300, cwd=_ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ok, arg, grew = out.stdout.split()
    assert ok == "True" and int(arg) > 0
    assert int(grew) < 2 * 2**30


# -- the kernel ops on fake CUDA tensors ---------------------------------------

def _op_cases():
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.moe_gmm import ops as mops, ref as mref
    from repro_torch.kernels.ssd_scan import ops as sops, ref as sref

    def mha(dev):
        q = torch.empty(4, 14, 2048, 64, dtype=torch.bfloat16, device=dev)
        k = torch.empty(4, 2, 2048, 64, dtype=torch.bfloat16, device=dev)
        return (q, k, k), {"causal": True}

    def ssd(dev):
        x = torch.empty(2, 256, 8, 64, device=dev)
        dt = torch.empty(2, 256, 8, device=dev)
        B = torch.empty(2, 256, 1, 128, device=dev)
        return (x, dt, torch.empty(8, device=dev), B, B), \
            {"return_state": True}

    def gmm(dev):
        x = torch.empty(300, 64, dtype=torch.bfloat16, device=dev)
        e = torch.zeros(300, dtype=torch.int64, device=dev)
        return (x, e, torch.empty(4, 64, 96, device=dev)), {}

    return {
        "mha": (fops.mha, fref.mha, mha, fops.flops(4, 14, 2048, 2048, 64,
                                                    True)),
        "ssd": (sops.ssd, sref.ssd, ssd, sops.flops(2, 256, 8, 64, 1, 128)),
        "moe_apply": (mops.moe_apply, mref.gmm, gmm, 2 * 300 * 64 * 96)}


@pytest.mark.parametrize("name", ["mha", "ssd", "moe_apply"])
def test_kernel_ops_on_fake_cuda_tensors(name, monkeypatch):
    """Given fake CUDA tensors an op gives its plain version's shapes and
    dtypes, launches and builds nothing (a build here would raise: there
    is no nvcc), and ``FlopCounterMode`` counts its kernel's FLOPs (for
    causal attention at (4, 14, 2, 2048, 2048, 64), 3.008e10)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import _build, launch_counts

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", no_build)
    op, plain, inputs, flops = _op_cases()[name]
    before = launch_counts()
    with FakeTensorMode():
        args, kw = inputs("cuda")
        with FlopCounterMode(display=False) as fc:
            got = op(*args, **kw)
        if name != "moe_apply":
            want = plain(*inputs("cpu")[0], **kw)
    if name == "moe_apply":  # the plain grouped product reads the routing
        want = plain(*(torch.zeros(t.shape, dtype=t.dtype)
                       for t in inputs("cpu")[0]), **kw)
    got, want = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "cuda" for t in got)
    assert launch_counts() == before
    assert fc.get_total_flops() == int(flops)
    if name == "mha":
        assert fc.get_total_flops() == 30_079_451_136
