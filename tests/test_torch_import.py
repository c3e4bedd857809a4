"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import repro_torch
from repro_torch.core import DataParallelCollect, build, run_sequential
from repro_torch.core.builder import make_emit_batch
from repro_torch.device import resolve_device

SRC = pathlib.Path(repro_torch.__file__).resolve().parents[1]
ROOT = SRC.parent


def test_import_loads_no_jax_and_no_repro_module():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert len(names) > 20, names
        for mod in ("cluster.partition", "cluster.transport",
                    "cluster.runtime", "cluster.control", "cluster.deploy",
                    "cluster.durable", "cluster.sim", "train",
                    "train.checkpoint",
                    "launch._common", "launch.cluster"):
            assert f"repro_torch.{mod}" in names, mod
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("ok", len(names))
    """)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_sources_name_no_jax_import():
    files = [*sorted((SRC / "repro_torch").rglob("*.py")),
             ROOT / "chip_smoke.py"]
    for f in files:
        text = f.read_text()
        for needle in ("import jax", "from jax", "from repro.",
                       "import repro.", "from repro import"):
            assert needle not in text, f"{f}: {needle}"


def _net():
    return DataParallelCollect(create=lambda i: torch.tensor(float(i)),
                               function=lambda x: x * x,
                               collector=lambda a, x: a + x,
                               init=torch.tensor(0.0), workers=2,
                               jit_combine=True)


@pytest.mark.parametrize("entry", [
    lambda: build(_net()),
    lambda: run_sequential(_net(), 4),
    lambda: make_emit_batch(_net(), 4),
    lambda: resolve_device(None)], ids=["build", "run_sequential",
                                        "make_emit_batch", "resolve_device"])
def test_no_device_without_gpu_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_on_request():
    cn = build(_net(), device="cpu")
    assert cn.device == torch.device("cpu")
    assert float(cn.run(instances=4)["collect"]) == 14.0
    batch = make_emit_batch(_net(), 3, device="cpu")
    assert batch.device.type == "cpu" and batch.shape == (3,)
