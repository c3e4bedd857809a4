"""The port's example CLIs, each run at a tiny size on the CPU: every
equality line they print must say True, and they must exit 0."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

TINY = ["--device", "cpu"]
CASES = {
    "mandelbrot": ["torch_mandelbrot.py", "--width", "64", "--height", "32",
                   "--bands", "4", "--iters", "20"],
    "mandelbrot_pipe": ["torch_mandelbrot.py", "--hosts", "2",
                        "--transport", "pipe", "--width", "64",
                        "--height", "32", "--bands", "4", "--iters", "20",
                        "--batches", "2", "--timeout-s", "60"],
    "mandelbrot_shm": ["torch_mandelbrot.py", "--hosts", "2",
                       "--transport", "shm", "--width", "64",
                       "--height", "32", "--bands", "4", "--iters", "20",
                       "--batches", "2", "--timeout-s", "60"],
    "mandelbrot_kill_host": ["torch_mandelbrot.py", "--hosts", "2",
                             "--transport", "shm", "--width", "64",
                             "--height", "32", "--bands", "4", "--iters",
                             "20", "--kill-host", "1", "--timeout-s", "60"],
    "mandelbrot_device": ["torch_mandelbrot.py", "--hosts", "2",
                          "--transport", "jaxmesh", "--width", "64",
                          "--height", "32", "--bands", "4", "--iters", "20",
                          "--batches", "2"],
    "image_pipeline": ["torch_image_pipeline.py", "--size", "32",
                       "--kernel", "3"],
    "jacobi": ["torch_jacobi.py", "--n", "64", "--systems", "2",
               "--tol", "1e-5"],
    "quickstart": ["torch_quickstart.py", "--instances", "16", "--points",
                   "500"],
}


def _run(args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, str(ROOT / "examples" / args[0]),
                           *args[1:], *TINY], env=env, capture_output=True,
                          text=True, timeout=240)


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_prints_true_equalities(case):
    out = _run(CASES[case])
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [l for l in out.stdout.splitlines()
             if re.search(r"sequential ==|kernel ==|identical|\[T=", l)]
    assert lines, out.stdout
    for line in lines:
        assert "True" in line and "False" not in line, line
    if case.startswith("mandelbrot_"):
        assert "== cluster: mandelbrot" in out.stdout  # netlog report
        assert "warm" in out.stdout
    if case == "mandelbrot_shm":
        assert "ring slot=" in out.stdout and "inline=0" in out.stdout
    if case == "mandelbrot_kill_host":
        assert "host failure captured — recovered" in out.stdout
        assert "-- recovery --" in out.stdout
        assert "epoch 1 -> 2 (restart)" in out.stdout


@pytest.mark.parametrize("flag", [["--transport", "inprocess"],
                                  ["--transport", "jaxmesh"]])
def test_mandelbrot_refuses_what_later_slices_bring(flag):
    """What the example still refuses: ``--kill-host`` over thread hosts,
    which have no worker process to kill."""
    out = _run(["torch_mandelbrot.py", "--hosts", "2", *flag,
                "--kill-host", "0"])
    assert out.returncode == 2 and "only process hosts" in out.stderr
