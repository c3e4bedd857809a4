"""The port's cluster launcher (``python -m repro_torch.launch.cluster``) on
the CPU, and its durable lane: the JAX package's ``durability-smoke`` CI
lane with ``--device cpu``.

A fresh run prints ``== sequential oracle: True``.  The SIGKILL lane starts
the launcher with fold snapshots in its own process group, kills the whole
group as soon as the Collect's host has written a snapshot, then resumes
with ``--resume-from``: the adopted deployment replays the pending batch
from that snapshot and stays equal to the oracle.  The port's farm total
equals the JAX launcher's ``make_mandelbrot`` through ``run_sequential``
at the same flags, and every flag of a part the port has not brought yet
refuses, naming it.  Spawned hosts and launchers make this file slow, so
it stands alone for ``--dist loadfile`` to spread.
"""

import ast
import glob
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.cluster import partition
from repro_torch.core import run_sequential
from repro_torch.kernels.mandelbrot import ref
from repro_torch.launch import cluster as launcher

CPU = "cpu"
SRC = pathlib.Path(launcher.__file__).resolve().parents[2]
DEADLINE_S = 60


def _flags(iters, *, bands=8, size=64, microbatch=2):
    return ["--device", CPU, "--hosts", "2", "--transport", "pipe",
            "--workload", "mandelbrot", "--bands", str(bands), "--size",
            str(size), "--iters", str(iters), "--microbatch", str(microbatch)]


@pytest.mark.parametrize("workload,transport", [
    ("mandelbrot", "inprocess"), ("pipeline", "device"),
    ("mandelbrot", "pipe")])
def test_fresh_run_equals_the_oracle(capsys, workload, transport):
    launcher.main(["--device", CPU, "--hosts", "2", "--transport", transport,
                   "--workload", workload, "--batches", "2"])
    out = capsys.readouterr().out
    assert "CSP refinement (partitioned [T= unpartitioned, both " \
           "directions): True" in out
    assert f"{transport} over 2 hosts == sequential oracle: True" in out
    assert "batch 1 (warm)" in out and "identical=False" not in out


def test_snapshots_rendered_in_the_report(capsys, tmp_path):
    launcher.main(["--device", CPU, "--hosts", "2", "--transport", "device",
                   "--snapshot-every", "1", "--snapshot-dir",
                   str(tmp_path)])
    out = capsys.readouterr().out
    assert "sequential oracle: True" in out
    assert "-- durability --" in out and "batch 0 ok" in out
    assert sorted(os.listdir(tmp_path)) == ["host_0", "host_1", "meta"]


def _band_seconds(iters: int, bands: int = 8, size: int = 64) -> float:
    t0 = time.perf_counter()
    ref.mandelbrot(size // bands, size, max_iterations=iters,
                   row0=torch.tensor(0, dtype=torch.int32))
    return time.perf_counter() - t0


def _group_alive(pgid: int) -> list:
    """Processes of group ``pgid`` that are not zombies (a reaper-less
    container may leave the killed hosts' zombies behind)."""
    alive = []
    for stat in glob.glob("/proc/[0-9]*/stat"):
        try:
            fields = pathlib.Path(stat).read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            alive.append(stat)
    return alive


def test_sigkill_mid_batch_then_resume_from_snapshots(tmp_path):
    """The reference's durability lane: SIGKILL the launcher's whole
    process group once the Collect's host has a fold snapshot on disk,
    then ``--resume-from``: adopted at epoch 2 and refined, the pending
    batch replayed from the snapshot (a nonzero chunk for the Collect's
    host), every result equal to the oracle."""
    iters = max(2000, int(1000 * 0.3 / max(_band_seconds(1000), 1e-4)))
    print(f"iterations: {iters} (~0.3 s a band here)")
    d = str(tmp_path / "durable")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    net = launcher.make_mandelbrot(8, 64, 64, 1)
    coll = partition(net, hosts=2).assignment["collect"]
    shm_before = set(os.listdir("/dev/shm"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.cluster", *_flags(iters),
         "--snapshot-every", "1", "--snapshot-dir", d, "--batches", "1"],
        env=env, start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + DEADLINE_S
        while (not glob.glob(f"{d}/host_{coll}/step_*")
               and proc.poll() is None and time.monotonic() < deadline):
            time.sleep(0.02)
        assert proc.poll() is None, (
            "the first run ended before it could be killed mid-batch:\n"
            + proc.communicate()[0])
        assert glob.glob(f"{d}/host_{coll}/step_*"), \
            f"no fold snapshot of host {coll} within {DEADLINE_S}s"
        t_kill = time.monotonic()
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=30)
        while _group_alive(proc.pid) and time.monotonic() < t_kill + 10:
            time.sleep(0.05)
        assert not _group_alive(proc.pid), "a process of the group survived"
        # what the killed group could not unlink: its queues' semaphores
        leaked = set(os.listdir("/dev/shm")) - shm_before
    finally:
        if proc.poll() is None or _group_alive(proc.pid):
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.communicate()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", *_flags(iters),
         "--resume-from", d, "--batches", "2"],
        env=env, capture_output=True, text=True, timeout=180)
    print(r.stdout[-3000:])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.splitlines()
    (adopted,) = [ln for ln in lines if "adopted durable deployment" in ln]
    assert "epoch 2, refined=True" in adopted
    (replayed,) = [ln for ln in lines if "replayed the pending batch" in ln]
    assert "identical=True" in replayed
    replay_from = ast.literal_eval(replayed.split("replay_from=")[1])
    assert replay_from[coll] > 0, replay_from
    assert "pipe over 2 hosts == sequential oracle: True" in r.stdout
    # the adopter reclaimed them (named in the dead controller's meta)
    assert not leaked & set(os.listdir("/dev/shm")), sorted(leaked)
    print(f"/dev/shm entries the kill left: {len(leaked)}, all reclaimed")


def _render(net):
    """The farm's render and create methods (by kind name: the packages
    have an enum each)."""
    (worker,) = [p for p in net.procs.values() if p.kind.name == "WORKER"]
    (emit,) = [p for p in net.procs.values() if p.kind.name == "EMIT"]
    return worker.fn, emit.fn


def test_total_equals_the_jax_launchers_farm():
    """The port's farm total against ``repro.launch.cluster.make_mandelbrot``
    through ``run_sequential`` at the launcher's default flags: exact when
    every pixel agrees, else within the 99.9 % Mandelbrot pixel gate (the
    two packages may round a boundary pixel differently)."""
    import jax.numpy as jnp

    from repro.core import run_sequential as jrun_sequential
    from repro.launch.cluster import make_mandelbrot as jmake_mandelbrot
    args = (8, 64, 64, 40)
    net, jnet = launcher.make_mandelbrot(*args), jmake_mandelbrot(*args)
    total = run_sequential(net, 8, device=CPU)["collect"]
    jtotal = jrun_sequential(jnet, 8)["collect"]
    assert total.dtype == torch.int32
    (render, create), (jrender, jcreate) = _render(net), _render(jnet)
    img = np.concatenate([render(create(i)).numpy() for i in range(8)])
    jimg = np.concatenate([np.asarray(jrender(jnp.asarray(jcreate(i))))
                           for i in range(8)])
    same = float(np.mean(img == jimg))
    print(f"pixels equal: {same:.6f}; totals {int(total)} / {int(jtotal)}")
    assert int(total) == int(img.sum(dtype=np.int64))
    if same == 1.0:
        assert int(total) == int(jtotal)
    else:
        assert same >= 0.999
        assert abs(int(total) - int(jtotal)) <= int(
            np.abs(img.astype(np.int64) - jimg).sum())


@pytest.mark.parametrize("flags,slice_name", [
    (["--cut", "cost"], "costs.py"), (["--calibrate"], "costs.py"),
    (["--autoscale"], "autoscale.py"), (["--min-hosts", "1"], "autoscale.py"),
    (["--max-hosts", "3"], "autoscale.py"),
    (["--virtual-devices", "2"], "item 12")])
def test_later_flags_name_their_slice(flags, slice_name):
    with pytest.raises(SystemExit, match=slice_name.replace(".", r"\.")):
        launcher.parse_args(["--device", CPU, *flags])
