#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``).  It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc``, then:

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, and times kernel, plain version and (for the
   stencil) one PyTorch library call with CUDA events, in turns plain,
   kernel, kernel, plain;
2. runs the Mandelbrot farm (4096 x 2048, 64 bands of 32 rows, 1000
   iterations) sequentially, fused and streaming, which must agree exactly;
3. runs the image pipeline (16 RGB 2048 x 2048 images, grey then EDGE5) in
   the three modes, which must agree exactly;
4. solves 4 Jacobi systems of n = 4096 on the MultiCoreEngine (4 nodes,
   tol 1e-6), which must land within 1e-3 of the true solutions;
5. model-checks the Monte-Carlo pi farm with ``csp.check``, then estimates pi
   from 256 x 10^6 points in the three modes, which must agree exactly, and
   prints a logged run's netlog report;
12. (run here, after phase 5) drives the cluster runtime on the card: one
   warm ``ClusterDeployment`` of the farm at phase 2's width each over 2
   and 4 thread hosts whose tensors stay on the card (``device``) and over
   2 spawned host processes (``pipe``, and ``shm`` with 8 MiB slots), 3
   batches each, then the image pipeline at phase 3's size cut between its
   two engines over ``device``, ``pipe`` and ``shm`` (at the largest
   microbatch up to 16 whose ring fits in the free ``/dev/shm``, which it
   prints): the partition must refine the network (CSP, both directions),
   every batch must equal phases 2 and 3 exactly, thread hosts must launch
   the kernel here once a band (64 ``mandelbrot``, 16 ``stencil`` a
   batch), each spawned host checks inside its own process that every
   band launched its own Mandelbrot kernel once and is a CUDA tensor, and
   over ``shm`` every chunk must go through a slot and every segment be
   unlinked after the close.  Then the farm over 2 process hosts (``pipe``
   and ``shm``): batches 0 and 1, host 1 killed, batch 2 failing, and
   ``recover(mode="restart")`` replaying it equal to phase 2 at epoch 2
   with host 1 restarted; and the farm over 4 ``device`` hosts whose
   worker raises once in batch 1, ``recover(mode="rebalance")`` moving it
   onto a survivor, the new plan refining the network, the replay equal to
   phase 2 and launching here exactly the bands it re-streams.  It prints
   the walls, the bytes crossing the cut a batch, the ring's chunks by
   path, the recovery walls and events, the cluster reports and the
   phase's own wall; every deployment is closed and every host process
   gone before phase 6;
13. (run after phase 7, whose model it serves) durability on the card:
   13a the farm over 2 ``device`` hosts (microbatch 8) with fold snapshots
   every 2 chunks, beside the same deployment without, 5 batches each in
   turns, every batch equal to phase 2 and launching its 64 bands here;
   it prints the snapshot spans (count, median ms, bytes), the controller
   meta's persist spans and the warm walls' ratio (not gated); 13b the
   Collect raising once past its second snapshot, ``recover()`` equal to
   phase 2, the Collect's host replayed from its snapshot's chunk (> 0),
   a ``restore`` event, and exactly the re-streamed bands launched here;
   13c a fresh ``ClusterDeployment.adopt`` of 13a's closed deployment and
   a salvage adopt over a live one, each at epoch 2, refined, its next
   batch equal to phase 2 (the salvaged one building no stage); 13d
   ``python -m repro_torch.launch.cluster`` over 2 ``pipe`` hosts at
   2048², 64 bands, with ``--iters`` for a ~6 s batch, its whole process
   group SIGKILLed once the Collect's host wrote a snapshot, then
   ``--resume-from``: adopted at epoch 2 and refined, the pending batch
   replayed from the snapshot (a nonzero chunk for the Collect's host),
   the oracle equal, kill → adopted and kill → replayed result printed;
   13e qwen2-0.5b served with a store persisting every step, crashed with
   two requests done and two in flight, adopted on a fresh backend: every
   request answered once with the tokens of an uncrashed engine without a
   store; the persist span, its bytes, TPOT with and without the store and
   the adopt wall.  No host process and no new ``/dev/shm`` entry may be
   left; the phase prints its wall;
14. (run after phase 13) the fault-injection simulator on the card, its
   simulated hosts threads of this process on ``cuda``: 14a the
   JAX package's scenario families — ``run_scenario`` for seeds 0-19 but
   5, 7 and 9 (all five fault kinds; those three wait out two 8 s
   ``recv`` timeouts each and run in the CPU tests),
   ``run_kill_controller_scenario`` for each of its five variants,
   ``run_stall_race_scenario`` for seeds 0 and 1,
   ``run_coalesce_kill_scenario`` for seeds 0-5 and
   ``run_pipe_brick_scenario`` over real ``pipe`` host processes, every
   one ``ok`` (each family prints its scenarios, faults fired,
   recoveries, median and max virtual ticks and wall); 14b the Mandelbrot
   farm at phase 2's width over 2 simulated hosts (microbatch 16) under
   ``FaultSchedule.random`` for 4 seeds (a kill, a double kill, a
   controller-step kill and a kill during recovery; restart and rebalance
   in turns): a cold batch, then the schedule armed and 2 batches, each
   recovered as the faults demand, every batch equal to phase 2, every
   recovery refined, the epoch chain refining, no record delivered twice,
   no stage built on an untouched host, the merged trace conforming, and
   at least 64 launches here a batch; it prints the launches, the bands
   launched beyond one a band a batch, the kill -> recovered-result wall
   and what a result's round trip through host bytes costs.  No host
   thread, host process or new ``/dev/shm`` entry may be left; the phase
   prints its wall;
15. (run after phase 14) the cost model and the autoscaler on the card:
   15a ``calibrate`` of the Mandelbrot farm at phase 2's width (microbatch
   16) and of the image pipeline at phase 3's size (microbatch 4) on
   ``cuda``, with the ``device``, ``pipe`` and ``shm`` bandwidths: every
   stage measured, each profile printed, the farm's render stage beside
   16 x phase 1's band and the EDGE5 engine beside 4 x phase 1's EDGE5
   (ratios printed, not gated); then for each network the count cut and
   the cost cut over 2 and 4 ``device`` hosts, 3 batches each, every
   batch equal to phases 2 and 3, each plan refining the network, the
   launches of phase 12, the warm walls side by side and whether the two
   cuts differ; and the count cut hot-swapped to the cost cut through
   ``reconfigure(plan=)``, refined, its next batch equal; 15b ``python -m
   repro_torch.launch.cluster`` over 2 ``device`` hosts at 4096², 64
   bands, 1000 iterations, with ``--cut cost --calibrate --autoscale
   --batches 4``: every batch ``identical=True``, the oracle equal, its
   profile and autoscale events printed; 15c ``run_workload_scenario``
   for seeds 0-5 on ``cuda`` (two spikes, two stragglers, two slow
   starts), every one ``ok``, a spike and a straggler with one epoch bump
   each, a slow start with none. No host thread, host process or new
   ``/dev/shm`` entry may be left; the phase prints its wall;
16. (run after phase 15, on phase 6's weights) the clustered decode farm
   serving full-width qwen2-0.5b with phase 7's 8 requests (4 slots in 2
   shards of 2 rows, max_len 128, prefill chunks of 8): 16a the farm over
   2 ``device`` hosts and over 2 ``pipe`` host processes, whose token
   streams must be identical to each other and to a local engine of 2
   slots (the shards' decode shape) on the same weights (on a difference
   it prints the first differing request and step with the top-2 logit
   margin there), every request joining and leaving once; how many equal
   phase 7's 4-slot run and the one-slot oracle is printed, not gated;
   16b ``scale(3)`` over ``device`` after the first step: ``reconfigure``,
   refined, epoch 2, streams equal 16a; 16c host 1 of 2 ``pipe`` hosts
   killed after step 3: the next step recovers, streams equal 16a, the
   kill → step-done wall printed; 16d a durable farm over ``device``
   closed after 4 steps and adopted by a fresh backend: every request
   answered once, streams equal 16a, the persist spans' bytes printed;
   16e ``python -m repro_torch.cluster.sim --serve-kill 12`` on the card,
   every scenario ok; 16f ``python -m repro_torch.launch.serve --arch
   qwen2-0.5b --hosts 2 --transport device --autoscale``.  For each run
   it prints tok/s, TTFT and TPOT p50/p99, the farm's decode step against
   phase 7's local step and the bytes across the cut a decode step.  No
   kernel may launch in the phase, and no host thread, host process or
   new ``/dev/shm`` entry may be left; the phase prints its wall;
6. runs ``Model.forward`` of the full-width qwen2-0.5b (24 layers, random
   weights from seed 0) on a (4, 2048) batch of seeded tokens: in bf16 (the
   default config) the logits must be finite; in float32 its logits at
   positions 1023 and 1024 must agree within 3e-3 with ``prefill`` of the
   first 1024 tokens and one ``decode_step`` (the reference's
   forward-against-decode gate, which holds the flash-kernel path against
   the KV-cache path); every forward must launch the flash kernel once per
   layer;
7. serves 8 requests through ``python -m repro_torch.launch.serve``'s
   ``main`` (full-width qwen2-0.5b, 4 slots, max_len 128, max_new 16): every
   request must complete with its token count and exactly one join and one
   leave; it prints tokens/s, TTFT and TPOT, and how many requests give the
   same tokens decoded alone in a one-slot engine (printed, not gated);
8. runs ``Model.forward`` of the full-width mamba2-2.7b (64 Mamba2 layers)
   and zamba2-1.2b (38 Mamba2 layers and one shared attention block applied
   6 times) on (4, 2048) seeded tokens, with the checks of phase 6: finite
   bf16 logits, f32 logits against ``prefill`` of 1024 tokens (which runs
   the SSD kernel and hands its final state to the decode recurrence) and
   one ``decode_step`` within 3e-3, and each forward launching the SSD
   kernel once per Mamba2 layer (64; 38) and the flash kernel once per
   shared-block application (0; 6);
9. serves mamba2-2.7b through the launcher's ``main`` as in phase 7.
   Serving launches no kernel: the engine feeds prompts one token a step,
   so every Mamba2 layer takes the O(1) decode recurrence and every
   attention layer the KV-cache einsums, as in the JAX package;
17. (run after phase 9) full-width whisper-tiny (4 encoder and 4 decoder
   layers, d=384, 6/6 heads, vocab 51865; f32 weights from seed 0, 4096
   decoder positions) on 4 utterances of 1500 seeded stub frames (30 s
   windows): a bf16 ``forward`` on (4, 448) tokens with finite logits and
   exactly 12 flash launches (encoder, decoder self- and
   cross-attention); the f32 forward against ``prefill`` of 224 tokens
   and one ``decode_step`` within 3e-3, and against the same forward on
   the CPU (the plain path) within 1e-3; then greedy decoding in bf16
   from whisper's 4-token start-of-transcript prompt, 124 steps, max_len
   448: ``prefill`` launching flash 8 times (encoder and cross-attention)
   and every decode step 4 (cross-attention), with encode and prefill ms,
   the decode step's p50 / p99, tokens/s and the phase's wall printed;
10. frees every earlier model, then runs ``Model.forward`` of the
   full-width deepseek-moe-16b (28 layers, d=2048, 16/16 heads, 64 routed
   experts of 1408 with top-6 and 2 shared, layer 0 dense at d_ff 10944,
   vocab 102400; f32 weights from seed 0, 61 GiB) on (4, 2048) seeded
   tokens, on the ragged path (``moe_ragged=True``), with the checks of
   phase 6: finite bf16 logits, f32 logits against ``prefill`` of 1024
   tokens and one ``decode_step`` within 3e-3 (the ragged path drops
   nothing), and each forward launching the grouped-matmul kernel 3 times
   a MoE layer (81) and the flash kernel once a layer (28); then one bf16
   forward on the capacity path (the config's default, no grouped matmul),
   timed, with the share of token-choices it drops at capacity factor
   1.25 (not gated: it is not dropless, so it differs from the ragged
   path);
11. serves deepseek-moe-16b on the ragged path through a ``ServeEngine``
   over ``LocalDecodeBackend`` (4 slots, max_len 128) on phase 10's
   weights (the launcher's ``main`` would build a second copy) with the
   checks of phase 7; every decode step launches the grouped matmul 81
   times and nothing else.

Peak and free device memory are printed after each MoE phase.

Phase 1 times each Mandelbrot band on its own as well (the fastest and
slowest band beside the mean) and prints the share of lane-steps that do
work in the full image's 32-pixel chunks.  It holds the stencil kernel
exact at k = 1, 7, 9 (template instances) and 11 (the runtime-k kernel),
in float32, bfloat16 and float16, at widths whose rows are not whole
16-byte copies (element-wise tile loads), on one pixel and on fewer rows
than k, and times it on 2048 x 2048 images in the three types (EDGE5 and
random taps); the flash-attention kernel
against its plain version on the qwen2 forward's shape (B=4, H=14, K=2,
S=2048, D=64) and deepseek's (B=4, H=16, K=16, D=128), the reference
tests' shapes, and without causality at an encoder's (Sq = Sk) and
cross-attention's shapes (Sq = 1 and 1 < Sq < Sk), in float32 (the FMA
path) and bf16 (the tensor cores), timed at both forward shapes and at
whisper-tiny's encoder (4, 6, 6, 1500, 1500, 64) and decode-step
cross-attention (Sq = 1 against 1500 frames) without causality, beside
``scaled_dot_product_attention`` (the yardstick; the port never calls it);
the SSD-scan kernel, y and final state, on the mamba2 and zamba2
forwards' shapes, the reference tests' shapes, a ragged S, G = H, and P >
64 and N > 128 (split by the op into several launches), bf16 (the tensor
cores) also to gates scaled to the output (no PyTorch call computes the
scan, so it has no yardstick); and the grouped
expert matmul at deepseek-moe-16b's forward shape (8192 tokens, top-6 of
64 experts, D 2048 → F 1408, and the down product), with uniform and
one-expert routing, at a decode step's 24 rows, at the reference tests'
shapes and at 4.3 M rows (past the 65,535 row blocks a grid.y held), timed
beside ``torch._grouped_mm`` (the yardstick) at the forward's and the
decode's shapes, both as the op (routing included) and as the kernel's
launch alone on the sorted rows (what ``torch._grouped_mm`` is timed on).
It holds uint8 and int32 2048 x 2048 stencil images (EDGE5 and random
k = 3 taps, sums out of the type's range both ways) exactly against the
plain version.  It counts the tensor-core instructions (HMMA/HGMMA lines
of ``cuobjdump -sass``) in the flash, grouped-matmul and SSD libraries,
which must be above 0, and checks that each of the four kernel ops raises under grad mode
for an input that requires grad, before any launch.  It then holds, each
as one launch against the plain version, what the ops once refused on the
card: float16 flash attention (D = 48 padded, and the qwen2 shape, timed),
bf16 rows not 16-byte aligned and a strided head dim; the float16 SSD scan
with bf16 dt and A, strided P and N, at mamba2's shape (timed), and S = 0
(no launch); the float16 grouped matmul at deepseek's up shape with f32,
bf16 and f16 w (timed) and a strided w; and bool and transposed stencil
images.

Kernel launch counts are reset just before phase 2 and read after phase 9
(the thread hosts of phases 12, 13 and 15 and the simulated hosts of
phases 14 and 15 count with them; phase 16, which must launch nothing, is
counted apart, from 0; phase 17 is counted apart, from 0, and added),
and reset again just before phase 10 and read after phase 11: each kernel
must have been launched by one of the two paths.  One more fused run of
the farm, of the pipeline, one more bf16 forward and one decode step of
qwen2-0.5b and of mamba2-2.7b, one more zamba2-1.2b forward and one more
whisper-tiny decode step are traced with ``torch.profiler`` after phase
17, and one bf16 forward and one decode step of deepseek-moe-16b after
phase 11, to print the device's busy time, idle share and each of the
port's kernels' share of the busy time.  The last two lines are a JSON
summary of the kernels and ``{"ok": true, "device": ...}``.  Any failure
raises and the script exits non-zero; so does a machine without a CUDA
device, where nothing is printed on standard output.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

F32_PEAK = 67e12      # H100 SXM f32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12    # H100 SXM dense bf16 tensor-core FLOP/s
HBM_RATE = 3.35e12    # H100 SXM device-memory bytes/s
L2_BYTES = 50 * 2**20
SLEEP_CYCLES = 200_000_000  # ~100 ms at the H100's ~2 GHz clock
LAUNCH_PREFILL_CHUNK = 8    # LocalDecodeBackend's default prefill_chunk


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing --------------------------------------------------------------------

def timed_turns(torch, fns: dict, reps: dict, flush=None) -> dict:
    """Median ms per call of each function, timed with CUDA events in turns
    plain, kernel, kernel, plain (library calls ride with the kernel turns).
    ``flush`` runs before every timed call, outside the events.

    Each turn starts behind a 100 ms device sleep, so the host queues the
    calls ahead of the device and the events time the device's work, not
    the host's Python between launches (a plain version that issues more
    launches than the sleep covers is timed with its launch cost)."""
    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    order = ["plain", "kernel", "kernel", "plain"]
    samples: dict = {k: [] for k in fns}
    for turn in order:
        names = [turn] + ([n for n in fns if n not in ("plain", "kernel")]
                          if turn == "kernel" else [])
        for name in names:
            events = []
            torch.cuda._sleep(SLEEP_CYCLES)
            for _ in range(reps[name]):
                if flush is not None:
                    flush()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[name]()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            samples[name].extend(s.elapsed_time(e) for s, e in events)
    return {k: statistics.median(v) for k, v in samples.items()}


def host_cost_us(torch, fn, calls_per_fn: int, reps: int = 5) -> float:
    """Host microseconds per wrapper call, measured while the device sleeps
    (so no launch waits on a full queue)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / (reps * calls_per_fn) * 1e6


# the port's kernels by the names of their CUDA functions
KERNEL_SYMBOLS = {"flash_attention": ("flash_mma_kernel<", "flash_kernel<"),
                  "moe_gmm": ("gmm_mma_kernel<", "gmm_kernel<"),
                  "ssd_scan": ("ssd_mma_kernel<", "ssd_kernel<"),
                  "stencil": ("stencil_kernel<", "stencil_any_k_kernel<"),
                  "mandelbrot": ("mandelbrot_kernel",)}


def profile_run(torch, label: str, fn) -> None:
    """One run under ``torch.profiler``: its wall, the device's busy time
    (kernels and copies) and idle share, the host ops that took most time,
    the device kernels that took most time, and each of the port's
    kernels' time, launches and share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in avgs
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)) / 1e3
    top = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:4]
    print(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device "
          f"busy {busy_ms:.2f} ms, idle {1 - busy_ms / wall_ms:.1%}; top "
          "host ops: " + ", ".join(
              f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
              for e in top))
    dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.self_device_time_total, reverse=True)[:4]
    print(f"[profile] {label}: top device kernels: " + ", ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
        for e in dev))
    shares = []
    for name, symbols in KERNEL_SYMBOLS.items():
        hits = [e for e in avgs if e.device_type == DeviceType.CUDA
                and any(sym in e.key for sym in symbols)]
        if hits:
            ms = sum(e.self_device_time_total for e in hits) / 1e3
            shares.append(f"{name} {ms:.2f} ms x{sum(e.count for e in hits)}"
                          f" ({ms / busy_ms:.1%} of busy)")
    if shares:
        print(f"[profile] {label}: kernel shares: " + ", ".join(shares))


def bound(flops: float, nbytes: float,
          peak: float = F32_PEAK) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# -- phase 1: kernels against their plain versions -------------------------------

def check_mandelbrot(torch, dev, W, H, bands, iters) -> dict:
    from repro_torch.kernels.mandelbrot import ops, ref
    band_h, delta = H // bands, 3.0 / W
    kw = dict(x0=-2.2, y0=-1.15, pixel_delta=delta, max_iterations=iters)
    rows0 = [torch.tensor(b * band_h, dtype=torch.int32, device=dev)
             for b in range(bands)]
    err, escaped_work = 0, 0
    for r0 in rows0:
        got = ops.mandelbrot(band_h, W, row0=r0, **kw)
        want = ref.mandelbrot(band_h, W, row0=r0, **kw)
        err = max(err, int((got - want).abs().max()))
        escaped_work += int(got.sum()) + int((got < iters).sum())
    check(err == 0, f"mandelbrot kernel differs from its plain version "
                     f"(max |diff| {err})")

    def sweep(fn):  # every band of the farm, one call each
        return lambda: [fn(band_h, W, row0=r0, **kw) for r0 in rows0]

    t = timed_turns(torch, {"plain": sweep(ref.mandelbrot),
                            "kernel": sweep(ops.mandelbrot)},
                    {"plain": 1, "kernel": 5})
    ms, plain_ms = t["kernel"] / bands, t["plain"] / bands
    bound_ms, bound_by = bound(9.0 * escaped_work / bands,
                               band_h * W * 4)
    host_us = host_cost_us(torch, sweep(ops.mandelbrot), bands)
    # each band on its own (median of 5 sweeps), so imbalance between bands
    # shows beside the mean
    events = [[] for _ in rows0]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for _ in range(5):
        for evs, r0 in zip(events, rows0):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ops.mandelbrot(band_h, W, row0=r0, **kw)
            end.record()
            evs.append((start, end))
    torch.cuda.synchronize()
    band_ms = [statistics.median(s.elapsed_time(e) for s, e in evs)
               for evs in events]
    print(f"[kernel] mandelbrot band ({band_h}, {W}) x {bands} bands, "
          f"{iters} it: exact; kernel {ms:.4f} ms/band (fastest "
          f"{min(band_ms):.4f}, slowest {max(band_ms):.4f} ms), plain "
          f"{plain_ms:.3f} ms/band, library none, bound {bound_ms:.4f} ms "
          f"({bound_by}; {9 * escaped_work:.3e} f32 ops over the farm), "
          f"roofline {bound_ms / ms:.1%}; host {host_us:.1f} us/call")

    full_k = ops.mandelbrot(H, W, **kw, device=dev)
    full_p = ref.mandelbrot(H, W, **kw, device=dev)
    check(torch.equal(full_k, full_p), "full-image mandelbrot differs")
    work = int(full_k.sum()) + int((full_k < iters).sum())
    tf = timed_turns(torch, {"plain": lambda: ref.mandelbrot(
                                 H, W, **kw, device=dev),
                             "kernel": lambda: ops.mandelbrot(
                                 H, W, **kw, device=dev)},
                     {"plain": 1, "kernel": 5})
    fb, fby = bound(9.0 * work, H * W * 4)
    # a warp's 32 pixels of a row step until the slowest escapes: the share
    # of those lane-steps that do work
    chunks = full_k.view(H, W // 32, 32).double()
    busy = float(chunks.sum() / (32 * chunks.amax(-1).sum()))
    print(f"[kernel] mandelbrot full ({H}, {W}), {iters} it: exact; kernel "
          f"{tf['kernel']:.4f} ms, plain {tf['plain']:.3f} ms, bound "
          f"{fb:.4f} ms ({fby}), roofline {fb / tf['kernel']:.1%}; lanes "
          f"busy {busy:.1%} of their 32-pixel chunks' steps")
    return {"name": "mandelbrot", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mandelbrot.cu",
            "replaces": "src/repro/kernels/mandelbrot/kernel.py:20",
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_stencil(torch, dev) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.stencil import ops, ref
    from repro_torch.workloads import EDGE5
    torch.backends.cudnn.allow_tf32 = False
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(0)
    entry = None
    f16 = torch.float16
    cases = [((2048, 2048), 5, torch.float32, EDGE5),
             ((2048, 2048), 3, torch.float32, None),
             ((2048, 2048), 5, torch.bfloat16, None),
             ((2048, 2048), 3, torch.bfloat16, None),
             ((2047, 2048), 5, torch.float32, None),
             ((2048, 2048), 5, torch.bfloat16, EDGE5),
             ((2048, 2048), 5, f16, EDGE5),
             ((2048, 2048), 5, f16, None)]
    # every odd k is exact against the plain version: 1, 7 and 9 are
    # template instances, 11 takes the runtime-k kernel; rows that are not
    # whole 16-byte copies (W % 4 for f32, W % 8 for bf16 and f16) take
    # the element-wise tile loads; one pixel, H < k, and zero taps (the
    # skipping instance; EDGE5 takes the ring instance) (not timed)
    f32, bf16 = torch.float32, torch.bfloat16
    laplace = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))
    for (H, W), k, dtype, taps in (((2048, 2048), 1, f32, None),
                                   ((2048, 2048), 7, f32, None),
                                   ((2047, 2048), 9, bf16, None),
                                   ((1000, 777), 11, f32, None),
                                   ((2048, 2046), 5, f32, EDGE5),
                                   ((2047, 2044), 5, f16, None),
                                   ((1000, 777), 7, f16, None),
                                   ((1000, 777), 11, f16, None),
                                   ((1, 1), 5, f32, EDGE5),
                                   ((3, 2048), 9, f16, None),
                                   ((2048, 2048), 3, f32, laplace)):
        if taps is None:
            taps = ops.taps_of(torch.randn(k, k, generator=g))
        img = torch.randn(H, W, generator=g).to(dtype).to(dev)
        got, want = ops.stencil2d(img, taps), ref.stencil2d(img, taps)
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want), f"stencil ({H}, {W}) k={k} {dtype}: "
                                      f"not exact, max |diff| {err}")
        print(f"[kernel] stencil ({H}, {W}) k={k} {str(dtype)[6:]}: exact")
    # integer images: converted to float32, the float32 kernel, converted
    # back saturating as XLA does; random images over the type's range, so
    # EDGE5's sums and random k = 3 taps x 3 leave it both ways (not timed)
    for dtype in (torch.uint8, torch.int32):
        info = torch.iinfo(dtype)
        for k, taps in ((5, EDGE5), (3, ops.taps_of(
                3.0 * torch.randn(3, 3, generator=g)))):
            img = torch.randint(info.min, info.max, (2048, 2048), generator=g,
                                dtype=torch.int64).to(dtype).to(dev)
            got, want = ops.stencil2d(img, taps), ref.stencil2d(img, taps)
            sat = (int((want == info.max).sum()), int((want == info.min).sum()))
            check(got.dtype == dtype and torch.equal(got, want),
                  f"stencil (2048, 2048) k={k} {dtype}: not exact")
            check(min(sat) > 0, f"stencil {dtype} k={k}: sums saturate "
                                f"only one way {sat}")
            print(f"[kernel] stencil (2048, 2048) k={k} {str(dtype)[6:]}: "
                  f"exact; {sat[0]} pixels at the type's max, {sat[1]} at "
                  "its min")
    for (H, W), k, dtype, taps in cases:
        if taps is None:
            taps = ops.taps_of(torch.randn(k, k, generator=g))
        img = torch.randn(H, W, generator=g).to(dtype).to(dev)
        got, want = ops.stencil2d(img, taps), ref.stencil2d(img, taps)
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want),
              f"stencil ({H}, {W}) k={k} {dtype}: max |diff| {err}")
        weight = torch.tensor(taps, dtype=dtype, device=dev)[None, None]
        t = timed_turns(
            torch, {"plain": lambda: ref.stencil2d(img, taps),
                    "kernel": lambda: ops.stencil2d(img, taps),
                    "library": lambda: F.conv2d(img[None, None], weight,
                                                padding=k // 2)},
            {"plain": 10, "kernel": 20, "library": 20},
            flush=flush_buf.zero_)
        host_us = host_cost_us(torch, lambda: ops.stencil2d(img, taps), 1,
                               reps=20)
        nnz = sum(w != 0.0 for row in taps for w in row)
        bound_ms, bound_by = bound(2.0 * nnz * H * W,
                                   2.0 * H * W * img.element_size())
        print(f"[kernel] stencil ({H}, {W}) k={k} {str(dtype)[6:]}: "
              f"{'exact' if torch.equal(got, want) else f'max|diff| {err}'}"
              f"; kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"library(conv2d) {t['library']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), roofline "
              f"{bound_ms / t['kernel']:.1%}; host {host_us:.1f} us/call")
        if entry is None:  # the main path's case: EDGE5 on f32 2048 x 2048
            entry = {"name": "stencil", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/stencil.cu",
                     "replaces": "src/repro/kernels/stencil/kernel.py:31",
                     "max_abs_err": err, "ms": t["kernel"],
                     "plain_ms": t["plain"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": t["library"]}
    return entry


# Flash gates scaled to the output they compare.  Near-uniform softmax over
# ~1,000 keys leaves |o| ~ 0.03, below the absolute 5e-2: a kernel that
# dropped a kv tile or mis-scaled a rescale would pass that alone.
REL_MAX = 2e-2  # max |got - want| / max |want| (bf16 flash and SSD)
REL_RMS = 1e-2  # ||got - want|| / ||want||


def scaled_errors(got, want) -> tuple:
    """(max |got - want|, max |want|, ||got - want|| / ||want||), in f32."""
    got, want = got.float(), want.float()
    diff = got - want
    return (float(diff.abs().max()), float(want.abs().max()),
            float(diff.norm() / want.norm()))


def check_flash(torch, dev) -> dict:
    """The flash kernel against its plain version: the qwen2 and deepseek
    forwards' shapes and the reference tests' shapes, f32 and bf16, causal;
    an encoder's and cross-attention's shapes without causality; times at
    the two forwards' shapes and whisper-tiny's encoder and cross-attention
    shapes (bf16: the tensor-core path)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(0)
    path = (4, 14, 2, 2048, 2048, 64)  # qwen2-0.5b: GQA group of 7, D=64
    deepseek = (4, 16, 16, 2048, 2048, 128)  # deepseek-moe-16b: MHA, D=128
    causal_shapes = [path, deepseek, (1, 4, 2, 64, 64, 32),
                     (2, 8, 1, 96, 96, 64), (2, 4, 4, 128, 128, 32),
                     (1, 2, 2, 33, 33, 16),  # ragged
                     (2, 4, 2, 1, 80, 32)]   # decode
    # without causality: an encoder (Sq = Sk) and cross-attention (Sq = 1
    # against 1500 frames; 1 < Sq < Sk), as whisper's encoder and decoder
    # would call it
    whisper_enc, whisper_cross = (4, 6, 6, 1500, 1500, 64), \
        (4, 6, 6, 1, 1500, 64)
    open_shapes = [whisper_enc, whisper_cross, (2, 8, 2, 77, 300, 128)]
    # the shapes timed in bf16, beside scaled_dot_product_attention: the
    # forwards of phases 6 and 10, and whisper-tiny's (phase 17) encoder
    # and a decode step's cross-attention over 1500 frames
    timed = {(path, True): "qwen2-0.5b", (deepseek, True): "deepseek-moe-16b",
             (whisper_enc, False): "whisper-tiny encoder",
             (whisper_cross, False): "whisper-tiny decode step's "
                                     "cross-attention"}
    cases = [(s, True) for s in causal_shapes] + \
        [(s, False) for s in open_shapes]
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        # bf16: the plain version rounds its normalised probabilities to
        # bf16 before the PV product (as the JAX oracle does), the kernel
        # its unnormalised ones -- hence the reference's looser bf16 gate,
        # kept as the outer bound beside the gates scaled to the output
        tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
        for (B, H, K, Sq, Sk, D), causal in cases:
            q = (torch.randn(B, H, Sq, D, generator=g) * 0.3).to(dtype).to(dev)
            k = (torch.randn(B, K, Sk, D, generator=g) * 0.3).to(dtype).to(dev)
            v = torch.randn(B, K, Sk, D, generator=g).to(dtype).to(dev)
            got = ops.mha(q, k, v, causal=causal)
            want = ref.mha(q, k, v, causal=causal)
            err, scale, rel_rms = scaled_errors(got, want)
            del got, want
            name = (f"flash ({B}, {H}, {K}, {Sq}, {Sk}, {D}) causal={causal} "
                    f"{dtype}")
            check(err <= tol, f"{name}: max |diff| {err} > {tol}")
            check(err <= REL_MAX * scale,
                  f"{name}: max |diff| {err} > {REL_MAX} x max|want| "
                  f"{scale}")
            check(rel_rms <= REL_RMS,
                  f"{name}: |got - want| / |want| {rel_rms} > {REL_RMS}")
            route = ("tensor cores" if kernel.tensor_core_path(dtype, D)
                     else "FMA")
            print(f"[kernel] flash_attention B={B} H={H} K={K} Sq={Sq} "
                  f"Sk={Sk} D={D} {str(dtype)[6:]} causal={causal} "
                  f"({route}): max|diff| {err:.3e} (gates {tol} and "
                  f"{REL_MAX} x max|want| {scale:.3e}), |got - want| / "
                  f"|want| {rel_rms:.3e} (gate {REL_RMS})")
            shape = (B, H, K, Sq, Sk, D)
            label = timed.get((shape, causal))
            if label is None or dtype != torch.bfloat16:
                continue
            t = timed_turns(
                torch, {"plain": lambda: ref.mha(q, k, v, causal=causal),
                        "kernel": lambda: ops.mha(q, k, v, causal=causal),
                        "library": lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=causal, enable_gqa=True)},
                {"plain": 3, "kernel": 10, "library": 10},
                flush=flush_buf.zero_)
            pairs = B * H * (sum(min(Sk, i + Sk - Sq + 1) for i in range(Sq))
                             if causal else Sq * Sk)
            flops = 4.0 * D * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
            print(f"[kernel] flash_attention {label} shape bf16: kernel "
                  f"{t['kernel']:.4f} ms ({flops / t['kernel'] / 1e9:.1f} "
                  f"TFLOP/s), plain {t['plain']:.4f} ms, library(sdpa) "
                  f"{t['library']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; {flops:.3e} "
                  f"{'causal ' if causal else ''}FLOP at the bf16 peak, "
                  f"{nbytes / 1e6:.2f} MB), "
                  f"roofline {bound_ms / t['kernel']:.1%}")
            if shape == path:
                entry = {"name": "flash_attention", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                         "replaces": "src/repro/kernels/flash_attention/"
                                     "kernel.py:32",
                         "max_abs_err": err, "ms": t["kernel"],
                         "plain_ms": t["plain"], "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": t["library"]}
    del flush_buf
    return entry


def ssd_work(b, S, H, P, G, N, chunk=64) -> float:
    """FLOP of the SSD scan: C·Bᵀ once per group over the causal pairs of
    each chunk, W·x over the same pairs per head, C·h and the state update
    N·P multiply-adds a step per head."""
    rows = [chunk] * (S // chunk) + ([S % chunk] if S % chunk else [])
    pairs = sum(r * (r + 1) // 2 for r in rows)
    return 2.0 * b * G * N * pairs + b * H * (2.0 * P * pairs
                                              + 4.0 * N * P * S)


def check_ssd(torch, dev) -> dict:
    """The SSD kernel against its plain version, y and the final state: the
    mamba2 and zamba2 forwards' shapes, the reference tests' shapes, ragged
    S, G = H, and P > 64 and N > 128 (several launches a call); times at
    the mamba2 forward's shape.  bf16 y is also held to gates scaled to the
    output (as flash is): max |diff| <= 2e-2 max |want| and ||diff|| <=
    1e-2 ||want||."""
    from repro_torch.kernels.ssd_scan import ops, ref
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    path = (4, 2048, 80, 64, 1, 128)  # (batch, S, H, P, G, N) of mamba2-2.7b
    zamba = (4, 2048, 64, 64, 1, 64)
    ref_shape = (1, 64, 2, 8, 2, 4)   # tests/test_kernels.py: BH 2, own B, C
    # (shape, dtype, chunk of the plain version, (rtol, atol)).  bf16: both
    # sides sum in f32 and round y to bf16 once, so a rounding flip costs one
    # ulp (2^-8 of |y|); the f32 state is then held to 2e-4
    cases = [(path, bf16, 64, (1e-2, 5e-2)), (zamba, bf16, 64, (1e-2, 5e-2)),
             (path, f32, 64, (2e-4, 2e-4)), (zamba, f32, 64, (2e-4, 2e-4)),
             (ref_shape, f32, 16, (1e-4, 1e-5)),
             (ref_shape, f32, 32, (1e-4, 1e-5)),
             ((1, 2047, 80, 64, 1, 128), bf16, 64, (1e-2, 5e-2)),  # ragged
             ((2, 33, 4, 16, 4, 16), f32, 16, (2e-4, 2e-4)),       # ragged
             ((2, 256, 8, 64, 8, 128), f32, 64, (2e-4, 2e-4)),     # G = H
             # wider than one launch: P-slices, N-blocks, both
             ((2, 512, 8, 130, 1, 128), bf16, 64, (1e-2, 5e-2)),
             ((2, 512, 8, 64, 2, 256), bf16, 64, (1e-2, 5e-2)),
             ((1, 300, 4, 80, 1, 160), f32, 64, (2e-4, 2e-4)),
             ((1, 300, 4, 80, 1, 160), bf16, 64, (1e-2, 5e-2))]
    entry = None
    for shape, dtype, chunk, (rtol, atol) in cases:
        b, S, H, P, G, N = shape
        x = torch.randn(b, S, H, P, generator=g).to(dtype).to(dev)
        dt = (torch.rand(b, S, H, generator=g) * 0.1).to(dev)
        A = (-torch.rand(H, generator=g) - 0.1).to(dev)
        B = (torch.randn(b, S, G, N, generator=g) * 0.3).to(dtype).to(dev)
        C = (torch.randn(b, S, G, N, generator=g) * 0.3).to(dtype).to(dev)
        before = ops.ssd.launches
        y, hT = ops.ssd(x, dt, A, B, C, chunk=chunk, return_state=True)
        pieces = ops.ssd.launches - before
        check(pieces == -(-P // 64) * -(-N // 128),
              f"ssd {shape}: {pieces} launches")
        want_y, want_h = ref.ssd(x, dt, A, B, C, chunk=chunk,
                                 return_state=True)
        err = float((y.float() - want_y.float()).abs().max())
        err_h = float((hT - want_h).abs().max())
        htol = (rtol, atol) if dtype == f32 else (2e-4, 2e-4)
        for got, want, (rt, at), what in ((y.float(), want_y.float(),
                                           (rtol, atol), "y"),
                                          (hT, want_h, htol, "hT")):
            excess = float(((got - want).abs()
                            - (at + rt * want.abs())).max())
            check(excess <= 0, f"ssd {shape} {dtype} chunk {chunk}: {what} "
                               f"outside rtol {rt} / atol {at} by {excess}")
        _, scale, rel_rms = scaled_errors(y, want_y)
        scaled = ""
        if dtype == bf16:
            name = f"ssd {shape} bf16"
            check(err <= REL_MAX * scale,
                  f"{name}: max |diff| {err} > {REL_MAX} x max|want| "
                  f"{scale}")
            check(rel_rms <= REL_RMS,
                  f"{name}: |y - want| / |want| {rel_rms} > {REL_RMS}")
            scaled = (f"; {err / scale:.2%} of max|want| {scale:.3e} (gate "
                      f"{REL_MAX:.0%}), |y - want| / |want| "
                      f"{rel_rms:.3e} (gate {REL_RMS})")
        print(f"[kernel] ssd_scan batch={b} S={S} H={H} P={P} G={G} N={N} "
              f"{str(dtype)[6:]} ({pieces} launch{'es' if pieces > 1 else ''}"
              f"): max|diff| y {err:.3e} (rtol {rtol}, atol {atol}), hT "
              f"{err_h:.3e} (rtol {htol[0]}, atol {htol[1]}){scaled}")
        del y, hT, want_y, want_h
        if shape != path or dtype != bf16:
            continue
        t = timed_turns(
            torch, {"plain": lambda: ref.ssd(x, dt, A, B, C),
                    "kernel": lambda: ops.ssd(x, dt, A, B, C)},
            {"plain": 3, "kernel": 10}, flush=flush_buf.zero_)
        flops = ssd_work(*shape)
        nbytes = (2 * x.numel() + B.numel() + C.numel()) * x.element_size() \
            + (dt.numel() + A.numel()) * 4
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        print(f"[kernel] ssd_scan path shape bf16: kernel {t['kernel']:.4f} "
              f"ms, plain {t['plain']:.4f} ms, library none, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
              f"{flops:.3e} FLOP at the bf16 peak), roofline "
              f"{bound_ms / t['kernel']:.1%}")
        entry = {"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan/kernel.py:25",
                 "max_abs_err": err, "ms": t["kernel"],
                 "plain_ms": t["plain"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None}
    del flush_buf
    return entry


def gmm_bound(x, eo, w) -> tuple[float, str]:
    """Bound of one grouped product: 2·rows·D·F operations at the peak of
    x's type; bytes of x, the routing, the experts this routing hits and y,
    each once."""
    rows, D = x.shape
    F = w.shape[2]
    hit = int(eo.unique().numel())
    nbytes = (rows * (D + F) * x.element_size()
              + eo.numel() * eo.element_size()
              + hit * D * F * w.element_size())
    peak = F32_PEAK if x.element_size() == 4 else BF16_PEAK
    return bound(2.0 * rows * D * F, nbytes, peak)


def grouped_mm_call(torch, x, eo, w):
    """``torch._grouped_mm`` on the same rows sorted by expert, bf16 (the
    yardstick; the port never calls it), or (None, why not)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "this PyTorch has no torch._grouped_mm"
    order = torch.argsort(eo, stable=True)
    xs = x[order].bfloat16().contiguous()
    counts = torch.zeros(w.shape[0], dtype=torch.long, device=x.device) \
        .scatter_add_(0, eo.long(), torch.ones_like(eo, dtype=torch.long))
    offs = torch.cumsum(counts, 0).to(torch.int32)
    wb = w.bfloat16()
    try:
        fn(xs, wb, offs=offs)
        torch.cuda.synchronize()
    except Exception as exc:  # a refused layout is reported, not fatal
        return None, f"torch._grouped_mm refused: {exc}"[:200]
    return (lambda: fn(xs, wb, offs=offs)), ""


def check_moe_gmm(torch, dev) -> dict:
    """The grouped-matmul kernel against its plain version: deepseek-moe-16b's
    products at its forward shape (8192 tokens, top-6 of 64 experts, D 2048
    → F 1408 and the down product F → D) with uniform and one-expert
    routing, a decode step's 24 rows, and the reference tests' shapes;
    times at the forward's and the decode's shapes."""
    from repro_torch.kernels.moe_gmm import kernel, ops, ref
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    up, down = (8192, 6, 64, 2048, 1408, 128), (8192, 6, 64, 1408, 2048, 128)
    dec = (4, 6, 64, 2048, 1408, 128)
    # (shape (T, k, E, D, F, tile_m), x dtype, routing, timed).  Tolerances:
    # bf16 rtol 1e-2 and 1e-2 of max|y| (both sides sum in f32 and round y
    # once: a flip is one bf16 ulp); f32 at D >= 1408 rtol 1e-4 and 1e-4 of
    # max|y| (sums of 2048 products in another order); the reference
    # tests' shapes rtol = atol = 1e-5, their own gate
    cases = [(up, bf16, "uniform", True), (down, bf16, "uniform", True),
             (up, f32, "uniform", False), (down, f32, "uniform", False),
             (up, bf16, "one expert", False), (dec, bf16, "uniform", True),
             ((4, 6, 64, 1408, 2048, 128), bf16, "uniform", False),
             ((64, 1, 4, 16, 32, 16), f32, "uniform", False),
             ((200, 1, 8, 32, 64, 16), f32, "uniform", False),
             ((33, 1, 2, 8, 16, 8), f32, "uniform", False),
             ((32, 1, 4, 8, 16, 8), f32, "one expert", False),
             # 33,600 row tiles: past the 65,535 row blocks of a grid.y
             ((4_300_000, 1, 8, 16, 16, 128), bf16, "uniform", False),
             ((4_300_000, 1, 8, 16, 16, 128), f32, "uniform", False)]
    entry = None
    for (T, k, E, D, F, tile), dtype, routing, timed in cases:
        x = torch.randn(T * k, D, generator=g).to(dtype).to(dev)
        eo = torch.randint(0, E, (T * k,), generator=g)
        if routing == "one expert":
            eo.fill_(E // 2)
        eo = eo.to(dev)
        w = (torch.randn(E, D, F, generator=g) / D ** 0.5).to(dev)
        got = ops.moe_apply(x, eo, w, tile_m=tile)
        want = ref.gmm(x, eo, w)
        scale = float(want.float().abs().max())
        rtol, atol = ((1e-2, 1e-2 * scale) if dtype == bf16 else
                      (1e-5, 1e-5) if D <= 32 else (1e-4, 1e-4 * scale))
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        excess = float((diff - (atol + rtol * want.float().abs())).max())
        check(excess <= 0, f"moe_gmm T={T} k={k} E={E} D={D} F={F} {dtype} "
                           f"{routing}: outside rtol {rtol} / atol {atol} "
                           f"by {excess}")
        route = "tensor cores" if dtype == bf16 else "FMA"
        print(f"[kernel] moe_gmm rows={T * k} ({T} x top-{k}) E={E} D={D} "
              f"F={F} tile_m={tile} x {str(dtype)[6:]} ({route}), w float32, "
              f"{routing}: max|diff| {err:.3e} (rtol {rtol:.0e}, atol "
              f"{atol:.3e})")
        del got, want, diff
        if not timed:
            continue
        lib, why = grouped_mm_call(torch, x, eo, w)
        # the launch alone, routed as the op routes it (torch._grouped_mm
        # is timed on rows already sorted)
        te, te_rows, row_src = ops.route(eo, E, tile)
        y_l = torch.empty((T * k, F), dtype=x.dtype, device=dev)
        fns = {"plain": lambda: ref.gmm(x, eo, w),
               "kernel": lambda: ops.moe_apply(x, eo, w),
               "launch": lambda: kernel.launch(x, te, te_rows, row_src, w,
                                               y_l, tile)}
        if lib is not None:
            fns["library"] = lib
        t = timed_turns(torch, fns, {"plain": 3, "kernel": 5, "launch": 10,
                                     "library": 10}, flush=flush_buf.zero_)
        bound_ms, bound_by = gmm_bound(x, eo, w)
        flops = 2.0 * T * k * D * F
        print(f"[kernel] moe_gmm rows={T * k} D={D} F={F} bf16: kernel "
              f"{t['kernel']:.4f} ms as the op, routing included "
              f"({flops / t['kernel'] / 1e9:.1f} TFLOP/s); the launch alone "
              f"{t['launch']:.4f} ms ({flops / t['launch'] / 1e9:.1f} "
              f"TFLOP/s), plain {t['plain']:.4f} ms, library"
              + (f"(torch._grouped_mm, bf16 w) {t['library']:.4f} ms"
                 if lib is not None else f" none ({why})")
              + f", bound {bound_ms:.4f} ms ({bound_by}; {flops:.3e} FLOP, "
              f"{int(eo.unique().numel())} experts hit), roofline "
              f"{bound_ms / t['kernel']:.1%}")
        if entry is None:  # the forward's gate/up product
            entry = {"name": "moe_gmm", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
                     "replaces": "src/repro/kernels/moe_gmm/kernel.py:25",
                     "max_abs_err": err, "ms": t["kernel"],
                     "plain_ms": t["plain"], "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "library_ms": t.get("library")}
        del lib, fns, y_l, te, te_rows, row_src
    del flush_buf
    return entry


def check_grad_refusal(torch, dev) -> None:
    """Each kernel op raises under grad mode for an input that requires
    grad (its kernel has no backward, so a launch would cut the autograd
    graph silently), before launching: its count does not move."""
    import numpy as np
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_gmm import ops as gmm
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.stencil import ops as st
    q = torch.randn(1, 2, 16, 32, device=dev, requires_grad=True)
    img = torch.randn(32, 32, device=dev, requires_grad=True)
    x = torch.randn(1, 16, 2, 8, device=dev)
    dt = torch.rand(1, 16, 2, device=dev, requires_grad=True)
    A = -torch.ones(2, device=dev)
    Bm = torch.randn(1, 16, 1, 4, device=dev)
    gx = torch.randn(8, 32, device=dev)
    eo = torch.zeros(8, dtype=torch.int32, device=dev)
    gw = torch.randn(4, 32, 16, device=dev, requires_grad=True)
    calls = {"mha": (fa.mha, lambda: fa.mha(q, q, q)),
             "ssd": (ssd.ssd, lambda: ssd.ssd(x, dt, A, Bm, Bm)),
             "moe_apply": (gmm.moe_apply, lambda: gmm.moe_apply(gx, eo, gw)),
             "stencil2d": (st.stencil2d,
                           lambda: st.stencil2d(img, np.ones((3, 3))))}
    for name, (fn, call) in calls.items():
        before = fn.launches
        try:
            call()
        except RuntimeError as exc:
            check("no backward" in str(exc), f"{name}: raised {exc}")
        else:
            raise SmokeFailure(f"{name}: launched under grad mode")
        check(fn.launches == before, f"{name}: launched before refusing")
    print("[kernel] grad refusal: mha, ssd, moe_apply and stencil2d raise "
          "under grad mode for an input that requires grad, launches "
          "unchanged")


def check_widened(torch, dev) -> None:
    """What the kernel ops once refused on the card, each call one launch
    held to its plain version: float16 flash attention (at D = 48, padded
    to 64, and at the qwen2 forward's shape), a strided head dim and bf16
    rows that are not 16-byte aligned (copied once); the float16 SSD scan
    with bf16 dt and A (cast to f32) and strided P and N, and S = 0 (no
    launch); the float16 grouped matmul with f32, bf16 and f16 w, and a
    strided w; bool and transposed stencil images.  float16 is timed at
    the main path's shapes beside the plain version (no repo config
    computes in f16: untuned).  Tolerances: flash f16 5e-3 (the plain
    version rounds its probabilities to f16, one f16 ulp of o), SSD and
    grouped-matmul f16 2e-3 and 2e-3 of max|want| (two f16 ulps once the
    f32 sums round), bf16 flash the reference's 5e-2."""
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref
    from repro_torch.kernels.moe_gmm import ops as gmm, ref as gmm_ref
    from repro_torch.kernels.ssd_scan import ops as ssd, ref as ssd_ref
    from repro_torch.kernels.stencil import ops as st, ref as st_ref
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(8)
    f16, bf16 = torch.float16, torch.bfloat16

    def one_launch(fn, call, label):
        before = fn.launches
        out = call()
        torch.cuda.synchronize()
        check(fn.launches == before + 1,
              f"{label}: {fn.launches - before} launches, not 1")
        return out

    def close(got, want, rtol, atol, label):
        diff = (got.float() - want.float()).abs()
        excess = float((diff - (atol + rtol * want.float().abs())).max())
        check(excess <= 0, f"{label}: outside rtol {rtol} / atol {atol} by "
                           f"{excess}")
        print(f"[kernel] {label}: one launch, max|diff| "
              f"{float(diff.max()):.3e} (rtol {rtol}, atol {atol:.3e})")

    def timed(label, plain, kernel, flops, nbytes):
        t = timed_turns(torch, {"plain": plain, "kernel": kernel},
                        {"plain": 3, "kernel": 10}, flush=flush_buf.zero_)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        print(f"[kernel] {label} f16: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"roofline {bound_ms / t['kernel']:.1%}")

    # flash attention
    for (B, H, K, S, D), dtype in (((2, 4, 2, 70, 48), f16),
                                   ((4, 14, 2, 2048, 64), f16),
                                   ((1, 2, 1, 50, 200), torch.float32)):
        q = (torch.randn(B, H, S, D, generator=g) * 0.3).to(dtype).to(dev)
        k = (torch.randn(B, K, S, D, generator=g) * 0.3).to(dtype).to(dev)
        v = torch.randn(B, K, S, D, generator=g).to(dtype).to(dev)
        label = f"flash_attention ({B}, {H}, {K}, {S}, {S}, {D}) {dtype}"
        got = one_launch(fa.mha, lambda: fa.mha(q, k, v), label)
        tol = 5e-3 if dtype == f16 else 2e-4
        close(got, fa_ref.mha(q, k, v), tol, tol, label)
        if S == 2048:
            pairs = B * H * S * (S + 1) // 2
            timed("flash_attention qwen2-0.5b shape",
                  lambda: fa_ref.mha(q, k, v), lambda: fa.mha(q, k, v),
                  4.0 * D * pairs,
                  (2 * q.numel() + k.numel() + v.numel()) * 2)
    base = torch.randn(1, 2, 40, 68, generator=g).to(bf16).to(dev)
    for t, what in ((base[..., :64], "seq stride 68"),
                    (base[..., 1:65], "base 2 bytes off 16")):
        label = f"flash_attention bf16 unaligned rows ({what})"
        got = one_launch(fa.mha, lambda: fa.mha(t, t, t), label)
        close(got, fa_ref.mha(t, t, t), 5e-2, 5e-2, label)
    v = torch.randn(1, 2, 40, 64, 2, generator=g).to(dev)[..., 0]
    label = "flash_attention f32 head dim stride 2"
    got = one_launch(fa.mha, lambda: fa.mha(v, v, v), label)
    close(got, fa_ref.mha(v, v, v), 2e-4, 2e-4, label)
    # the SSD scan
    for (b, S, H, P, G, N) in ((2, 300, 4, 64, 1, 128),
                               (4, 2048, 80, 64, 1, 128)):
        x = torch.randn(b, S, H, P, generator=g).to(f16).to(dev)
        dt = (torch.rand(b, S, H, generator=g) * 0.1).to(bf16).to(dev)
        A = (-torch.rand(H, generator=g) - 0.1).to(bf16).to(dev)
        Bm = (torch.randn(b, S, G, N, generator=g) * 0.3).to(f16).to(dev)
        Cm = (torch.randn(b, S, G, N, generator=g) * 0.3).to(f16).to(dev)
        want = ssd_ref.ssd(x, dt, A, Bm, Cm)
        scale = float(want.float().abs().max())
        label = f"ssd_scan ({b}, {S}, {H}, {P}, {G}, {N}) f16, bf16 dt"
        got = one_launch(ssd.ssd, lambda: ssd.ssd(x, dt, A, Bm, Cm), label)
        close(got, want, 2e-3, 2e-3 * scale, label)
        if S == 2048:
            nbytes = (2 * x.numel() + Bm.numel() + Cm.numel()) * 2 \
                + (dt.numel() + A.numel()) * 2
            timed("ssd_scan mamba2-2.7b shape",
                  lambda: ssd_ref.ssd(x, dt, A, Bm, Cm),
                  lambda: ssd.ssd(x, dt, A, Bm, Cm),
                  ssd_work(b, S, H, P, G, N), nbytes)
        else:
            xs, Bs = (torch.empty(*t.shape, 2, dtype=t.dtype, device=dev)
                      [..., 0].copy_(t) for t in (x, Bm))  # strides 2
            label = label + ", strided P and N"
            got = one_launch(ssd.ssd, lambda: ssd.ssd(xs, dt, A, Bs, Cm),
                             label)
            close(got, want, 2e-3, 2e-3 * scale, label)
            before = ssd.ssd.launches
            y0, h0 = ssd.ssd(x[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0],
                             return_state=True)
            check(ssd.ssd.launches == before and y0.shape == (b, 0, H, P)
                  and h0.shape == (b * H, N, P) and not bool(h0.any()),
                  "ssd_scan S = 0: not an empty y and a zero state")
            print("[kernel] ssd_scan S = 0: empty y, zero state, no launch")
    # the grouped matmul
    T, k, E, D, F, tile = 8192, 6, 64, 2048, 1408, 128
    x = torch.randn(T * k, D, generator=g).to(f16).to(dev)
    eo = torch.randint(0, E, (T * k,), generator=g).to(dev)
    w32 = (torch.randn(E, D, F, generator=g) / D ** 0.5).to(dev)
    for w, what in ((w32, "f32 w"), (w32.to(bf16), "bf16 w"),
                    (w32.to(f16), "f16 w"),
                    (w32.transpose(1, 2).contiguous().transpose(1, 2),
                     "strided f32 w")):
        want = gmm_ref.gmm(x, eo, w)
        label = f"moe_gmm rows={T * k} D={D} F={F} f16 x, {what}"
        got = one_launch(gmm.moe_apply, lambda: gmm.moe_apply(x, eo, w),
                         label)
        close(got, want, 2e-3, 2e-3 * float(want.float().abs().max()),
              label)
        del got, want
        if what == "f16 w":
            nbytes = T * k * (D + F) * 2 + eo.numel() * 8 + E * D * F * 2
            timed("moe_gmm deepseek-moe-16b up shape",
                  lambda: gmm_ref.gmm(x, eo, w),
                  lambda: gmm.moe_apply(x, eo, w), 2.0 * T * k * D * F,
                  nbytes)
    # the stencil
    img = torch.randn(2048, 2048, generator=g).to(dev)
    taps = st.taps_of(torch.randn(5, 5, generator=g))
    for x, what in ((img.t(), "transposed f32"), (img > 0.5, "bool"),
                    ((img > 0.5).t(), "transposed bool")):
        label = f"stencil (2048, 2048) k=5 {what}"
        got = one_launch(st.stencil2d, lambda: st.stencil2d(x, taps), label)
        check(got.dtype == x.dtype and torch.equal(got, st_ref.stencil2d(
            x, taps)), f"{label}: not exact")
        print(f"[kernel] {label}: one launch, exact")
    del flush_buf


def tensor_core_instructions(torch, name: str) -> int:
    """HMMA (mma.sync) and HGMMA (wgmma) lines in the SASS of a built
    kernel library, by ``cuobjdump -sass``."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return sum("HMMA" in ln or "HGMMA" in ln for ln in sass.splitlines())


# -- phases 2-5: the main path ----------------------------------------------------

def three_modes(torch, net, n, mb, counts, kernel):
    """(sequential, fused, streaming) results; checks that ``kernel`` (if
    any) launched in every mode."""
    from repro_torch.core import build, run_sequential
    out = []
    cn = build(net)
    for mode, run in (("sequential", lambda: run_sequential(net, n)),
                      ("fused", lambda: cn.run(instances=n)),
                      ("streaming", lambda: cn.run_streaming(
                          instances=n, microbatch_size=mb))):
        before = counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in counts().items()}
        if kernel is not None:
            check(launched[kernel] > 0, f"{net.name} {mode}: {kernel} "
                                        "kernel never launched")
        print(f"[{net.name}] {mode}: {wall * 1e3:.1f} ms host wall, "
              f"launches {launched}")
        out.append(res)
    print(f"[{net.name}] {cn.stream_stats.summary()}")
    return out


def run_farm(torch, counts, W, H, bands, iters):
    import numpy as np
    from repro_torch import workloads
    net = workloads.mandelbrot_farm(width=W, height=H, bands=bands,
                                    iterations=iters)
    imgs = [workloads.assemble(r["collect"])
            for r in three_modes(torch, net, bands, 16, counts, "mandelbrot")]
    check(all(np.array_equal(imgs[0], im) for im in imgs[1:]),
          "mandelbrot farm: sequential, fused and streaming differ")
    img = imgs[0]
    check(img.shape == (H, W) and img.min() >= 0 and img.max() == iters,
          f"mandelbrot farm: image {img.shape} in [{img.min()}, {img.max()}]")
    print(f"[mandelbrot] sequential == fused == streaming: True; image "
          f"{img.shape}, {int((img == iters).sum())} interior pixels")
    return net, img


def run_pipeline(torch, dev, counts, n, size):
    import numpy as np
    from repro_torch import workloads
    from repro_torch.interop import tree_from_numpy
    from repro_torch.kernels.stencil import ref
    imgs = tree_from_numpy(workloads.synthetic_images(n, size), dev)
    net = workloads.image_pipeline(imgs)
    outs = [r["collector"]
            for r in three_modes(torch, net, n, 4, counts, "stencil")]
    check(all(np.array_equal(a, b) for o in outs[1:]
              for a, b in zip(outs[0], o)),
          "image pipeline: sequential, fused and streaming differ")
    grey = imgs[0] @ torch.tensor(workloads.GREY, device=dev)
    want = ref.stencil2d(grey, workloads.EDGE5).cpu().numpy()
    check(np.array_equal(outs[0][0], want),
          "image pipeline: image 0 differs from the plain stencil")
    edges = int((np.abs(outs[0][0]) > 1.0).sum())
    check(edges > 0, "image pipeline: no edges found")
    print(f"[image] sequential == fused == streaming: True; {n} images of "
          f"{size}x{size}; {edges} edge pixels in image 0")
    return net, outs[0]


def run_jacobi(torch, dev, counts, n_systems, n, nodes, tol):
    import numpy as np
    from repro_torch import workloads
    from repro_torch.interop import tree_from_numpy
    systems, truths = workloads.jacobi_systems(n_systems, n)
    net = workloads.jacobi(tree_from_numpy(systems, dev), n=n, nodes=nodes,
                           tol=tol)
    outs = [r["collector"]
            for r in three_modes(torch, net, n_systems, 2, counts, None)]
    check(all(np.array_equal(a, b) for o in outs[1:]
              for a, b in zip(outs[0], o)),
          "jacobi: sequential, fused and streaming differ")
    errs = [float(np.max(np.abs(x - t))) for x, t in zip(outs[0], truths)]
    check(max(errs) < 1e-3, f"jacobi: max|x - x_true| = {max(errs)}")
    print(f"[jacobi] {n_systems} systems n={n}, {nodes} nodes, tol={tol}: "
          f"max|x - x_true| = {max(errs):.2e} (OK < 1e-3)")


def run_pi(torch, counts, instances, points):
    from repro_torch import workloads
    from repro_torch.core import build, csp, netlog
    explicit = workloads.monte_carlo_pi(instances=instances, points=points,
                                        workers=2, explicit=True)
    r = csp.check(explicit, instances=3)
    print(f"[csp] states={r.n_states} deadlock_free={r.deadlock_free} "
          f"divergence_free={r.divergence_free} "
          f"deterministic={r.deterministic} "
          f"terminates={r.all_paths_terminate}")
    check(r.deadlock_free and r.deterministic and r.all_paths_terminate,
          "csp: the explicit pi farm failed its checks")
    net = workloads.monte_carlo_pi(instances=instances, points=points,
                                   workers=4)
    pis = [float(r["collect"])
           for r in three_modes(torch, net, instances, 32, counts, None)]
    check(pis[0] == pis[1] == pis[2], f"pi: modes differ {pis}")
    p = math.pi / 4
    sigma = 4 * math.sqrt(p * (1 - p) / (instances * points))
    check(abs(pis[0] - math.pi) < 4 * sigma,
          f"pi: {pis[0]} is more than 4 sigma from pi")
    print(f"[pi] sequential == fused == streaming: {pis[0]!r} "
          f"(|pi - estimate| = {abs(pis[0] - math.pi):.2e}, "
          f"sigma {sigma:.2e})")
    cn = build(net)
    cn.run(instances=instances, logged=True)
    print(netlog.report(cn))


# -- phase 12: the cluster on the card ------------------------------------------------

def checked_farm(width, height, bands, iterations):
    """The Mandelbrot farm as a spawned host process rebuilds it, its worker
    checking inside that process that each band launched the process's own
    Mandelbrot kernel exactly once and is a CUDA tensor (else the band
    raises, and the batch fails with ``ClusterError``)."""
    from repro_torch import workloads
    from repro_torch.core.dataflow import Kind
    from repro_torch.kernels.mandelbrot import ops
    net = workloads.mandelbrot_factory(width, height, bands, iterations)
    (worker,) = [p for p in net.procs.values() if p.kind is Kind.WORKER]
    render = worker.fn

    def render_checked(row0):
        before = ops.mandelbrot.launches
        row, band = render(row0)
        if ops.mandelbrot.launches != before + 1 or not band.is_cuda:
            raise RuntimeError(
                f"host process: band {int(row0)} launched "
                f"{ops.mandelbrot.launches - before} kernels, on "
                f"{band.device}")
        return row, band

    worker.fn = render_checked
    return net


def run_deployment(torch, label, net, plan, transport, factory, n, batches,
                   counts, kernel, per_batch, same_as, microbatch=16):
    """One warm ``ClusterDeployment``: refinement, ``batches`` batches each
    checked by ``same_as`` and by the parent's ``kernel`` launches
    (``per_batch``), the walls, the bytes crossing the cut a batch and,
    over the shared-memory ring, each batch's chunks by path (every chunk
    must go through a slot) and no ``/dev/shm`` segment left after the
    close.  Prints the cluster report.  Returns the walls in ms (start,
    then one a batch)."""
    from repro_torch.cluster import ClusterDeployment, check_refinement
    from repro_torch.cluster.transport import SharedMemoryRing
    from repro_torch.core import netlog
    refined = check_refinement(net, plan)
    check(refined, f"[cluster] {label}: partitioned network does not refine")
    print(f"[cluster] {label}: partitioned [T= unpartitioned (CSP, both "
          f"directions): {refined}; cut "
          f"{[f'{c.src}->{c.dst}' for c in plan.cut]}")
    ring = transport if isinstance(transport, SharedMemoryRing) else None
    n_chunks = -(-n // microbatch)
    t0 = time.perf_counter()
    dep = ClusterDeployment(net, plan=plan, transport=transport,
                            microbatch_size=microbatch, factory=factory,
                            timeout_s=300)
    with dep:
        walls = [(time.perf_counter() - t0) * 1e3]
        for b in range(batches):
            before = counts()[kernel]
            t0 = time.perf_counter()
            out = dep.run(instances=n)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launched = counts()[kernel] - before
            check(same_as(out), f"[cluster] {label}: batch {b} differs "
                                "from the single-host run")
            check(launched == per_batch,
                  f"[cluster] {label}: batch {b} launched {launched} "
                  f"{kernel} kernels in this process, not {per_batch}")
            sent = sum(v for r in out.reports
                       for v in r.metrics.get("sent_bytes", {}).values())
            paths = ""
            if ring is not None:
                by_path = [v for r in out.reports
                           for v in r.metrics.get("ring", {}).values()]
                slots, inline = (sum(v[i] for v in by_path) for i in (0, 1))
                check(inline == 0 and slots == n_chunks * len(plan.cut),
                      f"[cluster] {label}: batch {b} sent {slots} chunks "
                      f"through a slot and {inline} inline, not "
                      f"{n_chunks * len(plan.cut)} and 0")
                paths = f", ring chunks: {slots} through a slot, {inline} " \
                        "inline"
            print(f"[cluster] {label}: batch {b} "
                  f"({'cold' if b == 0 else 'warm'}) {walls[-1]:.1f} ms, "
                  f"exact: True, {kernel} launches here {launched}, cut "
                  f"bytes {sent}{paths}, stage builds "
                  f"{sum(r.jit_builds for r in out.reports)}")
        procs = list(dep.controller._procs.values())
        names = ring.owned_names() if ring is not None else []
    check(not any(p.is_alive() for p in procs),
          f"[cluster] {label}: a host process outlived the deployment")
    if ring is not None:
        check_unlinked(ring, names, label)
    print(netlog.cluster_report(dep.plan, out.reports, events=dep.events))
    print(f"[cluster] {label}: start {walls[0]:.1f} ms, cold batch "
          f"{walls[1]:.1f} ms, warm batches "
          f"{', '.join(f'{w:.1f}' for w in walls[2:])} ms")
    return walls


def check_unlinked(ring, names, label) -> None:
    """Every ``/dev/shm`` segment the ring created is gone after close."""
    from multiprocessing import shared_memory
    check(bool(names) and not ring.owned_names(),
          f"[cluster] {label}: the ring still owns segments")
    for name in names:
        try:
            shared_memory.SharedMemory(name=name).close()
        except FileNotFoundError:
            continue
        raise SmokeFailure(f"[cluster] {label}: /dev/shm segment {name} "
                           "left after close")
    print(f"[cluster] {label}: {len(names)} /dev/shm segments unlinked")


def shm_free_bytes() -> int:
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def run_kill_recovery(torch, transport, farm_img, args, batches=3) -> None:
    """Batches 0 and 1 of the farm over 2 process hosts, then SIGKILL host
    1 (the Collect's); batch 2 fails with the dead host found, and
    ``recover(mode="restart")`` respawns it and replays the batch, which
    must equal phase 2's image bit for bit, at epoch >= 2, with host 1
    named as restarted and the plan re-proved."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import (ClusterDeployment, ClusterError,
                                     check_refinement, partition)
    from repro_torch.cluster.transport import SharedMemoryRing
    from repro_torch.core import netlog
    label = f"mandelbrot {'shm' if transport != 'pipe' else 'pipe'} x2 kill"
    net = checked_farm(*args)
    plan = partition(net, hosts=2)
    check(check_refinement(net, plan), f"[cluster] {label}: no refinement")
    with ClusterDeployment(net, plan=plan, transport=transport,
                           microbatch_size=16, factory=(checked_farm, args),
                           timeout_s=300) as dep:
        for b in range(batches - 1):
            out = dep.run(instances=args[2])
            check(np.array_equal(workloads.assemble(out["collect"]),
                                 farm_img),
                  f"[cluster] {label}: batch {b} differs")
        t_kill = time.perf_counter()
        dep.kill_host(1)
        try:
            dep.run(instances=args[2])
        except ClusterError as exc:
            dead = [r.host for r in exc.reports if not r.ok
                    and "died" in (r.error or "")]
            check(dead == [1], f"[cluster] {label}: dead hosts {dead}")
        else:
            raise SmokeFailure(f"[cluster] {label}: batch {batches - 1} ran "
                               "with host 1 killed")
        t_detect = time.perf_counter()
        out = dep.recover(mode="restart")
        torch.cuda.synchronize()
        t_done = time.perf_counter()
        check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
              f"[cluster] {label}: the replayed batch differs from phase 2")
        (ev,) = dep.events
        check(dep.epoch >= 2 and ev.restarted == [1] and ev.dead == [1]
              and ev.refined is True,
              f"[cluster] {label}: recovery event {ev.describe()}")
        procs = list(dep.controller._procs.values())
        names = (transport.owned_names()
                 if isinstance(transport, SharedMemoryRing) else [])
    check(not any(p.is_alive() for p in procs),
          f"[cluster] {label}: a host process outlived the deployment")
    if names:
        check_unlinked(transport, names, label)
    print(netlog.cluster_report(dep.plan, out.reports, events=dep.events))
    print(f"[cluster] {label}: {ev.describe()}")
    print(f"[cluster] {label}: kill -> failure found "
          f"{(t_detect - t_kill) * 1e3:.1f} ms, recover() (restart + replay) "
          f"{(t_done - t_detect) * 1e3:.1f} ms, kill -> replayed result "
          f"{(t_done - t_kill) * 1e3:.1f} ms; replay exact: True, epoch "
          f"{dep.epoch}")


def failing_farm(args, state: dict):
    """The farm whose worker raises once, on the first band of batch 1
    (a transient host failure), before it launches anything."""
    from repro_torch import workloads
    from repro_torch.core.dataflow import Kind
    net = workloads.mandelbrot_factory(*args)
    (worker,) = [p for p in net.procs.values() if p.kind is Kind.WORKER]
    render = worker.fn

    def render_once_failing(row0):
        state["calls"] = state.get("calls", 0) + 1
        if state["calls"] == args[2] + 1:
            raise RuntimeError("transient worker failure (injected)")
        return render(row0)

    worker.fn = render_once_failing
    return net, worker.name


def run_rebalance(torch, counts, farm_img, args) -> float:
    """The farm over 4 thread hosts on the card (``device``): batch 0 ok,
    batch 1 fails in the worker's host, ``recover(mode="rebalance")``
    moves that host's processes onto survivors; the new plan must refine
    the network, the replay must equal phase 2, and this process must
    launch exactly the Mandelbrot kernels of the bands re-streamed.
    Returns the ``recover()`` wall in ms (a replay from chunk 0)."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import (ClusterDeployment, ClusterError,
                                     check_refinement, partition)
    from repro_torch.core import netlog
    label = "mandelbrot device x4 rebalance"
    net, worker = failing_farm(args, {})
    bands, mb = args[2], 16
    with ClusterDeployment(net, plan=partition(net, hosts=4),
                           transport="device", microbatch_size=mb,
                           timeout_s=300) as dep:
        out = dep.run(instances=bands)
        check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
              f"[cluster] {label}: batch 0 differs")
        failed = dep.plan.assignment[worker]
        try:
            dep.run(instances=bands)
        except ClusterError as exc:
            erred = sorted(r.host for r in exc.reports
                           if not r.ok and not r.stalled)
            check(erred == [failed], f"[cluster] {label}: erred {erred}")
        else:
            raise SmokeFailure(f"[cluster] {label}: batch 1 did not fail")
        before = counts()["mandelbrot"]
        t0 = time.perf_counter()
        out = dep.recover(mode="rebalance")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = counts()["mandelbrot"] - before
        (ev,) = dep.events
        host = dep.plan.assignment[worker]
        want = max(bands - mb * ev.replay_from.get(host, -(-bands // mb)), 0)
        check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
              f"[cluster] {label}: the replayed batch differs from phase 2")
        check(ev.refined is True and check_refinement(net, dep.plan)
              and failed not in dep.plan.hosts() and ev.moved,
              f"[cluster] {label}: {ev.describe()}")
        check(launched == want, f"[cluster] {label}: the replay launched "
                                f"{launched} kernels here, not {want}")
        after = dep.run(instances=bands)
        check(np.array_equal(workloads.assemble(after["collect"]), farm_img),
              f"[cluster] {label}: the batch after the rebalance differs")
    print(netlog.cluster_report(dep.plan, out.reports, events=dep.events))
    print(f"[cluster] {label}: {ev.describe()}")
    print(f"[cluster] {label}: host {failed} evacuated, plan "
          f"{dep.plan.hosts()} refines: True; recover() {wall:.1f} ms, "
          f"{launched} mandelbrot launches here (bands re-streamed from "
          f"chunk {ev.replay_from.get(host)}), replay exact: True")
    return wall


def run_cluster_phase(torch, counts, farm_img, pipe_outs, W, H, bands, iters,
                      n_img, size) -> float:
    """Phase 12: the farm at phase 2's width over 2 and 4 thread hosts on
    the card (``device``) and 2 spawned host processes (``pipe``, ``shm``),
    then the image pipeline at phase 3's size cut between its engines over
    ``device``, ``pipe`` and ``shm``; a killed host recovered over ``pipe``
    and ``shm``, and a failed worker's host rebalanced away over
    ``device``.  Returns the rebalance's ``recover()`` wall in ms."""
    import multiprocessing

    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import (ExecConfig, derive_cut_capacities,
                                     partition)
    from repro_torch.cluster.transport import SharedMemoryRing
    t_phase = time.perf_counter()
    free = shm_free_bytes()
    print(f"[cluster] /dev/shm: {free} bytes free")
    args = (W, H, bands, iters)
    # a farm chunk: 16 row indices and 16 bands of int32 iteration counts
    farm_slot = SharedMemoryRing.slot_bytes_for(
        (torch.empty(16, dtype=torch.int32, device="meta"),
         torch.empty(16, H // bands, W, dtype=torch.int32, device="meta")))
    same_img = lambda out: np.array_equal(  # noqa: E731
        workloads.assemble(out["collect"]), farm_img)
    for transport, hosts, factory in (
            ("device", 2, workloads.mandelbrot_factory),
            ("device", 4, workloads.mandelbrot_factory),
            ("pipe", 2, checked_farm),
            (SharedMemoryRing(slot_bytes=farm_slot), 2, checked_farm)):
        name = getattr(transport, "name", transport)
        net = factory(*args)
        run_deployment(torch, f"mandelbrot {name} x{hosts}", net,
                       partition(net, hosts=hosts), transport,
                       (factory, args), bands, 3, counts, "mandelbrot",
                       bands if name == "device" else 0, same_img)

    def same_edges(out):
        got = out["collector"]
        return len(got) == len(pipe_outs) and all(
            np.array_equal(a, b) for a, b in zip(got, pipe_outs))

    factory = (workloads.image_pipeline_factory, (n_img, size))
    net = factory[0](*factory[1])
    assignment = {name: 0 for name in net.procs}
    assignment["engine2"] = assignment["collector"] = 1
    plan = partition(net, assignment=assignment)
    for transport in ("device", "pipe"):
        run_deployment(torch, f"image {transport} x2", net, plan, transport,
                       factory, n_img, 3, counts, "stencil",
                       n_img if transport == "device" else 0, same_edges)
    # the ring holds `capacity` chunks of mb grey f32 images: the largest
    # microbatch (up to 16) whose ring fits in what /dev/shm has free
    cap = max(derive_cut_capacities(plan, ExecConfig(16)).values())

    def grey_slot(mb):  # a pipeline chunk: mb grey f32 images
        return SharedMemoryRing.slot_bytes_for(torch.empty(
            mb, size, size, dtype=torch.float32, device="meta"))
    mb = 16
    while mb > 1 and cap * grey_slot(mb) > 0.8 * free:
        mb -= 1
    check(cap * grey_slot(mb) <= 0.8 * free,
          f"[cluster] image shm x2: /dev/shm ({free} bytes free) cannot "
          f"hold {cap} slots of one {size}^2 image")
    print(f"[cluster] image shm x2: microbatch {mb} ({cap} slots of "
          f"{grey_slot(mb)} bytes; 16 needs {cap * grey_slot(16)})")
    run_deployment(torch, f"image shm x2 mb {mb}", net, plan,
                   SharedMemoryRing(slot_bytes=grey_slot(mb)), factory,
                   n_img, 3, counts, "stencil", 0, same_edges,
                   microbatch=mb)
    for transport in ("pipe", SharedMemoryRing(slot_bytes=farm_slot)):
        run_kill_recovery(torch, transport, farm_img, args)
    rebalance_ms = run_rebalance(torch, counts, farm_img, args)
    check(not multiprocessing.active_children(),
          "[cluster] host processes still running after phase 12")
    print(f"[cluster] phase 12 wall: {time.perf_counter() - t_phase:.1f} s")
    return rebalance_ms


# -- phase 13: durability on the card -------------------------------------------------

_TRIP13: dict = {}  # module-level: the adopting controller rebuilds the farm


def tripping_farm(args, trip_at):
    """The farm whose host-side Collect raises once, on its ``trip_at``-th
    band (a transient failure landing after some fold snapshots)."""
    from repro_torch import workloads
    net = workloads.mandelbrot_factory(*args)
    coll = net.procs["collect"]
    fold = coll.fn

    def once(acc, item):
        _TRIP13["n"] = _TRIP13.get("n", 0) + 1
        if _TRIP13["n"] == trip_at:
            raise RuntimeError("transient collector failure (injected)")
        return fold(acc, item)

    coll.fn = once
    return net


def pct(xs, q):
    """Nearest-rank percentile of a non-empty list."""
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(len(ys) * q / 100.0))]


def run_durable_farm(torch, counts, farm_img, args, d) -> dict:
    """13a: the farm over 2 ``device`` hosts with fold snapshots every 2
    chunks, and the same deployment without snapshots, 5 batches each in
    turns; every batch equal to phase 2 and launching its 64 bands here.
    Leaves the durable deployment's state in ``d`` (closed)."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import ClusterDeployment
    label = "[durable] 13a farm device x2"
    bands = args[2]
    deps = {name: ClusterDeployment(
        workloads.mandelbrot_factory(*args), hosts=2, transport="device",
        microbatch_size=8, trace=True, timeout_s=300,
        snapshot_every=2 if name == "snapshots" else 0,
        snapshot_dir=d if name == "snapshots" else None)
        for name in ("snapshots", "plain")}
    walls: dict = {name: [] for name in deps}
    try:
        for turn in range(5):  # turn 0 is cold; then ABBA
            names = (["snapshots", "plain"] if turn % 2 else
                     ["plain", "snapshots"])
            for name in names:
                before = counts()["mandelbrot"]
                t0 = time.perf_counter()
                out = deps[name].run(instances=bands)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                check(np.array_equal(workloads.assemble(out["collect"]),
                                     farm_img),
                      f"{label} ({name}): batch {turn} differs from phase 2")
                launched = counts()["mandelbrot"] - before
                check(launched == bands, f"{label} ({name}): batch {turn} "
                                         f"launched {launched} kernels here")
                if turn:
                    walls[name].append(wall)
        dep = deps["snapshots"]
        kinds = {e.kind for e in dep.durable_events}
        check("snapshot" in kinds, f"{label}: durable events {kinds}")
        spans = [e for e in dep.merged_trace()
                 if e.kind == "span" and e.name == "snapshot"]
        persists = [e for e in dep.merged_trace()
                    if e.kind == "span" and e.name == "persist"]
    finally:
        for dep in deps.values():
            dep.close()
    check(bool(spans), f"{label}: no host wrote a fold snapshot")
    by_ci = {}
    for e in spans:
        by_ci.setdefault((e.host, e.args["ci"]), e.args["nbytes"])
    snap_ms = statistics.median(e.dur * 1e3 for e in spans)
    warm = {k: statistics.median(v) for k, v in walls.items()}
    print(f"{label}: 5 batches each, exact, 64 mandelbrot launches here a "
          f"batch; fold snapshots: {len(spans)} spans over 5 batches, "
          f"median {snap_ms:.2f} ms, bytes (host, chunk) {dict(sorted(by_ci.items()))}; "
          f"controller meta: {len(persists)} persist spans, median "
          f"{statistics.median(e.dur * 1e3 for e in persists):.2f} ms, "
          f"{max(e.args['nbytes'] for e in persists)} bytes at most")
    print(f"{label}: warm batch median {warm['snapshots']:.1f} ms with "
          f"snapshots ({', '.join(f'{w:.1f}' for w in walls['snapshots'])}) "
          f"vs {warm['plain']:.1f} ms without "
          f"({', '.join(f'{w:.1f}' for w in walls['plain'])}): ratio "
          f"{warm['snapshots'] / warm['plain']:.3f} (the JAX package holds "
          "its own to <= 1.05; not gated)")
    return {"snap_ms": snap_ms, "warm": warm}


def run_snapshot_replay(torch, counts, farm_img, args, d,
                        rebalance_ms) -> None:
    """13b: the Collect raises on the first band of chunk 5, past the fold
    snapshots at chunks 2 and 4; ``recover()`` must equal phase 2, replay
    the Collect's host from its snapshot (a chunk > 0), append a
    ``restore`` event, and launch here exactly the re-streamed bands."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import (ClusterDeployment, ClusterError,
                                     DeploymentStore)
    label = "[durable] 13b replay from a snapshot"
    bands, mb = args[2], 8
    _TRIP13.clear()
    with ClusterDeployment(tripping_farm(args, 5 * mb + 1), hosts=2,
                           transport="device", microbatch_size=mb,
                           snapshot_every=2, snapshot_dir=d,
                           timeout_s=300) as dep:
        try:
            dep.run(instances=bands)
        except ClusterError:
            pass
        else:
            raise SmokeFailure(f"{label}: the batch did not fail")
        coll = dep.plan.assignment["collect"]
        snap = DeploymentStore(d).load_host_snapshot(coll)
        check(snap is not None and snap["next_ci"] > 0,
              f"{label}: no fold snapshot past chunk 0")
        before = counts()["mandelbrot"]
        t0 = time.perf_counter()
        out = dep.recover()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = counts()["mandelbrot"] - before
        ev = dep.events[-1]
        kinds = [e.kind for e in dep.durable_events]
    want = bands - mb * snap["next_ci"]
    check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
          f"{label}: the replayed batch differs from phase 2")
    check(ev.replay_from.get(coll) == snap["next_ci"] and ev.refined is True,
          f"{label}: {ev.describe()} (snapshot at chunk {snap['next_ci']})")
    check("restore" in kinds, f"{label}: durable events {kinds}")
    check(launched == want, f"{label}: recover() launched {launched} "
                            f"kernels here, not {want}")
    print(f"{label}: {ev.describe()}")
    print(f"{label}: the Collect's host {coll} resumed at chunk "
          f"{snap['next_ci']} of 8; recover() {wall:.1f} ms, {launched} "
          f"mandelbrot launches here (64 - 8 x {snap['next_ci']}), exact; "
          f"phase 12's rebalance (a replay from chunk 0) {rebalance_ms:.1f} "
          "ms")


def run_adoption(torch, counts, farm_img, args, d, d_live) -> None:
    """13c: a fresh adopt of 13a's closed deployment, and a salvage adopt
    over a live one; each at epoch 2, refined, its next batch equal to
    phase 2 (the salvaged one building no stage callable)."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import ClusterDeployment
    label = "[durable] 13c adopt"
    bands = args[2]
    factory = (workloads.mandelbrot_factory, args)
    walls = {}
    t0 = time.perf_counter()
    dep = ClusterDeployment.adopt(d, factory=factory, transport="device")
    walls["fresh"] = (time.perf_counter() - t0) * 1e3
    with dep:
        ev = dep.events[-1]
        check(dep.epoch == 2 and ev.mode == "adopt" and ev.refined is True,
              f"{label} fresh: epoch {dep.epoch}, {ev.describe()}")
        out = dep.run(instances=bands)
        check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
              f"{label} fresh: the batch differs from phase 2")
    live = ClusterDeployment(workloads.mandelbrot_factory(*args), hosts=2,
                             transport="device", microbatch_size=8,
                             snapshot_every=2, snapshot_dir=d_live,
                             timeout_s=300)
    live.start()
    live.run(instances=bands)  # warm: every stage built
    t0 = time.perf_counter()
    dep = ClusterDeployment.adopt(d_live, factory=factory,
                                  transport="device",
                                  salvage=live.salvageable())
    walls["salvage"] = (time.perf_counter() - t0) * 1e3
    with dep:
        ev = dep.events[-1]
        check(dep.epoch == 2 and ev.mode == "adopt" and ev.refined is True,
              f"{label} salvage: epoch {dep.epoch}, {ev.describe()}")
        out = dep.run(instances=bands)
        builds = sum(r.jit_builds for r in out.reports)
        check(builds == 0, f"{label} salvage: {builds} stage builds")
        check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
              f"{label} salvage: the batch differs from phase 2")
    print(f"{label}: fresh {walls['fresh']:.1f} ms (epoch 2, refined, hosts "
          f"spawned anew), salvage {walls['salvage']:.1f} ms (epoch 2, "
          "refined, 0 stage builds); both batches exact")


def group_alive(pgid: int) -> list:
    """Processes of group ``pgid`` that are not zombies."""
    alive = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            alive.append(stat.parent.name)
    return alive


def run_launcher_kill(torch, d) -> None:
    """13d: the launcher over 2 ``pipe`` hosts with fold snapshots, its
    whole process group SIGKILLed once the Collect's host has written one,
    then ``--resume-from``: adopted at epoch 2 and refined, the pending
    batch replayed from the snapshot, and the oracle equal."""
    import signal
    from repro_torch.cluster import partition
    from repro_torch.kernels.mandelbrot import kernel
    from repro_torch.launch.cluster import make_mandelbrot
    label = "[durable] 13d launcher SIGKILL"
    size, bands = 2048, 64
    # iterations for a ~6 s batch, from the farm's 64 band launches one
    # after another (uncounted: the binding, not the op), as a host
    # renders them — a band alone cannot fill the card, so the whole
    # image in one launch would undercount
    band_h, n0 = size // bands, 20000
    out = torch.empty((bands, band_h, size), dtype=torch.int32,
                      device="cuda")
    rows = [torch.tensor(i * band_h, dtype=torch.int32, device="cuda")
            for i in range(bands)]

    def sweep():
        for i in range(bands):
            kernel.launch(out[i], x0=-2.2, y0=-1.15, pixel_delta=3.0 / size,
                          max_iterations=n0, row0=rows[i])

    sweep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    t_img = time.perf_counter() - t0
    iters = int(n0 * 6.0 / t_img)
    del out, rows
    coll = partition(make_mandelbrot(bands, size, size, 1),
                     hosts=2).assignment["collect"]
    flags = ["--hosts", "2", "--transport", "pipe", "--workload",
             "mandelbrot", "--bands", str(bands), "--size", str(size),
             "--iters", str(iters), "--microbatch", "4"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.cluster", *flags]
    print(f"{label}: --iters {iters} ({t_img * 1e3:.1f} ms for the "
          f"{bands} bands of the {size}^2 image at {n0} iterations)")
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [*cmd, "--snapshot-every", "1", "--snapshot-dir", d, "--batches",
         "1"], env=env, cwd=ROOT, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # a completed snapshot: the checkpointer writes LATEST after it renames
    # step_*.tmp into place, so a kill mid-write cannot count
    latest = os.path.join(d, f"host_{coll}", "LATEST")
    try:
        deadline = time.monotonic() + 300
        while (not os.path.exists(latest)
               and proc.poll() is None and time.monotonic() < deadline):
            time.sleep(0.02)
        if proc.poll() is not None:  # (the message reads its output)
            raise SmokeFailure(f"{label}: the first run ended before the "
                               f"kill:\n{proc.communicate()[0][-3000:]}")
        check(os.path.exists(latest),
              f"{label}: no fold snapshot of host {coll} within 300 s")
        t_kill = time.perf_counter()
        os.killpg(proc.pid, signal.SIGKILL)
        first = proc.communicate(timeout=60)[0]
        while group_alive(proc.pid) and time.perf_counter() < t_kill + 15:
            time.sleep(0.05)
        left = group_alive(proc.pid)
        check(not left, f"{label}: processes {left} of the group survived")
    finally:
        if proc.poll() is None or group_alive(proc.pid):
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    print(f"{label}: killed the group {(t_kill - t_start):.1f} s after its "
          f"start, once host {coll} had a fold snapshot; no process left")
    for line in first.splitlines():
        if line.startswith("[cluster]"):
            print(f"  first run: {line}")
    res = subprocess.Popen([*cmd, "--resume-from", d, "--batches", "2"],
                           env=env, cwd=ROOT, start_new_session=True,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, bufsize=1)
    stamped = []
    try:
        for line in res.stdout:
            stamped.append((time.perf_counter() - t_kill, line.rstrip()))
        rc = res.wait(timeout=600)
    finally:
        if res.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(res.pid, signal.SIGKILL)
            res.communicate()
    text = "\n".join(line for _, line in stamped)
    check(rc == 0, f"{label}: the resumed run exited {rc}:\n{text[-3000:]}")
    adopted = [(t, ln) for t, ln in stamped
               if "adopted durable deployment" in ln]
    replayed = [(t, ln) for t, ln in stamped
                if "replayed the pending batch" in ln]
    check(len(adopted) == 1 and "epoch 2, refined=True" in adopted[0][1],
          f"{label}: {adopted}")
    check(len(replayed) == 1 and "identical=True" in replayed[0][1],
          f"{label}: {replayed}")
    import ast
    replay_from = ast.literal_eval(replayed[0][1].split("replay_from=")[1])
    check(replay_from.get(coll, 0) > 0, f"{label}: replay_from {replay_from}")
    check("pipe over 2 hosts == sequential oracle: True" in text,
          f"{label}: no oracle line:\n{text[-3000:]}")
    for _, line in stamped:
        if line.startswith("[cluster]") or "adopt (epoch" in line:
            print(f"  resumed: {line.strip()}")
    print(f"{label}: kill -> adopted {adopted[0][0]:.1f} s, kill -> "
          f"replayed result {replayed[0][0]:.1f} s (the resumed launcher's "
          f"start and oracle included), replay_from {replay_from}; "
          f"group gone: True")


def run_durable_serving(torch, model, params, d) -> None:
    """13e: qwen2-0.5b (phase 6's model and weights) served with a store,
    persisting every step; crashed with two requests done and two in
    flight, then adopted on a fresh backend: every request answered once,
    with the tokens of an uncrashed engine without a store."""
    import gc
    from repro_torch.cluster import DeploymentStore
    from repro_torch.core import trace
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import LocalDecodeBackend, ServeEngine
    label = "[durable] 13e serving"
    reqs = launcher.requests(8, model.cfg.vocab, 16)

    def backend():
        return LocalDecodeBackend(model, params, n_slots=4, max_len=128)

    def drain(eng):
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return eng

    def tpot(eng):
        return pct([r.tpot * 1e3 for r in eng.completed
                    if len(r.tokens) > 1], 50)

    with torch.inference_mode():
        plain = drain(ServeEngine(backend()))
        want = {r.rid: r.tokens for r in plain.completed}
        rec = trace.enable(host="serve13")
        try:
            stored = drain(ServeEngine(
                backend(), store=DeploymentStore(os.path.join(d, "full")),
                persist_every=1))
            spans = [e for e in rec.events()
                     if e.kind == "span" and e.name == "persist"]
        finally:
            trace.disable()
        check(all(stored.poll(rid).tokens == t for rid, t in want.items()),
              f"{label}: the engine with a store gives other tokens")
        root = os.path.join(d, "crash")
        eng = ServeEngine(backend(), store=DeploymentStore(root),
                          persist_every=1)
        for r in reqs:
            eng.submit(r)
        while len(eng.completed) < 2 or len(eng._live) < 2:
            check(eng.step() > 0, f"{label}: drained before the crash")
        at = (len(eng.completed), len(eng._live), eng.steps_run)
        del eng  # the crash: engine and backend both go
        gc.collect()
        fresh = backend()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng2 = ServeEngine.adopt(fresh, DeploymentStore(root))
        torch.cuda.synchronize()
        adopt_ms = (time.perf_counter() - t0) * 1e3
        eng2.run_until_drained()
    answered = [r.rid for r in eng2.completed]
    check(sorted(answered) == sorted(want),
          f"{label}: answered {answered}, want each of {sorted(want)} once")
    for rid, toks in want.items():
        check(eng2.poll(rid).tokens == toks,
              f"{label}: request {rid} differs from the uncrashed run")
    nbytes = sorted({e.args["nbytes"] for e in spans})
    print(f"{label}: qwen2-0.5b, 4 slots, max_len 128, 8 requests; crashed "
          f"at step {at[2]} with {at[0]} done and {at[1]} in flight; the "
          f"adopted engine answered each rid once, tokens equal to the "
          f"uncrashed run (bf16, exact); adopt {adopt_ms:.1f} ms")
    print(f"{label}: persist span p50 {pct([e.dur * 1e3 for e in spans], 50):.2f} "
          f"ms over {len(spans)} steps, {nbytes[-1]} bytes a persist at most "
          f"({nbytes[0]} at least); tpot p50 {tpot(stored):.2f} ms with the "
          f"store vs {tpot(plain):.2f} ms without")


def run_durable_phase(torch, counts, farm_img, model, params, args,
                      rebalance_ms) -> None:
    """Phase 13: durability on the card (13a-13e)."""
    import multiprocessing
    import tempfile
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    print(f"[durable] /dev/shm: {shm_free_bytes()} bytes free, "
          f"{len(shm_before)} entries")
    with tempfile.TemporaryDirectory() as tmp:
        farm_dir = os.path.join(tmp, "farm")
        run_durable_farm(torch, counts, farm_img, args, farm_dir)
        run_snapshot_replay(torch, counts, farm_img, args,
                            os.path.join(tmp, "replay"), rebalance_ms)
        run_adoption(torch, counts, farm_img, args, farm_dir,
                     os.path.join(tmp, "live"))
        run_launcher_kill(torch, os.path.join(tmp, "launcher"))
        run_durable_serving(torch, model, params, os.path.join(tmp, "serve"))
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    check(not left, f"[durable] /dev/shm entries left: {left}")
    check(not multiprocessing.active_children(),
          "[durable] host processes still running after phase 13")
    print(f"[durable] /dev/shm: {shm_free_bytes()} bytes free, nothing "
          f"left; no host process left; phase 13 wall: "
          f"{time.perf_counter() - t_phase:.1f} s")


# -- phase 14: the fault-injection simulator on the card ------------------------------

# (seed, recovery mode) of 14b: FaultSchedule.random over the 2-host farm
# plan gives a kill, a double kill, a controller-step kill and a kill
# during recovery for these seeds
SIM_FARM_SEEDS = ((2, "restart"), (7, "rebalance"), (5, "restart"),
                  (11, "rebalance"))
SIM_FARM_KINDS = ("kill", "double-kill", "ctrl-step-kill",
                  "kill-during-recovery")
# run_scenario seeds that wait out two 8 s recv timeouts each (~17 s a seed
# on the CPU): 14a leaves them to the CPU tests and the CI's sim lane, which
# run every seed; the other 17 still fire all five fault kinds
SIM_RECV_TIMEOUT_SEEDS = (5, 7, 9)


def sim_family(label, runs) -> list:
    """14a: run one family's scenarios in turn, each must be ``ok``; print
    each and the family's counts, virtual ticks and wall."""
    t0 = time.perf_counter()
    results = []
    for run in runs:
        r = run()
        print(f"[sim] {label}: {r.describe()}")
        check(r.ok, f"[sim] {label}: scenario failed: {r.failures}")
        results.append(r)
    ticks = [r.ticks for r in results]
    print(f"[sim] {label}: {len(results)} scenarios, "
          f"{sum(r.fired for r in results)} faults fired, "
          f"{sum(r.recoveries for r in results)} recoveries, virtual ticks "
          f"median {statistics.median(ticks)} max {max(ticks)}, wall "
          f"{time.perf_counter() - t0:.1f} s")
    return results


def run_sim_farm(torch, counts, farm_img, args) -> None:
    """14b: the Mandelbrot farm at phase 2's width over 2 simulated hosts
    under seeded fault schedules (see the module docstring)."""
    import random

    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import partition
    from repro_torch.cluster.sim import FaultSchedule, drive_scenario
    from repro_torch.cluster.transport import pack_raw, unpack_raw
    label = "[sim] 14b farm x2"
    bands = args[2]
    factory = (workloads.mandelbrot_factory, args)
    plan = partition(workloads.mandelbrot_factory(*args), hosts=2)

    def same(out):
        return (None if np.array_equal(workloads.assemble(out["collect"]),
                                       farm_img)
                else "the image differs from phase 2")

    kinds = []
    for seed, mode in SIM_FARM_SEEDS:
        sched = FaultSchedule.random(random.Random(seed), plan)
        kinds.append(sched.kind)
        before = counts()["mandelbrot"]
        t0 = time.perf_counter()
        run = drive_scenario(workloads.mandelbrot_factory(*args), factory,
                             plan, sched, mode, instances=bands, check=same,
                             microbatch_size=16, timeout_s=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()["mandelbrot"] - before
        check(not run.failures, f"{label} seed {seed}: {run.failures}")
        check(len(run.outs) == 3, f"{label} seed {seed}: "
                                  f"{len(run.outs)} batches completed")
        check(all(ev.refined is True for ev in run.events),
              f"{label} seed {seed}: a recovery did not refine")
        check(launched >= 3 * bands,
              f"{label} seed {seed}: {launched} launches here for 3 batches")
        fired = [ev for ev in sched.events if ev.fired]
        check(bool(fired) and bool(run.events),
              f"{label} seed {seed}: no fault fired or no recovery")
        back = []  # kill -> recovered result, each armed batch with a fire
        for t_start, t_end in run.spans[1:]:
            at = [ev.fired_at for ev in fired if t_start <= ev.fired_at
                  <= t_end]
            if at:
                back.append((t_end - min(at)) * 1e3)
        print(f"{label} seed {seed} ({sched.kind}, {mode}): "
              f"[{sched.describe()}] fired {len(fired)}, recoveries "
              f"{len(run.events)}, 3 batches equal to phase 2, merged trace "
              f"conforms, no duplicate delivery, chain refines; launches "
              f"here {launched} ({launched - 3 * bands} beyond one a band a "
              f"batch); kill -> recovered result "
              f"{', '.join(f'{w:.1f}' for w in back)} ms; batch walls "
              f"{', '.join(f'{(b - a) * 1e3:.1f}' for a, b in run.spans)} "
              f"ms; virtual ticks {run.ticks}; wall {wall:.2f} s")
        for ev in run.events:
            print(f"{label} seed {seed}:   {ev.describe()}")
    check(sorted(kinds) == sorted(SIM_FARM_KINDS),
          f"{label}: fault kinds {kinds}, not {SIM_FARM_KINDS}")
    # every result crosses from its simulated host to the controller as
    # raw bytes (the process-host path): what one batch's round trip costs
    result = {"collect": run.outs[-1]["collect"]}
    trips = []
    for _ in range(3):
        t0 = time.perf_counter()
        packed = pack_raw(result)
        unpack_raw(packed)
        trips.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(len(leaf.buf) for leaf in
                 packed["collect"].values())
    print(f"{label}: a result's round trip through host bytes "
          f"(pack_raw + unpack_raw, {nbytes} bytes): median "
          f"{statistics.median(trips):.1f} ms of 3")


def run_sim_phase(torch, counts, farm_img, args) -> None:
    """Phase 14: the fault-injection simulator on the card (14a, 14b)."""
    import multiprocessing
    import threading
    from repro_torch.cluster import sim
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    threads_before = set(threading.enumerate())
    seeds = [s for s in range(20) if s not in SIM_RECV_TIMEOUT_SEEDS]
    scen = sim_family(
        "14a run_scenario seeds 0-19 but "
        + ", ".join(map(str, SIM_RECV_TIMEOUT_SEEDS)),
        [lambda s=s: sim.run_scenario(s) for s in seeds])
    kinds = {r.kind for r in scen}
    check(kinds == {"kill", "stall", "double-kill", "kill-during-recovery",
                    "ctrl-step-kill"}, f"[sim] 14a fault kinds {kinds}")
    crash = sim_family("14a kill-controller", [
        lambda s=s: sim.run_kill_controller_scenario(s) for s in range(5)])
    check(len({r.kind for r in crash}) == 5,
          f"[sim] 14a controller-crash variants {[r.kind for r in crash]}")
    sim_family("14a stall-race seeds 0-1",
               [lambda s=s: sim.run_stall_race_scenario(s) for s in (0, 1)])
    sim_family("14a coalesce-kill seeds 0-5",
               [lambda s=s: sim.run_coalesce_kill_scenario(s)
                for s in range(6)])
    sim_family("14a pipe-brick", [sim.run_pipe_brick_scenario])
    run_sim_farm(torch, counts, farm_img, args)
    deadline = time.monotonic() + 30.0
    while True:  # a killed host thread unwinds at its next poll
        left = [t.name for t in set(threading.enumerate()) - threads_before
                if t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(not left, f"[sim] host threads left after phase 14: {left}")
    check(not multiprocessing.active_children(),
          "[sim] host processes still running after phase 14")
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    check(not left, f"[sim] /dev/shm entries left: {left}")
    print(f"[sim] no host thread, host process or /dev/shm entry left; "
          f"phase 14 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 15: the cost model and the autoscaler on the card -------------------------

def warm_median(walls) -> float:
    """The median of a deployment's warm batch walls (start and the cold
    batch left out)."""
    return statistics.median(walls[2:])


def run_cost_cuts(torch, counts, label, net, factory, n, mb, kernel,
                  per_batch, same, expect_ms) -> None:
    """15a for one workload: ``calibrate`` on the card (every bandwidth of
    ``device``, ``pipe`` and ``shm``), the measured stages against phase 1
    (``expect_ms``: stage -> what phase 1's kernel times predict; the ratio
    is printed, not gated), then the count and the cost cut deployed over
    2 and 4 ``device`` hosts, 3 batches each, each batch equal to the
    single-host run (``same``), and the count plan hot-swapped to the cost
    plan through ``reconfigure(plan=)``."""
    from repro_torch.cluster import (ClusterDeployment, calibrate,
                                     check_refinement, cost_assignment,
                                     partition)
    t0 = time.perf_counter()
    prof = calibrate(net, instances=2 * mb, microbatch_size=mb,
                     transports=("device", "pipe", "shm"))
    wall = time.perf_counter() - t0
    print(f"[costs] 15a {label}: calibrated {len(prof.costs)} process "
          f"cost(s) in {wall * 1e3:.1f} ms (microbatch {mb})")
    for line in prof.describe().splitlines():
        print(f"[costs] 15a {label}:   {line}")
    check(bool(prof.costs) and all(
        c.source == "measured" and c.wall_s > 0 for c in prof.costs.values()),
        f"[costs] 15a {label}: a stage was not measured")
    check(set(prof.bandwidths) == {"device", "pipe", "shm"}
          and all(bw > 0 for bw in prof.bandwidths.values()),
          f"[costs] 15a {label}: bandwidths {prof.bandwidths}")
    for stage, (want_ms, what) in expect_ms.items():
        got_ms = prof.costs[stage].wall_s * 1e3
        print(f"[costs] 15a {label}: {stage} measured {got_ms:.4f} ms a "
              f"chunk against {what} {want_ms:.4f} ms: ratio "
              f"{got_ms / want_ms:.2f} (host dispatch included; not gated)")
    walls = {}
    for hosts in (2, 4):
        count = partition(net, hosts=hosts)
        cost = partition(net, assignment=cost_assignment(
            net, hosts, prof, transport="device"))
        same_cut = cost.assignment == count.assignment
        print(f"[costs] 15a {label} x{hosts}: count cut "
              f"{[f'{c.src}->{c.dst}' for c in count.cut]}, cost cut "
              f"{[f'{c.src}->{c.dst}' for c in cost.cut]} over "
              f"{len(cost.hosts())} host(s): "
              f"{'the same plan' if same_cut else 'different plans'}")
        for name, plan in (("count", count), ("cost", cost)):
            walls[(hosts, name)] = run_deployment(
                torch, f"15a {label} {name} cut device x{hosts}", net, plan,
                "device", factory, n, 3, counts, kernel, per_batch, same,
                microbatch=mb)
        print(f"[costs] 15a {label} x{hosts}: warm batch median, count cut "
              f"{warm_median(walls[(hosts, 'count')]):.1f} ms, cost cut "
              f"{warm_median(walls[(hosts, 'cost')]):.1f} ms")
    # the hot swap: a live count-cut deployment onto the cost cut
    count = partition(net, hosts=2)
    cost = partition(net, assignment=cost_assignment(net, 2, prof,
                                                     transport="device"))
    for plan in (count, cost):
        check(check_refinement(net, plan),
              f"[costs] 15a {label}: a plan does not refine the network")
    with ClusterDeployment(net, plan=count, transport="device",
                           microbatch_size=mb, factory=factory,
                           timeout_s=300) as dep:
        check(same(dep.run(instances=n)),
              f"[costs] 15a {label}: the count cut's batch differs")
        t0 = time.perf_counter()
        ev = dep.reconfigure(plan=cost)
        swap_ms = (time.perf_counter() - t0) * 1e3
        check(ev.mode == "reconfigure" and ev.refined is True
              and dep.plan.assignment == cost.assignment,
              f"[costs] 15a {label}: hot swap {ev.describe()}")
        before = counts()[kernel]
        check(same(dep.run(instances=n)),
              f"[costs] 15a {label}: the batch after the hot swap differs")
        torch.cuda.synchronize()
        launched = counts()[kernel] - before
        check(launched == per_batch, f"[costs] 15a {label}: {launched} "
                                     f"{kernel} launches after the swap")
    print(f"[costs] 15a {label}: hot swap count -> cost cut over 2 device "
          f"hosts: {ev.describe()}; reconfigure {swap_ms:.1f} ms; the next "
          f"batch equal, {launched} {kernel} launches")


def run_cost_launcher(torch) -> None:
    """15b: ``python -m repro_torch.launch.cluster`` over 2 ``device`` hosts
    with the cost cut, calibration and the default autoscale policy."""
    label = "[costs] 15b launcher"
    flags = ["--workload", "mandelbrot", "--bands", "64", "--size", "4096",
             "--iters", "1000", "--microbatch", "16", "--transport",
             "device", "--hosts", "2", "--cut", "cost", "--calibrate",
             "--autoscale", "--batches", "4"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.cluster",
                        *flags], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"{label}: exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
    lines = r.stdout.splitlines()
    batches = [ln for ln in lines if ln.startswith("[cluster] batch ")]
    check(len(batches) == 4 and all("identical=True" in ln
                                    for ln in batches),
          f"{label}: batches {batches}")
    check(any("sequential oracle: True" in ln for ln in lines),
          f"{label}: no oracle line:\n{r.stdout[-3000:]}")
    print(f"{label}: {' '.join(flags)}")
    for ln in lines:
        if (ln.startswith("[cluster]") or ln.startswith("group")
                or ln.startswith("collect") or ln.startswith("bandwidth")
                or ln.startswith("  host") or ln.startswith("  cut")):
            print(f"{label}:   {ln}")
    events = [ln for ln in lines if ln.startswith("[cluster] autoscale ")]
    print(f"{label}: {len(events)} autoscale event(s); every batch "
          f"identical=True; wall {wall:.1f} s (process start included)")


def run_workload_family(torch) -> None:
    """15c: ``run_workload_scenario`` for seeds 0-5 on the card, two of
    each kind: a spike scales out, a straggler is migrated away, a slow
    start causes no action."""
    from repro_torch.cluster import sim
    want = {"spike": 1, "straggler": 1, "slow-start": 0}
    for seed in range(6):
        t0 = time.perf_counter()
        r = sim.run_workload_scenario(seed)
        wall = time.perf_counter() - t0
        print(f"[costs] 15c {r.describe()}")
        check(r.ok, f"[costs] 15c seed {seed}: {r.failures}")
        kind = r.kind.split("/")[1]
        check(r.recoveries == want[kind],
              f"[costs] 15c seed {seed}: {r.recoveries} epoch bumps for "
              f"{kind}")
        print(f"[costs] 15c seed {seed} ({kind}): {r.fired} autoscale "
              f"decision(s), {r.recoveries} epoch bump(s), virtual ticks "
              f"{r.ticks}, wall {wall:.2f} s")


def run_costs_phase(torch, counts, farm_img, edge_maps, entries, args,
                    n_img, size) -> None:
    """Phase 15: the cost model and the autoscaler on the card (15a-15c)."""
    import multiprocessing
    import threading

    import numpy as np
    from repro_torch import workloads
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    threads_before = set(threading.enumerate())
    W, H, bands, iters = args
    mb = 16
    band_ms, stencil_ms = entries[0]["ms"], entries[1]["ms"]
    same_img = lambda out: np.array_equal(  # noqa: E731
        workloads.assemble(out["collect"]), farm_img)
    run_cost_cuts(torch, counts, "mandelbrot", workloads.mandelbrot_factory(
        *args), (workloads.mandelbrot_factory, args), bands, mb,
        "mandelbrot", bands, same_img,
        {"group": (mb * band_ms, f"{mb} x phase 1's band")})

    def same_edges(out):
        got = out["collector"]
        return len(got) == len(edge_maps) and all(
            np.array_equal(a, b) for a, b in zip(got, edge_maps))

    factory = (workloads.image_pipeline_factory, (n_img, size))
    run_cost_cuts(torch, counts, "image", factory[0](*factory[1]), factory,
                  n_img, 4, "stencil", n_img, same_edges,
                  {"engine2": (4 * stencil_ms, "4 x phase 1's EDGE5")})
    run_cost_launcher(torch)
    run_workload_family(torch)
    deadline = time.monotonic() + 30.0
    while True:  # a simulated host thread unwinds at its next poll
        left = [t.name for t in set(threading.enumerate()) - threads_before
                if t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(not left, f"[costs] host threads left after phase 15: {left}")
    check(not multiprocessing.active_children(),
          "[costs] host processes still running after phase 15")
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    check(not left, f"[costs] /dev/shm entries left: {left}")
    print(f"[costs] no host thread, host process or /dev/shm entry left; "
          f"phase 15 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 16: the clustered decode farm on the card ----------------------------------

FARM_SPEC = ("model", "qwen2-0.5b", False)   # full width, seed-0 weights


def farm_backend(transport, hosts=2, **kw):
    """Phase 16's decode farm: 4 slots in 2 shards of 2 rows, max_len 128,
    prefill chunks of 8, on the card."""
    from repro_torch.serve import ClusterDecodeBackend
    return ClusterDecodeBackend(FARM_SPEC, n_slots=4, shards=2, hosts=hosts,
                                transport=transport, max_len=128,
                                prefill_chunk=LAUNCH_PREFILL_CHUNK, **kw)


def tree_bytes(tree) -> int:
    import torch.utils._pytree as pytree
    return sum(l.numel() * l.element_size() for l in pytree.tree_leaves(tree))


def serve_farm(torch, be, reqs, label, after_step=None,
               engine=None) -> dict:
    """Drive ``reqs`` through a ``ServeEngine`` over the farm backend
    ``be`` (or ``engine``, already holding them); ``after_step(eng)`` runs
    after every step.  Returns the responses by rid, the engine, the
    decode-step and persist spans, the wall, and the bytes that crossed the
    cut in each decode step.  The engine records into a recorder of its
    own: thread hosts drain the process-default one after every batch."""
    from repro_torch.core.trace import TraceRecorder
    from repro_torch.serve import ServeEngine
    cut_bytes = []
    inner = be.dep.run

    def run(*a, **k):  # the cut's bytes of every decode batch (2 items)
        out = inner(*a, **k)
        if len(out["collect"]) == be.shards:
            cut_bytes.append(sum(sum(r.metrics.get("sent_bytes", {})
                                     .values())
                                 for r in out.reports if r.metrics))
        return out

    be.dep.run = run
    try:
        t0 = time.perf_counter()
        eng = engine
        if eng is None:
            eng = ServeEngine(be, recorder=TraceRecorder(host="serve16"))
            for r in reqs:
                eng.submit(r)
        while eng.pending or eng._live:
            eng.step()
            if after_step is not None:
                after_step(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = [e for e in eng.rec.events() if e.kind == "span"]
    finally:
        be.dep.run = inner
    done = list(eng.completed)
    check(sorted(r.rid for r in done) == sorted(r.rid for r in reqs),
          f"{label}: answered {sorted(r.rid for r in done)}")
    for r in reqs:
        resp = eng.poll(r.rid)
        check(len(resp.tokens) == r.max_new and resp.finish_reason == "length",
              f"{label}: request {r.rid} gave {len(resp.tokens)} tokens")
        check([e.kind for e in resp.slot_events] == ["join", "leave"],
              f"{label}: request {r.rid} slot events {resp.slot_events}")
    return {"tokens": {r.rid: eng.poll(r.rid).tokens for r in reqs},
            "eng": eng, "wall": wall, "cut_bytes": cut_bytes,
            "decode": sorted(e.dur * 1e3 for e in spans
                             if e.name == "decode_chunk"),
            "persist": [e for e in spans if e.name == "persist"]}


def report_farm(label, run, local_step_ms) -> None:
    """tok/s, TTFT and TPOT, the farm step against phase 7's local step,
    and the cut's bytes a decode step."""
    done = run["eng"].completed
    toks = sum(len(r.tokens) for r in done)
    span = (max(r.finished_at for r in done)
            - min(r.submitted_at for r in done))
    ttft = [r.ttft * 1e3 for r in done]
    tpot = [r.tpot * 1e3 for r in done if len(r.tokens) > 1]
    dec = run["decode"]
    cut = run["cut_bytes"]
    print(f"{label}: {len(done)} requests, {toks} tokens in "
          f"{span * 1e3:.1f} ms: {toks / span:.1f} tok/s; ttft p50 "
          f"{pct(ttft, 50):.1f} ms p99 {pct(ttft, 99):.1f} ms; tpot p50 "
          f"{pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} ms")
    print(f"{label}: farm decode step p50 {pct(dec, 50):.2f} ms p99 "
          f"{pct(dec, 99):.2f} ms over {len(dec)} steps = "
          f"{pct(dec, 50) / local_step_ms:.2f} x phase 7's local step "
          f"({local_step_ms:.2f} ms); cut {pct(cut, 50)} bytes a decode "
          f"step (p50, {min(cut)}-{max(cut)}); wall {run['wall']:.2f} s")


def top2_margin(torch, model, params, prompt, prefix) -> float:
    """The top-2 logit margin of one request alone (one row, max_len 128)
    at the token after ``prompt`` + ``prefix``: how near the argmax was to
    flipping where two runs first differ."""
    import torch.utils._pytree as pytree
    dev = pytree.tree_leaves(params)[0].device
    cache = model.init_cache(1, 128, device=dev)
    logits = None
    for t in (*prompt, *prefix):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[t]], dtype=torch.int32,
                                        device=dev))
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def first_difference(got: dict, want: dict):
    """(rid, step) of the first request whose tokens differ, or None."""
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        for t, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return rid, t
        if len(a) != len(b):
            return rid, min(len(a), len(b))
    return None


def run_farm_phase(torch, model, params, phase7) -> None:
    """Phase 16: full-width qwen2-0.5b served by the clustered decode farm
    (16a-16f).  ``model``/``params`` are phase 6's (the farm's seed-0
    weights); ``phase7`` is what phase 7's 4-slot launcher run gave."""
    import gc
    import multiprocessing
    import tempfile
    import threading
    from repro_torch.cluster import DeploymentStore
    from repro_torch.core.trace import TraceRecorder
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import LocalDecodeBackend, ServeEngine
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    threads_before = set(threading.enumerate())
    reqs = launcher.requests(8, model.cfg.vocab, 16)
    local_ms = phase7["step_ms"]

    def free(be):
        be.close()
        del be
        gc.collect()
        torch.cuda.empty_cache()

    # the reference the farm must equal: a local engine at the shards'
    # decode shape (M = 2 rows), on the same weights
    eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=2,
                                         max_len=128))
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    m2 = {r.rid: eng.poll(r.rid).tokens for r in reqs}
    del eng

    # 16a: 2 device hosts, then 2 pipe hosts
    streams = {}
    for transport in ("device", "pipe"):
        label = f"[farm] 16a {transport}"
        t0 = time.perf_counter()
        be = farm_backend(transport)
        up = time.perf_counter() - t0
        cache_mb = tree_bytes(be.shard_cache[0]) / 1e6
        run = serve_farm(torch, be, reqs, label)
        streams[transport] = run["tokens"]
        report_farm(label, run, local_ms)
        print(f"{label}: backend built and deployment started in "
              f"{up:.1f} s; a shard's cache {cache_mb:.2f} MB; epoch "
              f"{be.dep.epoch}, recoveries {be.recoveries}")
        free(be)
    check(streams["device"] == streams["pipe"],
          "[farm] 16a: the device and pipe farms' streams differ")
    diff = first_difference(streams["device"], m2)
    if diff is not None:
        rid, t = diff
        r = next(q for q in reqs if q.rid == rid)
        margin = top2_margin(torch, model, params, r.prompt,
                             m2[rid][:t])
        print(f"[farm] 16a FAULT: request {rid} differs from the local "
              f"M = 2 engine at step {t} (farm {streams['device'][rid][t:t+1]}"
              f", local {m2[rid][t:t+1]}); top-2 logit margin alone there "
              f"{margin:.4f}")
    check(diff is None, "[farm] 16a: the farm's streams differ from the "
                        "local engine at the shards' decode shape (M = 2)")
    same4 = sum(streams["device"][rid] == t
                for rid, t in phase7["tokens"].items())
    alone = sum(streams["device"][rid] == t
                for rid, t in phase7["alone"].items())
    print(f"[farm] 16a: device == pipe == local M = 2 engine, bit for bit "
          f"(8 requests); {same4}/8 equal phase 7's 4-slot local run, "
          f"{alone}/8 the one-slot oracle (not gated: other decode shapes)")
    want = streams["device"]

    # 16b: scale-out to 3 device hosts after the first step
    label = "[farm] 16b device scale(3)"
    be = farm_backend("device")
    events = []

    def grow(eng):
        if eng.steps_run == 1 and not events:
            t0 = time.perf_counter()
            events.append((be.scale(3), time.perf_counter() - t0))

    run = serve_farm(torch, be, reqs, label, after_step=grow)
    ev, scale_s = events[0]
    check(ev.mode == "reconfigure" and ev.refined is True
          and be.dep.epoch == 2,
          f"{label}: event {ev.mode} refined={ev.refined} epoch "
          f"{be.dep.epoch}")
    check(all(e.refined is True for e in be.dep.events),
          f"{label}: an event did not refine")
    check(run["tokens"] == want, f"{label}: streams differ from 16a")
    report_farm(label, run, local_ms)
    print(f"{label}: reconfigure {scale_s * 1e3:.1f} ms, epoch 2, refined, "
          f"streams equal 16a")
    free(be)

    # 16c: host 1 of 2 pipe hosts killed after step 3
    label = "[farm] 16c pipe kill_host(1)"
    be = farm_backend("pipe")
    killed = {}

    def kill(eng):
        if eng.steps_run == 3 and "at" not in killed:
            be.dep.kill_host(1)
            killed["at"] = time.perf_counter()
        elif "at" in killed and "wall" not in killed:
            killed["wall"] = time.perf_counter() - killed["at"]
            killed["recoveries"] = be.recoveries

    run = serve_farm(torch, be, reqs, label, after_step=kill)
    check(killed.get("recoveries", 0) >= 1,
          f"{label}: the step after the kill did not recover ({killed})")
    check(all(e.refined is True for e in be.dep.events),
          f"{label}: an event did not refine")
    check(run["tokens"] == want, f"{label}: streams differ from 16a")
    report_farm(label, run, local_ms)
    print(f"{label}: kill -> step completed {killed['wall']:.2f} s, "
          f"recoveries {be.recoveries}, events "
          + "; ".join(f"{e.mode} {e.epoch_from}->{e.epoch_to}"
                      for e in be.dep.events)
          + "; streams equal 16a")
    free(be)

    # 16d: a durable farm closed after 4 steps, adopted by a fresh one
    label = "[farm] 16d device adopt"
    with tempfile.TemporaryDirectory() as d:
        be = farm_backend("device", snapshot_dir=d)
        eng = ServeEngine(be, store=be.store,
                          recorder=TraceRecorder(host="serve16d"))
        for r in reqs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        first = [e for e in eng.rec.events()
                 if e.kind == "span" and e.name == "persist"]
        at = (len(eng.completed), len(eng._live), eng.steps_run)
        del eng
        free(be)  # the crash: engine and backend both go
        be = farm_backend("device", snapshot_dir=d)
        t0 = time.perf_counter()
        eng2 = ServeEngine.adopt(be, DeploymentStore(d),
                                 recorder=TraceRecorder(host="serve16d"))
        adopt_ms = (time.perf_counter() - t0) * 1e3
        run = serve_farm(torch, be, reqs, label, engine=eng2)
        answered = [r.rid for r in eng2.completed]
        check(sorted(answered) == sorted(want),
              f"{label}: answered {answered}, want each rid once")
        check(run["tokens"] == want, f"{label}: streams differ from 16a")
        persist = first + run["persist"]
        nbytes = sorted(e.args["nbytes"] for e in persist)
        print(f"{label}: closed at step {at[2]} with {at[0]} done and "
              f"{at[1]} in flight; adopted in {adopt_ms:.1f} ms; every "
              f"request answered once, streams equal 16a; persist span "
              f"p50 {pct([e.dur * 1e3 for e in persist], 50):.2f} ms over "
              f"{len(persist)} steps, {nbytes[0]}-{nbytes[-1]} bytes each")
        free(be)

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    # 16e: the kill-during-serving sweep on the card
    label = "[farm] 16e sim --serve-kill 12"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.cluster.sim",
                        "--serve-kill", "12"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("seed")]
    check(r.returncode == 0 and len(lines) == 12
          and all("[ok]" in ln for ln in lines),
          f"{label}: exited {r.returncode}:\n{r.stdout[-3000:]}"
          f"{r.stderr[-3000:]}")
    print(f"{label}: 12 scenarios ok, wall {wall:.1f} s (process start "
          f"included); {r.stdout.strip().splitlines()[-1]}")

    # 16f: the serve launcher over 2 device hosts with the autoscaler
    label = "[farm] 16f launcher"
    flags = ["--arch", "qwen2-0.5b", "--hosts", "2", "--transport",
             "device", "--autoscale"]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *flags], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0 and "(cluster[devicex2h/2 shards]" in r.stdout
          and ": 8 requests" in r.stdout,
          f"{label}: exited {r.returncode}:\n{r.stdout[-3000:]}"
          f"{r.stderr[-3000:]}")
    print(f"{label}: python -m repro_torch.launch.serve {' '.join(flags)}; "
          f"wall {wall:.1f} s (process start included)")
    for ln in r.stdout.splitlines():
        print(f"{label}:   {ln}")

    deadline = time.monotonic() + 30.0
    while True:  # a stopped host thread unwinds at its next poll
        left = [t.name for t in set(threading.enumerate()) - threads_before
                if t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(not left, f"[farm] host threads left after phase 16: {left}")
    check(not multiprocessing.active_children(),
          "[farm] host processes still running after phase 16")
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    check(not left, f"[farm] /dev/shm entries left: {left}")
    print(f"[farm] no host thread, host process or /dev/shm entry left; "
          f"phase 16 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 17: the encoder-decoder on the card ---------------------------------------

WHISPER_FRAMES = 1500  # whisper's n_audio_ctx: the frames of a 30 s window
WHISPER_TEXT = 448     # whisper's n_text_ctx
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>
WHISPER_PROMPT = (50258, 50259, 50359, 50363)
WHISPER_STEPS = 124    # greedy steps after the prompt
WHISPER_CPU_TOL = 1e-3  # f32 card forward against the CPU's plain path


def run_whisper_phase(torch, dev, counts) -> tuple:
    """Phase 17: full-width whisper-tiny (4 encoder and 4 decoder layers,
    d=384, 6/6 heads of 64, vocab 51865; f32 weights from seed 0, 4096
    learned decoder positions) on 4 utterances of 1500 seeded stub frames.

    - bf16 ``forward`` on (4, 448) seeded tokens: finite logits, flash
      launched exactly 12 times (4 encoder layers, 4 causal decoder
      self-attentions, 4 cross-attentions) and no other kernel;
    - f32 ``forward`` against ``prefill`` of the first 224 tokens and one
      ``decode_step`` at positions 223 and 224, within 3e-3 (the
      reference's gate), on the same frames;
    - the f32 card forward against the same forward on the CPU (the plain
      path, the same weights), within ``WHISPER_CPU_TOL`` (1e-3);
    - greedy decoding in bf16: the 4-token start-of-transcript prompt,
      ``max_len`` 448, then 124 greedy steps; ``prefill`` must launch flash
      8 times (encoder and cross-attention), each decode step exactly 4
      (the cross-attention; the self-attention takes the KV-cache
      einsums).  It prints encode and prefill ms, the decode step's p50
      and p99, tokens/s and launches a step.

    Returns (model, params, cache, tokens) of the last decode step, for
    the profile."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, encdec
    t_phase = time.perf_counter()
    cfg = get_config("whisper-tiny")
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[whisper] {cfg.name}: {model.param_count(params) / 1e6:.1f} M "
          f"params ({cfg.param_dtype}), {cfg.encdec.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d={cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.hd}, vocab {cfg.vocab}, "
          f"{params['dec_pos'].shape[0]} decoder positions")
    rng = np.random.default_rng(0)
    B = 4
    frames = torch.from_numpy(rng.standard_normal(
        (B, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, WHISPER_TEXT)).astype(np.int32)).to(dev)
    names = list(counts())

    def flash_only(n):
        return {k: (n if k == "flash_attention" else 0) for k in names}

    def launched(fn, want, what):
        before = counts()
        out = fn()
        got = {k: v - before[k] for k, v in counts().items()}
        check(got == want, f"[whisper] {what} launched {got}, not {want}")
        return out

    n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers
    fwd_want = flash_only(n_enc + 2 * n_dec)
    with torch.inference_mode():
        walls = []
        for _ in range(4):  # the first warms cuBLAS up
            t0 = time.perf_counter()
            logits = launched(lambda: model.forward(params, toks,
                                                    frames=frames)[0],
                              fwd_want, "bf16 forward")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        check(logits.shape == (B, WHISPER_TEXT, cfg.vocab)
              and logits.dtype == torch.bfloat16,
              f"[whisper] bf16 forward: {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()),
              "[whisper] bf16 forward: non-finite logits")
        del logits
        fwd_ms = statistics.median(walls[1:])
        print(f"[whisper] forward bf16 ({B}, {WHISPER_TEXT}) tokens over "
              f"({B}, {WHISPER_FRAMES}) frames: {fwd_ms:.1f} ms median of 3 "
              f"(first {walls[0]:.1f} ms); finite logits; flash launches "
              f"per forward {n_enc + 2 * n_dec}")

        m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
        half = WHISPER_TEXT // 2
        t0 = time.perf_counter()
        full = launched(lambda: m32.forward(params, toks, frames=frames)[0],
                        fwd_want, "f32 forward")
        torch.cuda.synchronize()
        f32_ms = (time.perf_counter() - t0) * 1e3
        logits_p, cache = launched(
            lambda: m32.prefill(params, toks[:, :half], max_len=half + 1,
                                frames=frames),
            flash_only(n_enc + n_dec), "f32 prefill")
        logits_d, _ = launched(
            lambda: m32.decode_step(params, cache, toks[:, half:half + 1]),
            flash_only(n_dec), "f32 decode step")
        err_p = float((logits_p[:, -1] - full[:, half - 1]).abs().max())
        err_d = float((logits_d[:, -1] - full[:, half]).abs().max())
        del logits_p, logits_d, cache
        check(err_p < 3e-3 and err_d < 3e-3,
              f"[whisper] f32 forward vs prefill+decode: {err_p}, {err_d} "
              ">= 3e-3")
        print(f"[whisper] forward f32 {f32_ms:.1f} ms: logits at "
              f"{half - 1}/{half} vs prefill({half}) + decode_step: "
              f"max|diff| {err_p:.2e} / {err_d:.2e} (gate 3e-3)")

        cpu_params = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
        t0 = time.perf_counter()
        want, _ = m32.forward(cpu_params, toks.cpu(), frames=frames.cpu())
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err_c = float((full.cpu() - want).abs().max())
        scale = float(want.abs().max())
        del full, want, cpu_params
        check(err_c <= WHISPER_CPU_TOL,
              f"[whisper] f32 card forward vs CPU: {err_c} > "
              f"{WHISPER_CPU_TOL}")
        print(f"[whisper] f32 card forward vs the CPU's plain path "
              f"({cpu_ms:.0f} ms there): max|diff| {err_c:.2e} (gate "
              f"{WHISPER_CPU_TOL}; max|logit| {scale:.3f})")

        prompt = torch.tensor([WHISPER_PROMPT] * B, dtype=torch.int32,
                              device=dev)
        encdec.encode(cfg, params, frames)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launched(lambda: encdec.encode(cfg, params, frames),
                 flash_only(n_enc), "encode")
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        logits, cache = launched(
            lambda: model.prefill(params, prompt, max_len=WHISPER_TEXT,
                                  frames=frames),
            flash_only(n_enc + n_dec), "prefill")
        tok = model.greedy_token(logits)[:, None]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        steps, out = [], [tok]
        for _ in range(WHISPER_STEPS):
            t0 = time.perf_counter()
            step_in = tok
            logits, cache = launched(
                lambda: model.decode_step(params, cache, step_in),
                flash_only(n_dec), "decode step")
            tok = model.greedy_token(logits)[:, None]
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            out.append(tok)
        check(bool(torch.isfinite(logits).all()),
              "[whisper] greedy decoding: non-finite logits")
        n_tok = len(WHISPER_PROMPT) + WHISPER_STEPS
        check(int(cache["step"]) == n_tok
              and bool(cache["self"]["index"].eq(n_tok).all()),
              f"[whisper] the cache stands at step {int(cache['step'])}, "
              f"not {n_tok}")
        gen = torch.cat(out, dim=1)
        check(bool(((gen >= 0) & (gen < cfg.vocab)).all()),
              "[whisper] greedy tokens out of the vocabulary")
        print(f"[whisper] greedy bf16, {B} utterances, prompt "
              f"{len(WHISPER_PROMPT)} tokens, {WHISPER_STEPS} steps, "
              f"max_len {WHISPER_TEXT}: encode {enc_ms:.2f} ms, prefill "
              f"{prefill_ms:.2f} ms (encode included), decode step p50 "
              f"{pct(steps, 50):.2f} / p99 {pct(steps, 99):.2f} ms, "
              f"{B * WHISPER_STEPS / (sum(steps) / 1e3):.1f} tok/s; flash "
              f"launches: prefill {n_enc + n_dec}, {n_dec} a step; "
              f"{len(set(gen[0].tolist()))} distinct tokens in utterance 0")
    print(f"[whisper] phase 17 wall: {time.perf_counter() - t_phase:.1f} s")
    return model, params, cache, tok


# -- phases 6-9: the decoder LMs -----------------------------------------------------

def describe(cfg) -> str:
    if cfg.moe is not None:
        m = cfg.moe
        return (f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads}/"
                f"{cfg.n_kv_heads} heads, {m.n_experts} routed experts of "
                f"{m.d_expert} (top-{m.top_k}) + {m.n_shared} shared"
                + (f", layer 0 dense d_ff {cfg.d_ff}" if m.layer0_dense
                   else "")
                + (", ragged path" if cfg.moe_ragged else ", capacity path"))
    if cfg.ssm is None:
        return (f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads}/"
                f"{cfg.n_kv_heads} heads")
    s = cfg.ssm
    di = s.expand * cfg.d_model
    line = (f"{cfg.n_layers} Mamba2 layers, d={cfg.d_model}, d_inner {di}, "
            f"{di // s.head_dim} heads of P={s.head_dim}, N={s.d_state}, "
            f"{s.n_groups} group(s), chunk {s.chunk}")
    if cfg.hybrid is not None:
        line += (f", a shared attention block ({cfg.n_heads}/"
                 f"{cfg.n_kv_heads} heads, d_ff {cfg.hybrid.shared_d_ff}) "
                 f"every {cfg.hybrid.period}")
    return line


def run_forward(torch, dev, counts, arch, batch, seq, per_forward,
                **overrides):
    """Full-width ``Model.forward`` of ``arch`` (its config with
    ``overrides``) on (batch, seq) tokens: bf16 finite, f32 against
    prefill + decode, and exactly ``per_forward`` kernel launches per
    forward (every other kernel: none)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(arch), **overrides)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name}: {model.param_count(params) / 1e6:.1f} M "
          f"params ({cfg.param_dtype}), {describe(cfg)}, vocab {cfg.vocab}, "
          f"init {(time.perf_counter() - t0) * 1e3:.1f} ms")
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                         device=dev, dtype=torch.int32)
    want = {k: per_forward.get(k, 0) for k in counts()}

    def forward(m):
        before = counts()
        logits, _ = m.forward(params, toks)
        launched = {k: v - before[k] for k, v in counts().items()}
        check(launched == want, f"{cfg.name} forward launched {launched}, "
                                f"not {want}")
        return logits

    walls = []
    with torch.inference_mode():
        for _ in range(4):  # the first warms cuBLAS up
            t0 = time.perf_counter()
            logits = forward(model)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        check(logits.shape == (batch, seq, cfg.vocab)
              and logits.dtype == torch.bfloat16,
              f"bf16 forward: logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), "bf16 forward: non-finite")
        del logits
        fwd_ms = statistics.median(walls[1:])
        print(f"[lm] {cfg.name} forward bf16 ({batch}, {seq}): {fwd_ms:.1f} "
              f"ms median of 3 (first {walls[0]:.1f} ms), "
              f"{batch * seq / fwd_ms * 1e3:.0f} tok/s; finite logits; "
              f"launches per forward {per_forward}")

        m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
        half = seq // 2
        t0 = time.perf_counter()
        with routing_recorder(cfg) as routes_full:
            full = forward(m32)[:, half - 1:half + 1].clone()
        torch.cuda.synchronize()
        f32_ms = (time.perf_counter() - t0) * 1e3
        with routing_recorder(cfg) as routes_prefill:
            logits_p, cache = m32.prefill(params, toks[:, :half],
                                          max_len=half + 1)
        logits_d, _ = m32.decode_step(params, cache,
                                      toks[:, half:half + 1])
        err_p = float((logits_p[:, -1] - full[:, 0]).abs().max())
        err_d = float((logits_d[:, -1] - full[:, 1]).abs().max())
        del logits_p, cache
        check(err_p < 3e-3 and err_d < 3e-3,
              f"f32 forward vs prefill+decode: {err_p}, {err_d} >= 3e-3")
        print(f"[lm] {cfg.name} forward f32 ({batch}, {seq}) {f32_ms:.1f} "
              f"ms: logits at {half - 1}/{half} vs prefill({half}) + "
              f"decode_step: max|diff| {err_p:.2e} / {err_d:.2e} (gate 3e-3)")
        if routes_full:
            compare_routes(cfg, routes_full, routes_prefill, batch, half)
    return model, params, toks


@contextlib.contextmanager
def routing_recorder(cfg):
    """Records each ragged MoE layer's top-k expert choices, (tokens, k),
    while the block runs (an empty list for other models)."""
    from repro_torch.models import moe
    routes: list = []
    if cfg.moe is None or not cfg.moe_ragged:
        yield routes
        return
    ragged = moe.moe_apply_ragged

    def recording(p, cfg_, x):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
        routes.append(routed_experts(logits, cfg_.moe.top_k))
        return ragged(p, cfg_, x)

    moe.moe_apply_ragged = recording
    try:
        yield routes
    finally:
        moe.moe_apply_ragged = ragged


def routed_experts(logits, k):
    """The routed experts, in ascending order (softmax keeps the order of
    the logits, so the top-k of either is the same set)."""
    return logits.topk(k, dim=-1).indices.sort(dim=-1).values


def compare_routes(cfg, full, prefill, batch, half) -> None:
    """How many tokens of the first ``half`` positions the f32 forward and
    the f32 prefill route to different expert sets, by MoE layer (not
    gated: a near-tie of the k-th and (k+1)-th router logits flips with
    the order of a sum)."""
    k = cfg.moe.top_k
    per_layer = [int((f.reshape(batch, -1, k)[:, :half]
                      != p.reshape(batch, half, k)).any(-1).sum())
                 for f, p in zip(full, prefill)]
    last = [int((f.reshape(batch, -1, k)[:, half - 1]
                 != p.reshape(batch, half, k)[:, -1]).any(-1).sum())
            for f, p in zip(full, prefill)]
    print(f"[lm] {cfg.name} routing f32, forward vs prefill({half}): "
          f"{sum(per_layer)} of {batch * half * len(per_layer)} token "
          f"routings differ over {len(per_layer)} MoE layers (by layer "
          f"{per_layer}); at position {half - 1}: {sum(last)} "
          f"(by layer {last})")


def run_serve(torch, model, params, counts, per_decode=None,
              launcher_main=True) -> dict:
    """The launcher's defaults: 8 requests, 4 slots, max_len 128, max_new
    16, on the card, through the launcher's ``main`` (which builds its own
    weights) or, with ``launcher_main=False``, through a ``ServeEngine``
    over ``LocalDecodeBackend`` on the given model and weights.  Every
    ``decode_step`` call must launch exactly ``per_decode`` kernels (every
    other kernel: none).  Returns each request's tokens, its tokens decoded
    alone in a one-slot engine, and the decode step's p50 ms."""
    from repro_torch.core import trace
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import LocalDecodeBackend, ServeEngine
    reqs = launcher.requests(8, model.cfg.vocab, 16)
    before = counts()
    rec = trace.enable(host="serve")  # the engine's decode/prefill spans
    try:
        with torch.inference_mode():
            if launcher_main:
                done = launcher.main(["--arch", model.cfg.name])
            else:
                t0 = time.perf_counter()
                with ServeEngine(LocalDecodeBackend(
                        model, params, n_slots=4, max_len=128)) as eng:
                    for r in reqs:
                        eng.submit(r)
                    done = eng.run_until_drained()
                print(f"[serve] {model.cfg.name} (ServeEngine over "
                      f"LocalDecodeBackend, 4 slots, max_len 128): "
                      f"{time.perf_counter() - t0:.2f} s wall")
        spans = [e for e in rec.events() if e.kind == "span"]
    finally:
        trace.disable()
    launched = {k: v - before[k] for k, v in counts().items()}
    # prompts go in one token a step (a prefill chunk is
    # LAUNCH_PREFILL_CHUNK decode steps): decode recurrences and KV-cache
    # einsums, never a full-sequence kernel (as in the JAX package); a MoE
    # layer on the ragged path launches the grouped matmul 3 times a step
    n_steps = (sum(e.name == "decode_chunk" for e in spans)
               + LAUNCH_PREFILL_CHUNK * sum(e.name == "prefill"
                                            for e in spans))
    want_launched = {k: (per_decode or {}).get(k, 0) * n_steps
                     for k in launched}
    check(launched == want_launched,
          f"serve launched kernels {launched} over {n_steps} decode steps, "
          f"not {want_launched}")
    want = {r.rid: r.max_new for r in reqs}
    check(sorted(r.rid for r in done) == sorted(want),
          f"serve: completed {sorted(r.rid for r in done)}")
    for r in done:
        check(len(r.tokens) == want[r.rid] and r.finish_reason == "length",
              f"serve: request {r.rid} gave {len(r.tokens)} tokens "
              f"({r.finish_reason}), wanted {want[r.rid]}")
        check([e.kind for e in r.slot_events] == ["join", "leave"],
              f"serve: request {r.rid} slot events {r.slot_events}")
    toks = sum(len(r.tokens) for r in done)
    span = (max(r.finished_at for r in done)
            - min(r.submitted_at for r in done))
    ttft = sorted(r.ttft * 1e3 for r in done)
    tpot = sorted(r.tpot * 1e3 for r in done if len(r.tokens) > 1)
    decode = sorted(e.dur * 1e3 for e in spans if e.name == "decode_chunk")
    prefill = sorted(e.dur * 1e3 for e in spans if e.name == "prefill")
    print(f"[serve] engine spans: decode step p50 {pct(decode, 50):.2f} ms "
          f"p99 {pct(decode, 99):.2f} ms over {len(decode)} steps; prefill "
          f"chunk ({LAUNCH_PREFILL_CHUNK} single-token steps) p50 "
          f"{pct(prefill, 50):.2f} ms over {len(prefill)} chunks")
    tokens = {r.rid: r.tokens for r in done}
    alone = {}
    with torch.inference_mode():
        for r in reqs:  # each request alone in a one-slot engine
            eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=1,
                                                 max_len=128))
            eng.submit(r)
            eng.run_until_drained()
            alone[r.rid] = eng.poll(r.rid).tokens
    same = sum(alone[rid] == t for rid, t in tokens.items())
    print(f"[serve] {model.cfg.name}: {len(done)} requests complete, {toks} "
          f"tokens in "
          f"{span * 1e3:.1f} ms: {toks / span:.1f} tok/s; ttft p50 "
          f"{pct(ttft, 50):.1f} ms p99 {pct(ttft, 99):.1f} ms; tpot p50 "
          f"{pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} ms; launches "
          f"{launched}; {same}/{len(reqs)} requests give the same tokens "
          "decoded alone (n_slots=1; not gated)")
    return {"tokens": tokens, "alone": alone, "step_ms": pct(decode, 50)}


def memory(torch, label: str) -> None:
    free, total = torch.cuda.mem_get_info()
    print(f"[memory] {label}: peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, free "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB")


def run_capacity_forward(torch, model, params, toks, counts, per_forward):
    """One bf16 forward of the same weights on the capacity path (the
    config's default): its time, exactly ``per_forward`` kernel launches
    (no grouped matmul), and the share of token-choices it dropped at its
    capacity factor (counted in a second run, whose per-layer reads would
    disturb the timing)."""
    import dataclasses
    from repro_torch.models import Model, moe
    cap = Model(dataclasses.replace(model.cfg, moe_ragged=False))
    n_moe = model.cfg.n_layers - int(model.cfg.moe.layer0_dense)
    want = {k: per_forward.get(k, 0) for k in counts()}
    with torch.inference_mode():
        walls = []
        for _ in range(2):  # the first warms up
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, aux = cap.forward(params, toks)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launched = {k: v - before[k] for k, v in counts().items()}
            check(launched == want, f"capacity forward launched {launched}, "
                                    f"not {want}")
        check(bool(torch.isfinite(logits).all()), "capacity forward: "
                                                  "non-finite logits")
        del logits
        kept, choices = [], []
        dispatch_combine = moe._dispatch_combine

        def counting(probs, k, C):
            out = dispatch_combine(probs, k, C)
            kept.append(out[0].sum())
            choices.append(probs.shape[0] * probs.shape[1] * k)
            return out

        moe._dispatch_combine = counting
        try:
            cap.forward(params, toks)
        finally:
            moe._dispatch_combine = dispatch_combine
    check(len(kept) == n_moe, f"capacity forward: {len(kept)} MoE layers")
    dropped = 1.0 - float(torch.stack(kept).sum()) / sum(choices)
    C = moe.capacity(model.cfg.moe, toks.shape[1])
    print(f"[lm] {model.cfg.name} forward bf16 {tuple(toks.shape)}, capacity "
          f"path (C={C} a batch row and expert, capacity factor "
          f"{model.cfg.moe.capacity_factor}): {walls[1]:.1f} ms (first "
          f"{walls[0]:.1f} ms), aux {float(aux):.4f}; dropped "
          f"{dropped:.2%} of the token-choices over {n_moe} MoE layers "
          "(not gated: not dropless, so it differs from the ragged path)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, launch_counts, \
        reset_launch_counts

    t_start = time.perf_counter()
    card = gpu_name_and_power()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    logs = _build.build_all(["mandelbrot", "stencil", "flash_attention",
                             "ssd_scan", "moe_gmm"])
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, in parallel)")
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = re.sub(r"^_ZN12_GLOBAL__N_1\d+", "",
                               line.split("'")[1])[:44]
            elif "registers" in line or re.search(r"[1-9]\d* bytes spill",
                                                  line):
                print(f"  {name} {entry}: {line.strip()}")
    for name in ("flash_attention", "moe_gmm", "ssd_scan"):  # bf16 paths
        n = tensor_core_instructions(torch, name)
        print(f"sass: {name}: {n} tensor-core instructions (HMMA/HGMMA "
              "lines of cuobjdump -sass)")
        check(n > 0, f"{name}: no tensor-core instruction in its SASS")

    W, H, BANDS, ITERS = 4096, 2048, 64, 1000
    entries = [check_mandelbrot(torch, dev, W, H, BANDS, ITERS),
               check_stencil(torch, dev), check_flash(torch, dev),
               check_ssd(torch, dev), check_moe_gmm(torch, dev)]
    check_grad_refusal(torch, dev)
    check_widened(torch, dev)

    reset_launch_counts()  # the main path starts here
    farm, farm_img = run_farm(torch, launch_counts, W, H, BANDS, ITERS)
    pipeline, edge_maps = run_pipeline(torch, dev, launch_counts, 16, 2048)
    run_jacobi(torch, dev, launch_counts, 4, 4096, 4, 1e-6)
    run_pi(torch, launch_counts, 256, 10**6)
    rebalance_ms = run_cluster_phase(torch, launch_counts, farm_img,
                                     edge_maps, W, H, BANDS, ITERS, 16, 2048)
    model, params, toks = run_forward(torch, dev, launch_counts,
                                      "qwen2-0.5b", 4, 2048,
                                      {"flash_attention": 24})
    phase7 = run_serve(torch, model, params, launch_counts)
    run_durable_phase(torch, launch_counts, farm_img, model, params,
                      (W, H, BANDS, ITERS), rebalance_ms)
    run_sim_phase(torch, launch_counts, farm_img, (W, H, BANDS, ITERS))
    run_costs_phase(torch, launch_counts, farm_img, edge_maps, entries,
                    (W, H, BANDS, ITERS), 16, 2048)
    del farm_img, edge_maps
    # phase 16 is its own path: it must launch no kernel
    before_farm = launch_counts()
    reset_launch_counts()
    run_farm_phase(torch, model, params, phase7)
    farm_launched = launch_counts()
    check(not any(farm_launched.values()),
          f"phase 16 launched kernels: {farm_launched}")
    reset_launch_counts()
    ssm = run_forward(torch, dev, launch_counts, "mamba2-2.7b", 4, 2048,
                      {"ssd_scan": 64})
    hybrid = run_forward(torch, dev, launch_counts, "zamba2-1.2b", 4, 2048,
                         {"ssd_scan": 38, "flash_attention": 6})
    run_serve(torch, ssm[0], ssm[1], launch_counts)
    launched = {k: v + before_farm[k] for k, v in launch_counts().items()}
    # phase 17 is counted apart, from 0, and added to the main path's counts
    reset_launch_counts()
    whisper = run_whisper_phase(torch, dev, launch_counts)
    whisper_launched = launch_counts()
    print(f"[whisper] phase 17 launches: {whisper_launched}")
    launched = {k: v + whisper_launched[k] for k, v in launched.items()}

    # where the time goes: one more fused run of each kernel workload, one
    # more forward and one decode step of each served model, one more
    # zamba2 forward
    import numpy as np
    from repro_torch.core import build
    from repro_torch.serve import LocalDecodeBackend
    profile_run(torch, "mandelbrot fused", lambda: build(farm).run(
        instances=BANDS))
    profile_run(torch, "image fused", lambda: build(pipeline).run(
        instances=16))
    with torch.inference_mode():
        for m, p, t in ((model, params, toks), ssm):
            name = m.cfg.name
            profile_run(torch, f"{name} forward bf16 (4, 2048)",
                        lambda: m.forward(p, t))
            backend = LocalDecodeBackend(m, p, n_slots=4, max_len=128)
            last, adv = np.arange(1, 5, dtype=np.int32), np.ones(4, bool)
            backend.decode(last, adv)  # warm-up
            profile_run(torch, f"{name} decode step (4 slots)",
                        lambda: backend.decode(last, adv))
            del backend
        m, p, t = hybrid
        profile_run(torch, f"{m.cfg.name} forward bf16 (4, 2048)",
                    lambda: m.forward(p, t))
        m, p, c, t = whisper
        profile_run(torch, f"{m.cfg.name} decode step (4 utterances, "
                    f"{WHISPER_FRAMES} frames)",
                    lambda: m.decode_step(p, c, t))

    # the MoE path needs the card's memory: free every earlier model first
    del farm, pipeline, model, params, toks, ssm, hybrid, whisper, m, p, c, t
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    memory(torch, "before the MoE phases")
    reset_launch_counts()  # the MoE path starts here
    moe_model, moe_params, moe_toks = run_forward(
        torch, dev, launch_counts, "deepseek-moe-16b", 4, 2048,
        {"moe_gmm": 81, "flash_attention": 28}, moe_ragged=True)
    memory(torch, "phase 10, deepseek-moe-16b forwards (ragged)")
    run_capacity_forward(torch, moe_model, moe_params, moe_toks,
                         launch_counts, {"flash_attention": 28})
    memory(torch, "phase 10, deepseek-moe-16b forward (capacity)")
    run_serve(torch, moe_model, moe_params, launch_counts,
              per_decode={"moe_gmm": 81}, launcher_main=False)
    memory(torch, "phase 11, deepseek-moe-16b serving")
    moe_launched = launch_counts()
    with torch.inference_mode():
        profile_run(torch, "deepseek-moe-16b forward bf16 (4, 2048), ragged",
                    lambda: moe_model.forward(moe_params, moe_toks))
        backend = LocalDecodeBackend(moe_model, moe_params, n_slots=4,
                                     max_len=128)
        last, adv = np.arange(1, 5, dtype=np.int32), np.ones(4, bool)
        backend.decode(last, adv)  # warm-up
        profile_run(torch, "deepseek-moe-16b decode step (4 slots), ragged",
                    lambda: backend.decode(last, adv))
        del backend

    for e in entries:
        e["launches"] = launched[e["name"]] + moe_launched[e["name"]]
        check(e["launches"] > 0, f"{e['name']}: never launched on the path")
    print("kernels: " + "; ".join(
        f"{e['name']} launches={e['launches']} check="
        f"{'exact' if e['max_abs_err'] == 0 else e['max_abs_err']}"
        for e in entries))
    print(f"whole run: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
