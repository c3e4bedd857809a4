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
   2 spawned host processes (``pipe``), 3 batches each, then the image
   pipeline at phase 3's size cut between its two engines over ``device``
   and ``pipe``: the partition must refine the network (CSP, both
   directions), every batch must equal phases 2 and 3 exactly, thread
   hosts must launch the kernel here once a band (64 ``mandelbrot``, 16
   ``stencil`` a batch), and each spawned host checks inside its own
   process that every band launched its own Mandelbrot kernel once and is
   a CUDA tensor.  It prints the start, cold and warm walls, the bytes
   crossing the cut a batch and the cluster report; every deployment is
   closed and every host process gone before phase 6;
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
path) and bf16 (the tensor cores), timed at both forward shapes beside
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
for an input that requires grad, before any launch.

Kernel launch counts are reset just before phase 2 and read after phase 9
(phase 12's thread hosts count with them),
and reset again just before phase 10 and read after phase 11: each kernel
must have been launched by one of the two paths.  One more fused run of
the farm, of the pipeline, one more bf16 forward and one decode step of
qwen2-0.5b and of mamba2-2.7b, and one more zamba2-1.2b forward are traced
with ``torch.profiler`` after phase 9, and one bf16 forward and one decode
step of deepseek-moe-16b after phase 11, to print the device's busy time,
idle share and each of the port's kernels' share of the busy time.  The last two lines are a JSON
summary of the kernels and ``{"ok": true, "device": ...}``.  Any failure
raises and the script exits non-zero; so does a machine without a CUDA
device, where nothing is printed on standard output.
"""

from __future__ import annotations

import contextlib
import json
import math
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
    the two forwards' shapes (bf16: the tensor-core path)."""
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
    open_shapes = [(4, 6, 6, 1500, 1500, 64), (4, 6, 6, 1, 1500, 64),
                   (2, 8, 2, 77, 300, 128)]
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
            if shape not in (path, deepseek) or dtype != torch.bfloat16:
                continue
            t = timed_turns(
                torch, {"plain": lambda: ref.mha(q, k, v, causal=True),
                        "kernel": lambda: ops.mha(q, k, v, causal=True),
                        "library": lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, enable_gqa=True)},
                {"plain": 3, "kernel": 10, "library": 10},
                flush=flush_buf.zero_)
            pairs = B * H * sum(min(Sk, i + Sk - Sq + 1) for i in range(Sq))
            flops = 4.0 * D * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
            label = "qwen2-0.5b" if shape == path else "deepseek-moe-16b"
            print(f"[kernel] flash_attention {label} shape bf16: kernel "
                  f"{t['kernel']:.4f} ms ({flops / t['kernel'] / 1e9:.1f} "
                  f"TFLOP/s), plain {t['plain']:.4f} ms, library(sdpa) "
                  f"{t['library']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; {flops:.3e} causal FLOP at the bf16 peak), "
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
                   counts, kernel, per_batch, same_as):
    """One warm ``ClusterDeployment``: refinement, ``batches`` batches each
    checked by ``same_as`` and by the parent's ``kernel`` launches
    (``per_batch``), the walls, the pipe's bytes a batch and the cluster
    report.  Returns the walls in ms (start, then one a batch)."""
    from repro_torch.cluster import ClusterDeployment, check_refinement
    from repro_torch.core import netlog
    refined = check_refinement(net, plan)
    check(refined, f"[cluster] {label}: partitioned network does not refine")
    print(f"[cluster] {label}: partitioned [T= unpartitioned (CSP, both "
          f"directions): {refined}; cut "
          f"{[f'{c.src}->{c.dst}' for c in plan.cut]}")
    t0 = time.perf_counter()
    dep = ClusterDeployment(net, plan=plan, transport=transport,
                            microbatch_size=16, factory=factory,
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
            print(f"[cluster] {label}: batch {b} "
                  f"({'cold' if b == 0 else 'warm'}) {walls[-1]:.1f} ms, "
                  f"exact: True, {kernel} launches here {launched}, cut "
                  f"bytes {sent}, stage builds "
                  f"{sum(r.jit_builds for r in out.reports)}")
        procs = list(dep.controller._procs.values())
    check(not any(p.is_alive() for p in procs),
          f"[cluster] {label}: a host process outlived the deployment")
    print(netlog.cluster_report(dep.plan, out.reports, events=dep.events))
    print(f"[cluster] {label}: start {walls[0]:.1f} ms, cold batch "
          f"{walls[1]:.1f} ms, warm batches "
          f"{', '.join(f'{w:.1f}' for w in walls[2:])} ms")
    return walls


def run_cluster_phase(torch, counts, farm_img, pipe_outs, W, H, bands, iters,
                      n_img, size):
    """Phase 12: the farm at phase 2's width over 2 and 4 thread hosts on
    the card (``device``) and 2 spawned host processes (``pipe``), then the
    image pipeline at phase 3's size cut between its engines over both."""
    import multiprocessing

    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import partition
    args = (W, H, bands, iters)
    same_img = lambda out: np.array_equal(  # noqa: E731
        workloads.assemble(out["collect"]), farm_img)
    for transport, hosts, factory in (
            ("device", 2, workloads.mandelbrot_factory),
            ("device", 4, workloads.mandelbrot_factory),
            ("pipe", 2, checked_farm)):
        net = factory(*args)
        run_deployment(torch, f"mandelbrot {transport} x{hosts}", net,
                       partition(net, hosts=hosts), transport,
                       (factory, args), bands, 3, counts, "mandelbrot",
                       bands if transport == "device" else 0, same_img)

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
    check(not multiprocessing.active_children(),
          "[cluster] host processes still running after phase 12")


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
              launcher_main=True):
    """The launcher's defaults: 8 requests, 4 slots, max_len 128, max_new
    16, on the card, through the launcher's ``main`` (which builds its own
    weights) or, with ``launcher_main=False``, through a ``ServeEngine``
    over ``LocalDecodeBackend`` on the given model and weights.  Every
    ``decode_step`` call must launch exactly ``per_decode`` kernels (every
    other kernel: none)."""
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

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(len(xs) * q / 100.0))]

    decode = sorted(e.dur * 1e3 for e in spans if e.name == "decode_chunk")
    prefill = sorted(e.dur * 1e3 for e in spans if e.name == "prefill")
    print(f"[serve] engine spans: decode step p50 {pct(decode, 50):.2f} ms "
          f"p99 {pct(decode, 99):.2f} ms over {len(decode)} steps; prefill "
          f"chunk ({LAUNCH_PREFILL_CHUNK} single-token steps) p50 "
          f"{pct(prefill, 50):.2f} ms over {len(prefill)} chunks")
    same = 0
    with torch.inference_mode():
        for r in reqs:  # each request alone in a one-slot engine
            eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=1,
                                                 max_len=128))
            eng.submit(r)
            eng.run_until_drained()
            same += eng.poll(r.rid).tokens == next(
                d.tokens for d in done if d.rid == r.rid)
    print(f"[serve] {model.cfg.name}: {len(done)} requests complete, {toks} "
          f"tokens in "
          f"{span * 1e3:.1f} ms: {toks / span:.1f} tok/s; ttft p50 "
          f"{pct(ttft, 50):.1f} ms p99 {pct(ttft, 99):.1f} ms; tpot p50 "
          f"{pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} ms; launches "
          f"{launched}; {same}/{len(reqs)} requests give the same tokens "
          "decoded alone (n_slots=1; not gated)")


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

    reset_launch_counts()  # the main path starts here
    farm, farm_img = run_farm(torch, launch_counts, W, H, BANDS, ITERS)
    pipeline, edge_maps = run_pipeline(torch, dev, launch_counts, 16, 2048)
    run_jacobi(torch, dev, launch_counts, 4, 4096, 4, 1e-6)
    run_pi(torch, launch_counts, 256, 10**6)
    run_cluster_phase(torch, launch_counts, farm_img, edge_maps, W, H, BANDS,
                      ITERS, 16, 2048)
    del farm_img, edge_maps
    model, params, toks = run_forward(torch, dev, launch_counts,
                                      "qwen2-0.5b", 4, 2048,
                                      {"flash_attention": 24})
    run_serve(torch, model, params, launch_counts)
    ssm = run_forward(torch, dev, launch_counts, "mamba2-2.7b", 4, 2048,
                      {"ssd_scan": 64})
    hybrid = run_forward(torch, dev, launch_counts, "zamba2-1.2b", 4, 2048,
                         {"ssd_scan": 38, "flash_attention": 6})
    run_serve(torch, ssm[0], ssm[1], launch_counts)
    launched = launch_counts()

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

    # the MoE path needs the card's memory: free every earlier model first
    del farm, pipeline, model, params, toks, ssm, hybrid, m, p, t
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
