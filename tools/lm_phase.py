"""Phase 22, 23, 24, 25 or 26 of ``chip_smoke.py`` alone, or phase 1's
flash-attention, SSD-scan or grouped-matmul check.

    python3 tools/lm_phase.py          # on the card: phase 22
    python3 tools/lm_phase.py phase23  # on the card: phase 23 (23d too)
    python3 tools/lm_phase.py phase24  # on the card: phase 24
    python3 tools/lm_phase.py phase25  # on the card: phase 25
    python3 tools/lm_phase.py long     # on the card: phase 26
    python3 tools/lm_phase.py int8 cpu # no card: 23d's gate's readings
    python3 tools/lm_phase.py flash    # on the card: the flash check
    python3 tools/lm_phase.py ssd      # on the card: the SSD-scan check
    python3 tools/lm_phase.py gmm      # on the card: the grouped-matmul check

Phase 22 runs gemma-2b, glm4-9b and qwen2-vl-2b at full width, one after
another (``chip_smoke.run_wide_phase``), after building the flash kernel,
the only kernel the phase launches; it prints the phase's launches. Phase
23 runs yi-34b and phi3.5-moe (24 layers) with bf16 weights
(``chip_smoke.run_bf16_phase``), then serves yi-34b from an int8 KV cache
of 32,768 positions (23d), after building the flash and grouped-matmul
kernels. Phase 24 trains mamba2-2.7b, zamba2-1.2b and whisper-tiny at full
width (``chip_smoke.run_wide_train_phase``), after building the flash and
SSD-scan kernels. Phase 25 trains gemma-2b with the chunked loss at (4,
4096) and qwen2-vl-2b at (4, 1024) and holds both, and yi-34b's int8
cache, against the CPU (``chip_smoke.run_lever_phase``), after building
the flash kernel. Phase 26 runs the JAX package's long-context cells
(``chip_smoke.run_long_phase``: mamba2-2.7b, zamba2-1.2b and qwen2-0.5b
on a row of 32,768 tokens, then zamba2-1.2b and mamba2-2.7b decoding
from 524,288 positions; the kernels at that length are in the ``flash``
and ``ssd`` checks) after
building the flash and SSD-scan kernels, then traces 26d's decode step
with the dry-run and prints it beside the card's. ``int8 cpu`` prints,
on the CPU, ``chip_smoke.compare_int8_cache``'s readings from which 23d's gate on the
int8 cache against the bf16 cache was set
(``chip_smoke.int8_cpu_readings``), and how far the int8 cache carries a
difference of f32 rounding, as 25c's gates on the card against the CPU
read it (``chip_smoke.int8_flip_readings``); about a minute. ``ssd``
builds the SSD-scan kernel and runs ``chip_smoke.check_ssd``: every shape
against the plain version, the mamba2 forward's and training step's shapes
timed (the latter also as the plain backward). ``flash`` builds the flash
kernel (ptxas's registers and spills of each instance, the HMMA lines of
its SASS) and runs ``chip_smoke.check_flash``: every shape against the
plain version, and the forwards' shapes timed beside
``scaled_dot_product_attention`` (gemma-2b's also in f16, on the FMA
path). ``gmm`` builds the grouped-matmul kernel and runs
``chip_smoke.check_moe_gmm``: every case against the plain version,
deepseek-moe-16b's and phi3.5-moe's products timed beside
``torch._grouped_mm``. Each but ``int8 cpu`` exits non-zero on a failed
check or without a card.
"""
import os
import sys
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as cs


def main(argv) -> int:
    import torch
    if argv == ["int8", "cpu"]:
        cs.int8_cpu_readings()
        cs.int8_flip_readings()
        return 0
    if not torch.cuda.is_available():
        print("lm_phase: no CUDA device is available", file=sys.stderr)
        return 1
    if argv not in ([], ["phase23"], ["phase24"], ["phase25"], ["long"],
                    ["flash"], ["ssd"], ["gmm"]):
        print(f"lm_phase: unknown arguments {argv}", file=sys.stderr)
        return 2
    from repro_torch.kernels import launch_counts, reset_launch_counts
    print(f"gpu: {cs.gpu_name_and_power()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if argv == ["gmm"]:
        cs.build_kernels(torch, ["moe_gmm"])
        cs.check_moe_gmm(torch, dev)
        return 0
    if argv == ["ssd"]:
        cs.build_kernels(torch, ["ssd_scan"])
        cs.check_ssd(torch, dev)
        return 0
    cs.build_kernels(torch, {"phase23": ["flash_attention", "moe_gmm"],
                             "phase24": ["flash_attention", "ssd_scan"],
                             "long": ["flash_attention", "ssd_scan"]}.get(
                                 argv[0] if argv else "", ["flash_attention"]))
    if argv == ["flash"]:
        cs.check_flash(torch, dev)
        return 0
    reset_launch_counts()
    if argv == ["phase23"]:
        cs.run_bf16_phase(torch, dev, launch_counts)
        print(f"[lm] phase 23 launches: {launch_counts()}")
    elif argv == ["phase24"]:
        cs.run_wide_train_phase(torch, dev, launch_counts)
        print(f"[train] phase 24 launches: {launch_counts()}")
    elif argv == ["phase25"]:
        cs.run_lever_phase(torch, dev, launch_counts)
        print(f"[train] phase 25 launches: {launch_counts()}")
    elif argv == ["long"]:
        long_step = cs.run_long_phase(torch, dev, launch_counts)
        print(f"[long] phase 26 launches: {launch_counts()}")
        cs.report_long_trace(cs.trace_long_step(), long_step)
    else:
        cs.run_wide_phase(torch, dev, launch_counts)
        print(f"[lm] phase 22 launches: {launch_counts()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
