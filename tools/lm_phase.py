"""Phase 22 of ``chip_smoke.py`` alone, or phase 1's flash-attention check.

    python3 tools/lm_phase.py          # on the card: phase 22
    python3 tools/lm_phase.py flash    # on the card: the flash check

Phase 22 runs gemma-2b, glm4-9b and qwen2-vl-2b at full width, one after
another (``chip_smoke.run_wide_phase``), after building the flash kernel,
the only kernel the phase launches; it prints the phase's launches.
``flash`` builds the flash kernel (ptxas's registers and spills of each
instance, the HMMA lines of its SASS) and runs ``chip_smoke.check_flash``:
every shape against the plain version, and the forwards' shapes timed
beside ``scaled_dot_product_attention`` (gemma-2b's also in f16, on the
FMA path).  Each exits non-zero on a failed check or without a card.
"""
import os
import sys
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as cs


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_phase: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import launch_counts, reset_launch_counts
    print(f"gpu: {cs.gpu_name_and_power()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.build_kernels(torch, ["flash_attention"])
    if argv == ["flash"]:
        cs.check_flash(torch, dev)
        return 0
    reset_launch_counts()
    cs.run_wide_phase(torch, dev, launch_counts)
    print(f"[lm] phase 22 launches: {launch_counts()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
