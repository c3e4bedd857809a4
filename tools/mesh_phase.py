"""Phase 19 of ``chip_smoke.py`` alone: the mesh, 2 ranks sharing the card.

    python3 tools/mesh_phase.py        # on the card, at phase 19's sizes
    python3 tools/mesh_phase.py cpu    # a dry run on the CPU, small sizes
    python3 tools/mesh_phase.py tp     # 19b's readings, sound and wrong
    python3 tools/mesh_phase.py tp cpu # the same on the CPU, reduced qwen2
    python3 tools/mesh_phase.py ragged      # phase 21's readings, sound and
    python3 tools/mesh_phase.py ragged cpu  # wrong (CPU: reduced deepseek)

It computes phase 2's farm image and phase 3's edge maps on one device
(fused), then runs ``chip_smoke.run_mesh_phase`` (on the CPU: the rank body
``chip_smoke.mesh_rank`` with a reduced qwen2, printing each rank's
results).  It builds the three kernels the phase launches first.

``tp`` runs 19b (``chip_smoke.tp_phase``) alone, ungated, in a world of 2
ranks, once as it is and twice deliberately wrong: the mesh's attention
takes a softmax scale 1% and 10% too large.  It prints each run's
readings (the loss and gradients against one device in f32, the bf16
step's loss, gradients and AdamW update), from which 19b's gates are
set.

``ragged`` runs phase 21 (``chip_smoke.ragged_rank``: deepseek-moe-16b's
ragged MoE path on a (1, 2) mesh, the experts split over the ranks) alone,
ungated, once as it is and once deliberately wrong: the rank that holds
the upper half of the experts takes its first expert one too low, so
each of its local experts computes with its neighbour's weights, one
expert is computed by both ranks and the last by none.  Phase 21's gates are set from these
readings.
"""
import os
import sys
import time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as cs

WRONG_SCALES = (0.01, 0.1)  # the wrong runs' errors in the softmax scale


def tp_rank(rank: int, wrong: float, device: str) -> dict:
    """19b in one rank, its readings and walls; ``wrong`` scales the
    mesh's attention logits by 1 + ``wrong`` (0: as it is)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    if wrong:
        real = ops._mha_sharded

        def off(q, k, v, *, causal, scale):
            return real(q, k, v, causal=causal, scale=scale * (1 + wrong))

        ops._mha_sharded = off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    out, counted = cs.mesh_counter(device)
    cs.tp_phase(rank, dev, device == "cpu", counted, out)
    return {k: v for k, v in out.items()
            if k.startswith("tp_") or k in ("walls", "parts")}


def ragged_rank(rank: int, wrong: int, device: str) -> dict:
    """Phase 21 in one rank; ``wrong`` > 0 moves the first expert of every
    rank but the first that many experts down (0: as it is)."""
    if wrong:
        from repro_torch.models import moe
        real = moe._ragged

        def off(*t, m, lo=0):
            return real(*t, m=m, lo=lo - wrong if lo else lo)

        moe._ragged = off
    return cs.ragged_rank(rank, device, device == "cpu")


if __name__ == "__main__":
    import torch
    from repro_torch import workloads
    from repro_torch.core import build
    from repro_torch.interop import tree_from_numpy
    from repro_torch.launch.mesh import run_world
    cpu = sys.argv[2:] == ["cpu"] or sys.argv[1:] == ["cpu"]
    t = time.time()
    if not cpu:
        from repro_torch.kernels import _build
        _build.build_all({"tp": ["flash_attention"],
                          "ragged": ["flash_attention", "moe_gmm"]}.get(
            sys.argv[1] if sys.argv[1:] else "",
            ["mandelbrot", "stencil", "flash_attention"]))
        print("build", time.time() - t, flush=True)
        print("gpu:", cs.gpu_name_and_power())
    if sys.argv[1:2] == ["ragged"]:
        device = "cpu" if cpu else "cuda"
        for wrong in (0, 1):
            res = run_world(ragged_rank, 2, wrong, device, device=device,
                            timeout=300, join_timeout=900)
            print(f"expert offset off by {wrong}:", flush=True)
            cs.report_ragged(res)
        print("total", time.time() - t)
        sys.exit(0)
    if sys.argv[1:2] == ["tp"]:
        device = "cpu" if cpu else "cuda"
        for wrong in (0.0, *WRONG_SCALES):
            res = run_world(tp_rank, 2, wrong, device, device=device,
                            timeout=300, join_timeout=900)
            for r, o in enumerate(res):
                print(f"scale off by {wrong}: rank {r}: {o}", flush=True)
        print("total", time.time() - t)
        sys.exit(0)
    if cpu:
        args = (64, 32, 4, 20, 2, 32)
        dev = torch.device("cpu")
    else:
        args = (4096, 2048, 64, 1000, 16, 2048)
        dev = torch.device("cuda", 0)
    W, H, B, I, n, size = args
    img = workloads.assemble(build(workloads.mandelbrot_farm(
        width=W, height=H, bands=B, iterations=I),
        device=dev).run(instances=B)["collect"])
    edges = build(workloads.image_pipeline(tree_from_numpy(
        workloads.synthetic_images(n, size), dev)),
        device=dev).run(instances=n)["collector"]
    refs = cs.digest([img]), cs.digest(edges)
    print("references", time.time() - t, flush=True)
    if cpu:
        res = run_world(cs.mesh_rank, 2, *refs, args, "cpu", True,
                        device="cpu")
        for r in res:
            print({k: v for k, v in r.items() if k not in ("stats",)})
            print(r["stats"])
    else:
        print(cs.run_mesh_phase(torch, *refs, args))
    print("total", time.time() - t)
