"""Phase 20 of ``chip_smoke.py`` alone: the dry-run held against the card.

    python3 tools/dryrun_phase.py      # on the card

It starts 20a's process (the five cells traced with fake CUDA tensors),
builds the flash kernel, runs 18a (full-width qwen2-0.5b trained through
the launcher's ``main``, each step's peak recorded) and 19b alone in a
world of 2 ranks sharing the card (the bf16 TP step's collectives counted
at dispatch), then ``chip_smoke.run_dryrun_phase``: 20a's records, 20b's
traced peak and FLOPs against 18a's step, 20c's fake world of 2 against
19b's rank 0.  It prints chip_smoke's ``[train]``, ``[dryrun]`` lines.
"""
import os
import sys
import time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as cs


def tp_rank(rank: int) -> dict:
    """19b in one rank of a world of 2: its readings and, on rank 0, its
    step's collectives."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, counted = cs.mesh_counter("cuda")
    cs.tp_phase(rank, torch.device("cuda", 0), False, counted, out)
    return {"tp_step_costs": out["tp_step_costs"],
            "stats": out["stats"]["tp_step"], "walls": out["walls"]}


if __name__ == "__main__":
    import torch
    from repro_torch.kernels import _build, launch_counts
    from repro_torch.launch.mesh import run_world
    t = time.time()
    print(f"gpu: {cs.gpu_name_and_power()}; torch {torch.__version__}")
    cells = cs.start_dryrun_cells()
    try:
        _build.build_all(["flash_attention"])
        torch.backends.cuda.matmul.allow_tf32 = False
        peaks = cs.run_train_launcher(torch, launch_counts)
        import gc
        gc.collect()
        torch.cuda.empty_cache()  # 19b's two ranks need the card's memory
        res = run_world(tp_rank, cs.MESH_RANKS, device="cuda", timeout=300,
                        join_timeout=900)
        print(f"[mesh] 19b step walls: {[r['walls'] for r in res]}")
        cs.run_dryrun_phase(torch, launch_counts, cells, peaks,
                            dict(res[0]["tp_step_costs"],
                                 stats=res[0]["stats"]))
    finally:
        cs.stop(cells[0])
    print(f"dryrun phase alone: {time.time() - t:.1f} s")
