"""Records of two reduced dry-run cells on the 16x16 mesh, as
``repro_torch.launch.dryrun.lower_cell(..., device="cuda")`` gives them on
a host without a card (fake CPU tensors standing for the card's, PyTorch
2.13).  The CPU tests hold this host to them; the card's tests hold the
card's host (fake CUDA tensors, PyTorch 2.11) to the same argument and
output bytes (the FLOPs, temp bytes and collectives follow each
version's ``DTensor`` rules).  This module imports no JAX."""

RECORD_KEYS = ("mem", "flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
               "coll_kinds", "coll_calls")

REDUCED_CELLS = {
    ("qwen2-0.5b", "train_4k"): {
        "mem": {"argument_bytes": 858372, "output_bytes": 334108,
                "temp_bytes": 14204486676, "code_bytes": 0},
        "flops_per_dev": 1966893694976.0,
        "bytes_per_dev": 1462569963316.0,
        "coll_bytes_per_dev": 1362299416.0,
        "coll_kinds": {"all-gather": 403177472.0, "all-reduce": 471155980.0,
                       "reduce-scatter": 16809984.0},
        "coll_calls": {"all-gather": 24, "all-reduce": 36,
                       "reduce-scatter": 10}},
    ("zamba2-1.2b", "long_500k"): {
        "mem": {"argument_bytes": 33633344, "output_bytes": 33559408,
                "temp_bytes": 1844157, "code_bytes": 0},
        "flops_per_dev": 34348352.0,
        "bytes_per_dev": 912166167.0,
        "coll_bytes_per_dev": 1571832.0,
        "coll_kinds": {"all-gather": 1537088.0, "all-reduce": 17168.0,
                       "reduce-scatter": 408.0},
        "coll_calls": {"all-gather": 30, "all-reduce": 41,
                       "reduce-scatter": 8}},
}


def reduced_record(arch: str, shape: str) -> dict:
    """The cell's record on this host, with :data:`RECORD_KEYS` only."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    rec = dryrun.lower_cell(arch, shape, multi_pod=False, verbose=False,
                            cfg_override=get_config(arch, reduced=True))
    assert rec["ok"] and rec["device"] == "cuda"
    return {k: rec[k] for k in RECORD_KEYS}
