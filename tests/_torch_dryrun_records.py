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
                "temp_bytes": 14707737620, "code_bytes": 0},
        "flops_per_dev": 1966893694976.0,
        "bytes_per_dev": 1471843182912.0,
        "coll_bytes_per_dev": 1294019096.0,
        "coll_kinds": {"all-gather": 470417408.0, "all-reduce": 403391756.0,
                       "reduce-scatter": 16818176.0},
        "coll_calls": {"all-gather": 26, "all-reduce": 33,
                       "reduce-scatter": 11}},
    ("zamba2-1.2b", "long_500k"): {
        "mem": {"argument_bytes": 33633344, "output_bytes": 33559408,
                "temp_bytes": 1844157, "code_bytes": 0},
        "flops_per_dev": 34348352.0,
        "bytes_per_dev": 702559698.0,
        "coll_bytes_per_dev": 1636344.0,
        "coll_kinds": {"all-gather": 1602624.0, "all-reduce": 16656.0,
                       "reduce-scatter": 408.0},
        "coll_calls": {"all-gather": 31, "all-reduce": 40,
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
