"""Collection guard for environments without PyTorch.

The PyTorch port's tests (``tests/test_torch_*.py``) import ``torch`` at
module level.  Where it cannot be imported — the JAX-only CI lanes — they
are left out of collection, so the reference package's tests still run;
with torch installed nothing changes.  The port's own lane is
``.github/workflows/torch-port.yml``.
"""

try:
    import torch  # noqa: F401
except ImportError:
    collect_ignore_glob = ["tests/test_torch_*.py"]
