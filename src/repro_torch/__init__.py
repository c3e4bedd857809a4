"""Groovy Parallel Patterns on PyTorch and CUDA — the port of ``repro``.

The same process-network library as the JAX package (declare, verify,
check with the CSP model checker, run as the sequential oracle, as one
fused program, or as a streaming microbatch pipeline), written in PyTorch
for an NVIDIA H100, with the kernels of its path hand-written in CUDA C++.
Its entry points run on the card unless the caller passes ``device="cpu"``.
"""

from . import core, device, interop, kernels, workloads  # noqa: F401
