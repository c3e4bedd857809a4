"""Hand-written CUDA kernels of the port, each beside its plain version.

Each ``<name>/`` package holds ``ref`` (the plain PyTorch version, also what
the wrapper runs for a CPU tensor), ``kernel`` (the ctypes binding of
``csrc/<name>.cu``) and ``ops`` (the public wrapper, which counts its
launches).
"""

from . import (flash_attention, mandelbrot, moe_gmm, ssd_scan,  # noqa: F401
               stencil)

__all__ = ["flash_attention", "mandelbrot", "moe_gmm", "ssd_scan",
           "stencil", "launch_counts", "reset_launch_counts"]


def _wrappers() -> dict:
    return {"mandelbrot": mandelbrot.ops.mandelbrot,
            "stencil": stencil.ops.stencil2d,
            "flash_attention": flash_attention.ops.mha,
            "ssd_scan": ssd_scan.ops.ssd,
            "moe_gmm": moe_gmm.ops.moe_apply}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
