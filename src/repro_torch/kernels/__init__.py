"""Hand-written CUDA kernels of the port, each beside its plain version.

Each ``<name>/`` package holds ``ref`` (the plain PyTorch version, also what
the wrapper runs for a CPU tensor), ``kernel`` (the ctypes binding of
``csrc/<name>.cu``) and ``ops`` (the public wrapper, which counts its
launches).
"""

from . import mandelbrot, stencil  # noqa: F401

__all__ = ["mandelbrot", "stencil", "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {"mandelbrot": mandelbrot.ops.mandelbrot.launches,
            "stencil": stencil.ops.stencil2d.launches}


def reset_launch_counts() -> None:
    mandelbrot.ops.mandelbrot.launches = 0
    stencil.ops.stencil2d.launches = 0
