"""Engines (paper §5.4): shared-data iterative and stencil process engines.

``MultiCoreEngine`` (paper §6.2 Jacobi, §6.3 N-body): a root + N worker nodes
iterate over a shared matrix; workers each update their own partition while
reading everything, a barrier separates iterations, and the root runs a
sequential error/update phase.

On one GPU the partition loop runs unrolled in Python, one partition after
another, then the root's phase; this keeps the sequential oracle
bit-identical to the fused and streaming runs.  The iteration loops are
Python loops; the tolerance loop reads the error back once per sweep.
Given an ``axis`` and a mesh, each rank computes its own partition, the
partitions are gathered in rank order (the barrier *is* the collective)
and the root's phase runs on every rank, so every rank holds the same
state and the result equals the one-device run bit for bit.

``StencilEngine`` (paper §6.4): one image-processing stage; chains of engines
form the paper's Listing 17 network.  The convolution runs through
:func:`repro_torch.kernels.stencil.ops.stencil2d`: the hand-written CUDA
kernel for an image on the card, its plain version for one on the CPU.
With an ``axis`` and a mesh, each rank convolves its block of rows with a
halo of k//2 rows from each neighbour (zeros at the edges), sent point to
point, and the blocks are gathered back.

User methods stay sequential-style (paper P4): ``partition`` slices state with
:func:`narrow`, ``calculation`` maps a partition to its update,
``update``/``error`` are plain tensor code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..kernels.stencil.ops import stencil2d, taps_of
from ..parallel.collectives import block, merge_gather, ppermute
from .dataflow import Kind, NetworkError, ProcessDef

__all__ = ["narrow", "IterativeEngine", "Stencil", "MultiCoreEngine",
           "StencilEngine"]


def narrow(x: torch.Tensor, lo: int, size: int) -> torch.Tensor:
    """``size`` rows of ``x`` starting at row ``lo``."""
    return x.narrow(0, lo, size)


def _axis_ranks(mesh, axis: str, nodes: int) -> int:
    """The ranks along ``axis``, which must be the engine's ``nodes``."""
    n = mesh.shape[axis]
    if n != nodes:
        raise NetworkError(f"engine over axis {axis!r} of {n} ranks has "
                           f"nodes={nodes}")
    return n


@dataclasses.dataclass
class IterativeEngine:
    """BSP iteration over partitioned shared state.

    partition(state, lo, size) -> part        (read anything, slice own rows)
    calculation(part) -> update rows (size, ...)
    update(state, full_update) -> state       (root sequential phase)
    error(state, full_update) -> residual     (optional; enables tol loop)
    """

    partition: Callable
    calculation: Callable
    update: Callable
    n_rows: int
    nodes: int = 1
    error: Optional[Callable] = None
    iterations: Optional[int] = None
    tol: Optional[float] = None
    max_iterations: int = 10_000
    axis: Optional[str] = None  # mesh axis for the partitioned phase

    def __post_init__(self) -> None:
        if (self.iterations is None) == (self.tol is None):
            raise ValueError("specify exactly one of iterations= or tol=")
        if self.n_rows % self.nodes:
            raise ValueError(f"n_rows={self.n_rows} not divisible by "
                             f"nodes={self.nodes}")
        if self.tol is not None:
            # the residual is float32: compare against the float32 tolerance
            self._tol32 = float(torch.tensor(self.tol, dtype=torch.float32))

    # -- one BSP superstep: partitioned calc + root epilogue -------------
    def _full_update(self, state, mesh):
        k = self.nodes
        size = self.n_rows // k
        if mesh is not None and self.axis is not None:
            _axis_ranks(mesh, self.axis, k)
            idx = mesh.coord(self.axis)
            upd = self.calculation(self.partition(state, idx * size, size))
            return merge_gather(upd, mesh, self.axis)
        parts = [self.calculation(self.partition(state, i * size, size))
                 for i in range(k)]
        return torch.cat(parts, dim=0) if k > 1 else parts[0]

    def apply(self, state, mesh=None):
        if self.iterations is not None:
            for _ in range(self.iterations):
                state = self.update(state, self._full_update(state, mesh))
            return state

        # tolerance loop (paper's Jacobi): root checks the error each sweep
        err, it = float("inf"), 0
        while err > self._tol32 and it < self.max_iterations:
            upd = self._full_update(state, mesh)
            residual = self.error(state, upd)
            state = self.update(state, upd)
            err, it = float(residual), it + 1
        return state

    def as_worker_fn(self):
        return lambda item, *_: self.apply(item)


# --------------------------------------------------------------------------
# Stencil engine
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Stencil:
    """One image-processing stage: either an elementwise ``op`` (e.g.
    greyscale) or a ``kernel`` convolution (paper Listing 17 engines).

    The kernel's taps become a host tuple once, here, so no call copies them
    back from the device."""

    kernel: Any = None
    op: Optional[Callable] = None
    axis: Optional[str] = None
    nodes: int = 1

    def __post_init__(self) -> None:
        if (self.kernel is None) == (self.op is None):
            raise ValueError("specify exactly one of kernel= or op=")
        self.taps = None if self.kernel is None else taps_of(self.kernel)

    def apply(self, img, mesh=None):
        if self.op is not None:
            return self.op(img)
        if mesh is None or self.axis is None:
            return stencil2d(img, self.taps)
        n = _axis_ranks(mesh, self.axis, self.nodes)
        halo = len(self.taps) // 2
        tile = block(img, mesh, self.axis)
        if halo:  # exchange halo rows with the neighbours (zeros at edges)
            if tile.shape[0] < halo:
                raise NetworkError(f"stencil: blocks of {tile.shape[0]} rows "
                                   f"are thinner than the halo of {halo}")
            up = ppermute(tile[-halo:], mesh, self.axis,
                          [(i, i + 1) for i in range(n - 1)])
            down = ppermute(tile[:halo], mesh, self.axis,
                            [(i + 1, i) for i in range(n - 1)])
            tile = torch.cat([up, tile, down], dim=0)
        out = stencil2d(tile, self.taps)
        return merge_gather(out[halo:out.shape[0] - halo], mesh, self.axis)

    def as_worker_fn(self):
        return lambda item, *_: self.apply(item)


# --------------------------------------------------------------------------
# ProcessDef factories with the paper's names
# --------------------------------------------------------------------------

def MultiCoreEngine(
    *,
    nodes: int,
    n_rows: int,
    partitionMethod: Callable,
    calculationMethod: Callable,
    updateMethod: Callable,
    errorMethod: Optional[Callable] = None,
    iterations: Optional[int] = None,
    tol: Optional[float] = None,
    axis: Optional[str] = None,
    name: str = "mcEngine",
) -> ProcessDef:
    """Paper Listing 15/16 signature (camelCase kept deliberately)."""
    eng = IterativeEngine(
        partition=partitionMethod,
        calculation=calculationMethod,
        update=updateMethod,
        error=errorMethod,
        n_rows=n_rows,
        nodes=nodes,
        iterations=iterations,
        tol=tol,
        axis=axis,
    )
    return ProcessDef(name=name, kind=Kind.ENGINE, engine=eng)


def StencilEngine(
    *,
    nodes: int = 1,
    convolutionData: Any = None,
    functionMethod: Optional[Callable] = None,
    axis: Optional[str] = None,
    name: str = "stencilEngine",
) -> ProcessDef:
    """Paper Listing 17 signature: kernel convolution or pixel function."""
    eng = Stencil(kernel=convolutionData, op=functionMethod, axis=axis,
                  nodes=nodes)
    return ProcessDef(name=name, kind=Kind.ENGINE, engine=eng)
