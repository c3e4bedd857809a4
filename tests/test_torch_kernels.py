"""The port's kernels against the JAX package's, on the CPU.

The same numpy-seeded inputs go through the JAX op (its Pallas kernel in
interpret mode, and its jnp oracle) and through the port's wrapper, which on
a CPU tensor runs the plain PyTorch version of the CUDA kernel.  Tolerances
are those of ``tests/test_kernels.py``.  The CUDA kernels themselves are
held against their plain versions on the card by ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mandelbrot import ops as jmb_ops, ref as jmb_ref
from repro.kernels.stencil import ops as jst_ops, ref as jst_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.mandelbrot import ops as mb_ops, ref as mb_ref
from repro_torch.kernels.stencil import ops as st_ops, ref as st_ref


# --------------------------------------------------------------------------
# mandelbrot
# --------------------------------------------------------------------------

class TestMandelbrot:
    @pytest.mark.parametrize("hw", [(64, 100), (40, 64), (8, 16)])
    def test_vs_jax(self, hw):
        H, W = hw
        # y0 off the real axis, as in tests/test_kernels.py: pixels with
        # ci == 0 exactly sit on the boundary where an FMA flips counts
        kw = dict(x0=-2.0, y0=-1.0123, pixel_delta=2.0 / W,
                  max_iterations=64)
        ours = mb_ops.mandelbrot(H, W, device="cpu", **kw).numpy()
        for theirs in (jmb_ops.mandelbrot(H, W, interpret=True, **kw),
                       jmb_ref.mandelbrot(H, W, **kw)):
            same = ours == np.asarray(theirs)
            assert same.mean() > 0.999, f"{(~same).sum()} pixels differ"

    def test_band_offset_vs_jax(self):
        """A farm band: the top edge -1.15 + delta * row0 is formed from a
        device int32, as the launcher forms it in float32."""
        W, band_h, delta = 96, 8, 3.0 / 96
        for row0 in (0, 8, 40):
            ours = mb_ops.mandelbrot(
                band_h, W, x0=-2.2, y0=-1.15, pixel_delta=delta,
                max_iterations=60,
                row0=torch.tensor(row0, dtype=torch.int32)).numpy()
            theirs = jmb_ref.mandelbrot(
                band_h, W, x0=-2.2, y0=-1.15 + delta * jnp.int32(row0),
                pixel_delta=delta, max_iterations=60)
            assert (ours == np.asarray(theirs)).mean() > 0.999

    def test_interior_hits_escape_value(self):
        out = mb_ops.mandelbrot(64, 64, x0=-1.0, y0=-0.5,
                                pixel_delta=1.0 / 64, max_iterations=50,
                                device="cpu")
        assert out.dtype == torch.int32
        assert int((out == 50).sum()) > 0

    def test_cpu_runs_plain_version_without_launch(self):
        before = launch_counts()["mandelbrot"]
        a = mb_ops.mandelbrot(8, 16, device="cpu")
        assert torch.equal(a, mb_ref.mandelbrot(8, 16))
        assert launch_counts()["mandelbrot"] == before

    def test_no_device_means_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mb_ops.mandelbrot(8, 16)

    def test_bad_row0_refused(self):
        with pytest.raises(ValueError, match="int32"):
            mb_ops.mandelbrot(8, 16, row0=torch.tensor(1.0))
        with pytest.raises(ValueError, match="lies on"):
            mb_ops.mandelbrot(8, 16, row0=torch.tensor(1, dtype=torch.int32),
                              device="meta")


# --------------------------------------------------------------------------
# stencil
# --------------------------------------------------------------------------

def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(a.astype(np.float32))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


class TestStencil:
    @pytest.mark.parametrize("hw", [(64, 64), (100, 96), (33, 128), (8, 8)])
    @pytest.mark.parametrize("k", [3, 5, 7])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_vs_jax(self, hw, k, dtype):
        rng = np.random.default_rng([*hw, k, dtype == "bf16"])
        img = rng.normal(size=hw).astype(np.float32)
        kern = rng.normal(size=(k, k)).astype(np.float32)
        jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        theirs = jst_ops.stencil2d(jnp.asarray(img, jdt), jnp.asarray(kern),
                                   tile_h=32, interpret=True)
        ours = st_ops.stencil2d(_to_torch(img, dtype), kern)
        assert ours.dtype == (torch.bfloat16 if dtype == "bf16"
                              else torch.float32)
        tol = 2e-2 if dtype == "bf16" else 1e-4
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(theirs, np.float32),
                                   rtol=tol, atol=tol)

    @pytest.mark.parametrize("hw", [(64, 64), (33, 40), (5, 7)])
    @pytest.mark.parametrize("k", [1, 7, 9])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_any_odd_k_vs_jax_op(self, hw, k, dtype):
        """Every odd k against the JAX package's op on its plain path
        (``use_pallas=False``): the card takes any odd k since the runtime-k
        kernel, and the CPU path always did.  (The JAX Pallas kernel is
        compared above at k = 3, 5, 7; at k = 1 its zero halo slices the
        whole neighbour tile and it returns zeros, a reference behaviour.)"""
        rng = np.random.default_rng([*hw, k])
        img = rng.normal(size=hw).astype(np.float32)
        kern = rng.normal(size=(k, k)).astype(np.float32)
        jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        theirs = jst_ops.stencil2d(jnp.asarray(img, jdt), jnp.asarray(kern),
                                   use_pallas=False)
        ours = st_ops.stencil2d(_to_torch(img, dtype), kern)
        tol = 2e-2 if dtype == "bf16" else 1e-4
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(theirs, np.float32),
                                   rtol=tol, atol=tol)

    def test_identity_kernel(self):
        img = np.random.default_rng(3).normal(size=(32, 32)).astype(np.float32)
        k = np.zeros((3, 3), np.float32)
        k[1, 1] = 1.0
        ours = st_ops.stencil2d(torch.from_numpy(img), k)
        np.testing.assert_allclose(ours.numpy(), img, rtol=1e-6)
        theirs = jst_ref.stencil2d(jnp.asarray(img), jnp.asarray(k))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6)

    def test_taps_are_a_host_tuple(self):
        taps = st_ops.taps_of(torch.arange(9.0).reshape(3, 3))
        assert taps == ((0.0, 1.0, 2.0), (3.0, 4.0, 5.0), (6.0, 7.0, 8.0))
        with pytest.raises(ValueError, match="square odd"):
            st_ops.taps_of(np.ones((2, 2)))

    def test_refuses_what_the_kernel_does_not_take(self):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            st_ops.stencil2d(torch.zeros(8, 8, dtype=torch.int32),
                             np.ones((3, 3)))
        with pytest.raises(ValueError, match=r"\(H, W\)"):
            st_ops.stencil2d(torch.zeros(2, 8, 8), np.ones((3, 3)))
        with pytest.raises(ValueError, match="non-empty"):
            st_ops.stencil2d(torch.zeros(0, 8), np.ones((3, 3)))

    def test_cpu_runs_plain_version_without_launch(self):
        before = launch_counts()["stencil"]
        img = torch.randn(16, 16, generator=torch.Generator().manual_seed(0))
        taps = st_ops.taps_of(np.ones((5, 5)))
        assert torch.equal(st_ops.stencil2d(img, taps),
                           st_ref.stencil2d(img, taps))
        assert launch_counts()["stencil"] == before
