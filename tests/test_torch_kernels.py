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
from repro_torch.workloads import EDGE5


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

    @pytest.mark.parametrize("iters", [0, -3])
    def test_no_step_vs_jax(self, iters):
        """max_iterations <= 0 runs no step: all zeros, as JAX's
        ``fori_loop(0, iters)`` gives (its Pallas kernel and its oracle)."""
        kw = dict(x0=-2.2, y0=-1.15, pixel_delta=0.05, max_iterations=iters)
        ours = mb_ops.mandelbrot(16, 40, device="cpu", **kw).numpy()
        for theirs in (jmb_ops.mandelbrot(16, 40, interpret=True, **kw),
                       jmb_ref.mandelbrot(16, 40, **kw)):
            np.testing.assert_array_equal(ours, np.asarray(theirs))
        assert ours.dtype == np.int32 and not ours.any()
        band = mb_ops.mandelbrot(8, 40, row0=torch.tensor(8,
                                                          dtype=torch.int32),
                                 **kw)
        assert not band.any()

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

    @pytest.mark.parametrize("hw", [(64, 64), (33, 130), (3, 5), (1, 1)])
    @pytest.mark.parametrize("k", [1, 3, 5, 7])
    def test_f16_vs_jax(self, hw, k):
        """float16 images.  The port and JAX's op on its ref path sum in
        float32 in the same (dr, dc) order and round once to float16: equal.
        JAX's Pallas kernel (interpret mode, k = 3, 5, 7; at k = 1 it
        returns zeros, and it refuses a row tile shorter than the halo, both
        reference behaviours) rounds its float32 sums
        differently (on float32 images it differs from its own ref by a few
        float32 ulps), so a float16 result may land one float16 ulp away:
        rtol 2^-10, atol 2^-14."""
        rng = np.random.default_rng([*hw, k, 16])
        img = rng.normal(size=hw).astype(np.float16)
        kern = rng.normal(size=(k, k)).astype(np.float32)
        ours = st_ops.stencil2d(torch.from_numpy(img), kern)
        assert ours.dtype == torch.float16
        ours = ours.numpy()
        theirs = jst_ops.stencil2d(jnp.asarray(img), jnp.asarray(kern),
                                   use_pallas=False)
        assert theirs.dtype == jnp.float16
        np.testing.assert_array_equal(ours, np.asarray(theirs))
        if k > 1 and min(32, hw[0]) >= k // 2:  # its row tile holds the halo
            pallas = jst_ops.stencil2d(jnp.asarray(img), jnp.asarray(kern),
                                       tile_h=32, interpret=True)
            assert pallas.dtype == jnp.float16
            np.testing.assert_allclose(ours.astype(np.float32),
                                       np.asarray(pallas, np.float32),
                                       rtol=2.0 ** -10, atol=2.0 ** -14)

    def test_f16_edge5_vs_jax(self):
        """The pipeline's EDGE5 taps (24 of -1) on a float16 image."""
        img = np.random.default_rng(5).normal(size=(48, 72)) \
            .astype(np.float16)
        ours = st_ops.stencil2d(torch.from_numpy(img), EDGE5).numpy()
        theirs = jst_ref.stencil2d(jnp.asarray(img),
                                   jnp.asarray(EDGE5, jnp.float32))
        np.testing.assert_array_equal(ours, np.asarray(theirs))

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

    INT_TYPES = [(torch.uint8, np.uint8), (torch.int8, np.int8),
                 (torch.int16, np.int16), (torch.int32, np.int32)]

    @pytest.mark.parametrize("hw", [(33, 40), (64, 64), (5, 7)])
    @pytest.mark.parametrize("k", [3, 5])
    @pytest.mark.parametrize("types", INT_TYPES, ids=lambda t: str(t[1]))
    def test_int_vs_jax(self, hw, k, types):
        """Integer images: equal to JAX's ref.  Random images over the
        type's whole range and taps of a few units put sums out of the
        range both ways, so saturation at both bounds is exercised."""
        tdt, ndt = types
        info = np.iinfo(ndt)
        rng = np.random.default_rng([*hw, k, info.bits, info.min < 0])
        img = rng.integers(info.min, info.max, size=hw, endpoint=True,
                           dtype=ndt)
        kern = (3 * rng.normal(size=(k, k))).astype(np.float32)
        ours = st_ops.stencil2d(torch.from_numpy(img), kern)
        assert ours.dtype == tdt
        theirs = np.asarray(jst_ref.stencil2d(jnp.asarray(img),
                                              jnp.asarray(kern)))
        assert theirs.dtype == ndt
        np.testing.assert_array_equal(ours.numpy(), theirs)
        if hw != (5, 7):
            assert (theirs == info.max).any() and (theirs == info.min).any()

    @pytest.mark.parametrize("k", [3, 5])
    @pytest.mark.parametrize("types", INT_TYPES, ids=lambda t: str(t[1]))
    def test_int_saturates_both_ways_vs_jax(self, k, types):
        """Sums far outside the type's range (a bright square times EDGE5-
        like taps scaled up) and inside it: the same as JAX's ref."""
        tdt, ndt = types
        info = np.iinfo(ndt)
        img = np.zeros((24, 24), ndt)
        img[6:14, 8:16] = info.max
        img[14:18, 2:6] = info.min
        img[1, 1] = 7
        kern = np.full((k, k), -1.0e3, np.float32)
        kern[k // 2, k // 2] = 4.0e3 * k * k
        kern[0, 0] = 0.37
        ours = st_ops.stencil2d(torch.from_numpy(img), kern).numpy()
        theirs = np.asarray(jst_ref.stencil2d(jnp.asarray(img),
                                              jnp.asarray(kern)))
        np.testing.assert_array_equal(ours, theirs)
        assert (theirs == info.max).any() and (theirs == info.min).any()

    def test_saturating_conversion_vs_xla(self):
        """The conversion back alone: NaN to 0, truncation, saturation,
        with 2^31 - 1 (not representable in float32) as the int32 bound."""
        x = np.asarray([3e9, -3e9, np.nan, 2.7, -2.7, 2.0 ** 31,
                        -2.0 ** 31, 2.0 ** 31 - 128, np.inf, -np.inf,
                        255.9, 256.0, -0.5, 127.5, -128.9], np.float32)
        for tdt, ndt in self.INT_TYPES:
            ours = st_ref.saturate_to(torch.from_numpy(x), tdt).numpy()
            np.testing.assert_array_equal(ours,
                                          np.asarray(jnp.asarray(x)
                                                     .astype(ndt)))
        assert st_ref.saturate_to(torch.from_numpy(x[:5]),
                                  torch.int32).tolist() == \
            [2 ** 31 - 1, -2 ** 31, 0, 2, -2]
        assert st_ref.saturate_to(torch.from_numpy(x[:5]),
                                  torch.uint8).tolist() == [255, 0, 0, 2, 0]

    @pytest.mark.parametrize("k", [3, 5])
    def test_uint8_vs_jax_pallas(self, k):
        """A uint8 image against JAX's Pallas op in interpret mode."""
        rng = np.random.default_rng([k, 8])
        img = rng.integers(0, 255, size=(64, 48), endpoint=True,
                           dtype=np.uint8)
        kern = rng.normal(size=(k, k)).astype(np.float32)
        theirs = np.asarray(jst_ops.stencil2d(jnp.asarray(img),
                                              jnp.asarray(kern), tile_h=32,
                                              interpret=True))
        assert theirs.dtype == np.uint8
        ours = st_ops.stencil2d(torch.from_numpy(img), kern).numpy()
        np.testing.assert_array_equal(ours, theirs)

    def test_refuses_what_the_kernel_does_not_take(self):
        for dtype in (torch.int64, torch.bool):
            with pytest.raises(TypeError, match="float32, bfloat16"):
                st_ops.stencil2d(torch.zeros(8, 8, dtype=dtype),
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
