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
        """int64 is still refused (JAX without 64-bit mode has no int64 to
        hold it to); bool images compute (test_bool_vs_jax)."""
        with pytest.raises(TypeError, match="float32, bfloat16"):
            st_ops.stencil2d(torch.zeros(8, 8, dtype=torch.int64),
                             np.ones((3, 3)))
        with pytest.raises(ValueError, match=r"\(H, W\)"):
            st_ops.stencil2d(torch.zeros(2, 8, 8), np.ones((3, 3)))
        with pytest.raises(ValueError, match="non-empty"):
            st_ops.stencil2d(torch.zeros(0, 8), np.ones((3, 3)))

    @pytest.mark.parametrize("k", [3, 5])
    def test_bool_vs_jax(self, k):
        """A bool image against JAX's oracle and its Pallas op in
        interpret mode: summed in float32 and cast back as ``!= 0``.  Taps
        whose sums cancel give false pixels as well as true ones."""
        rng = np.random.default_rng([k, 1])
        img = rng.integers(0, 2, size=(40, 24)).astype(bool)
        kern = rng.integers(-1, 2, size=(k, k)).astype(np.float32)
        ours = st_ops.stencil2d(torch.from_numpy(img), kern).numpy()
        for theirs in (jst_ref.stencil2d(jnp.asarray(img), jnp.asarray(kern)),
                       jst_ops.stencil2d(jnp.asarray(img), jnp.asarray(kern),
                                         tile_h=16, interpret=True)):
            theirs = np.asarray(theirs)
            assert theirs.dtype == np.bool_ and ours.dtype == np.bool_
            np.testing.assert_array_equal(ours, theirs)
        assert ours.any() and not ours.all()

    def test_cpu_runs_plain_version_without_launch(self):
        before = launch_counts()["stencil"]
        img = torch.randn(16, 16, generator=torch.Generator().manual_seed(0))
        taps = st_ops.taps_of(np.ones((5, 5)))
        assert torch.equal(st_ops.stencil2d(img, taps),
                           st_ref.stencil2d(img, taps))
        assert launch_counts()["stencil"] == before


# --------------------------------------------------------------------------
# float16 and empty sequences through the other kernel ops
# --------------------------------------------------------------------------

class TestFloat16AndEmpty:
    """float16 through flash attention (at a head dim the kernel pads, 48),
    the SSD scan (with a bfloat16 dt, which the op casts to float32) and
    the grouped matmul, and the SSD scan at S = 0, each against the JAX
    op on the same numpy inputs.  float16 tolerances: 2e-3 for attention
    (one f16 ulp of outputs below 4: the Pallas kernel sums its online
    softmax in another order), 1e-3 for the scan's y and the grouped
    matmul (about two f16 ulps of outputs below 1 and 2), and the
    reference tests' 1e-4 / 1e-5 for the scan's float32 state."""

    def test_flash_f16_head_dim_48_vs_jax(self):
        from repro.kernels.flash_attention import ops as jfa_ops
        from repro_torch.kernels.flash_attention import ops as fa_ops
        rng = np.random.default_rng(48)
        B, H, K, S, D = 2, 4, 2, 40, 48
        q = (rng.normal(size=(B, H, S, D)) * 0.3).astype(np.float16)
        k = (rng.normal(size=(B, K, S, D)) * 0.3).astype(np.float16)
        v = rng.normal(size=(B, K, S, D)).astype(np.float16)
        ours = fa_ops.mha(*(torch.from_numpy(t) for t in (q, k, v)))
        assert ours.dtype == torch.float16 and ours.shape == (B, H, S, D)
        for kw in (dict(interpret=True), dict(use_pallas=False)):
            theirs = jfa_ops.mha(*(jnp.asarray(t) for t in (q, k, v)), **kw)
            np.testing.assert_allclose(ours.float().numpy(),
                                       np.asarray(theirs, np.float32),
                                       rtol=2e-3, atol=2e-3)

    def test_ssd_f16_with_bf16_dt_vs_jax(self):
        from repro.kernels.ssd_scan import ops as jssd_ops
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        rng = np.random.default_rng(16)
        b, S, H, P, G, N = 2, 48, 4, 8, 1, 16
        x = rng.normal(size=(b, S, H, P)).astype(np.float16)
        dt = torch.from_numpy((rng.random((b, S, H)) * 0.2).astype(
            np.float32)).bfloat16()
        A = (-rng.random(H) - 0.1).astype(np.float32)
        B = (rng.normal(size=(b, S, G, N)) * 0.3).astype(np.float16)
        C = (rng.normal(size=(b, S, G, N)) * 0.3).astype(np.float16)
        y, h = ssd_ops.ssd(torch.from_numpy(x), dt, torch.from_numpy(A),
                           torch.from_numpy(B), torch.from_numpy(C),
                           chunk=16, return_state=True)
        jy, jh = jssd_ops.ssd(jnp.asarray(x),
                              jnp.asarray(dt.float().numpy(), jnp.bfloat16),
                              jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                              chunk=16, return_state=True)
        assert y.dtype == torch.float16 and h.dtype == torch.float32
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(jy, np.float32), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                                   atol=1e-5)

    def test_ssd_empty_sequence_vs_jax(self):
        """S = 0: an empty y and the zero state, as the JAX op returns."""
        from repro.kernels.ssd_scan import ops as jssd_ops
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        A = np.asarray([-0.5, -1.0, -0.3, -2.0], np.float32)
        shapes = [(2, 0, 4, 8), (2, 0, 4), (2, 0, 1, 16), (2, 0, 1, 16)]
        arrays = [np.zeros(s, np.float32) for s in shapes]
        x, dt, B, C = (torch.from_numpy(a) for a in arrays)
        y, h = ssd_ops.ssd(x, dt, torch.from_numpy(A), B, C,
                           return_state=True)
        jy, jh = jssd_ops.ssd(*(jnp.asarray(a) for a in arrays[:2]),
                              jnp.asarray(A),
                              *(jnp.asarray(a) for a in arrays[2:]),
                              return_state=True)
        assert tuple(y.shape) == jy.shape == (2, 0, 4, 8)
        assert tuple(h.shape) == jh.shape == (8, 16, 8)
        assert h.dtype == torch.float32
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        assert not h.any()
        y_only = ssd_ops.ssd(x, dt, torch.from_numpy(A), B, C)
        assert tuple(y_only.shape) == (2, 0, 4, 8)

    @pytest.mark.parametrize("w_dtype", [np.float16, np.float32])
    def test_moe_apply_f16_vs_jax(self, w_dtype):
        from repro.kernels.moe_gmm import ops as jgmm_ops
        from repro_torch.kernels.moe_gmm import ops as gmm_ops
        rng = np.random.default_rng(7)
        T, D, F, E = 64, 16, 32, 4
        x = rng.normal(size=(T, D)).astype(np.float16)
        eo = rng.integers(0, E, T).astype(np.int32)
        w = (rng.normal(size=(E, D, F)) * 0.1).astype(w_dtype)
        ours = gmm_ops.moe_apply(torch.from_numpy(x), torch.from_numpy(eo),
                                 torch.from_numpy(w), tile_m=16)
        theirs = jgmm_ops.moe_apply(jnp.asarray(x), jnp.asarray(eo),
                                    jnp.asarray(w), tile_m=16, tile_f=16,
                                    interpret=True)
        assert ours.dtype == torch.float16
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(theirs, np.float32),
                                   rtol=1e-3, atol=1e-3)
