"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit, and skips without
them.  The file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.mandelbrot import ops as mb_ops, ref as mb_ref
from repro_torch.kernels.moe_gmm import (kernel as gmm_kernel,
                                          ops as gmm_ops, ref as gmm_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref
from repro_torch.kernels.stencil import ops as st_ops, ref as st_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("hw_row0", [((32, 4096), 1024), ((37, 1000), None)])
def test_mandelbrot_kernel_equals_plain(cuda, hw_row0):
    (H, W), row0 = hw_row0
    r0 = None if row0 is None else torch.tensor(row0, dtype=torch.int32,
                                                device=cuda)
    kw = dict(x0=-2.2, y0=-1.15, pixel_delta=3.0 / W, max_iterations=500,
              row0=r0)
    before = mb_ops.mandelbrot.launches
    got = mb_ops.mandelbrot(H, W, device=None if r0 is not None else cuda,
                            **kw)
    want = mb_ref.mandelbrot(H, W, device=cuda, **kw)
    torch.cuda.synchronize()
    assert mb_ops.mandelbrot.launches == before + 1
    assert got.is_cuda and torch.equal(got, want)


@pytest.mark.parametrize("hw", [(2048, 2048), (1000, 777), (8, 8)])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11, 15])  # > 9: runtime k
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil_kernel_equals_plain(cuda, hw, k, dtype):
    g = torch.Generator().manual_seed(k)
    img = torch.randn(*hw, generator=g).to(dtype).to(cuda)
    taps = st_ops.taps_of(torch.randn(k, k, generator=g))
    before = st_ops.stencil2d.launches
    got = st_ops.stencil2d(img, taps)
    want = st_ref.stencil2d(img, taps)
    torch.cuda.synchronize()
    assert st_ops.stencil2d.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)


def test_stencil_card_refuses_without_fallback(cuda):
    """A transposed image is refused; a 7 x 7 kernel (refused before the
    kernel took every odd k) runs and is exact."""
    img = torch.randn(64, 64, generator=torch.Generator().manual_seed(1)
                      ).to(cuda)
    before = st_ops.stencil2d.launches
    with pytest.raises(ValueError, match="contiguous"):
        st_ops.stencil2d(img.t(), np.ones((3, 3)))
    assert st_ops.stencil2d.launches == before
    taps = st_ops.taps_of(np.arange(49.0).reshape(7, 7) / 49.0)
    assert torch.equal(st_ops.stencil2d(img, taps),
                       st_ref.stencil2d(img, taps))
    assert st_ops.stencil2d.launches == before + 1


# -- flash attention: 2e-4 in float32, 5e-2 in bfloat16 (the plain version
# rounds its probabilities to bf16 before the PV product, the kernel keeps
# them in f32); and, scaled to the output, max |diff| within 2e-2 of
# max |want| and ||diff|| within 1e-2 of ||want||: near-uniform softmax
# over ~1,000 keys gives |o| ~ 0.03, below 5e-2 ---------------------------------


def _assert_flash_close(got, want, dtype):
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    err = float((got - want).abs().max())
    assert err <= 2e-2 * float(want.abs().max())
    assert float((got - want).norm()) <= 1e-2 * float(want.norm())

FLASH_SHAPES = [  # (B, H, K, Sq, Sk, D)
    (4, 14, 2, 2048, 2048, 64),  # the qwen2-0.5b forward: GQA group of 7
    (1, 4, 2, 64, 64, 32), (2, 8, 1, 96, 96, 64), (2, 4, 4, 128, 128, 32),
    (1, 2, 2, 33, 33, 16),       # ragged
    (2, 4, 2, 1, 80, 32),        # decode: Sq = 1
    (1, 8, 1, 100, 100, 128), (1, 8, 1, 70, 70, 256),
    (4, 16, 16, 2048, 2048, 128),  # the deepseek-moe-16b forward: MHA, D=128
]

FLASH_NONCAUSAL_SHAPES = [  # (B, H, K, Sq, Sk, D), causal=False
    (2, 8, 2, 300, 300, 64),   # an encoder: Sq = Sk
    (3, 6, 6, 1, 1500, 64),    # cross-attention of a decode step: Sq = 1
    (2, 4, 2, 77, 250, 32),    # cross-attention, 1 < Sq < Sk
    (1, 4, 1, 130, 45, 128),   # Sq > Sk (only without causality)
    (1, 2, 2, 33, 70, 16), (1, 2, 1, 40, 65, 256),
]


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    B, H, K, Sq, Sk, D = shape
    g = torch.Generator().manual_seed(Sq * 7 + D)
    q = (torch.randn(B, H, Sq, D, generator=g) * 0.3).to(dtype).to(cuda)
    k = (torch.randn(B, K, Sk, D, generator=g) * 0.3).to(dtype).to(cuda)
    v = torch.randn(B, K, Sk, D, generator=g).to(dtype).to(cuda)
    before = fa_ops.mha.launches
    got = fa_ops.mha(q, k, v, causal=True)
    want = fa_ref.mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + 1
    assert got.dtype == dtype
    _assert_flash_close(got, want, dtype)


@pytest.mark.parametrize("shape", FLASH_NONCAUSAL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_noncausal_matches_plain(cuda, shape, dtype):
    B, H, K, Sq, Sk, D = shape
    g = torch.Generator().manual_seed(Sk * 3 + D)
    q = (torch.randn(B, H, Sq, D, generator=g) * 0.3).to(dtype).to(cuda)
    k = (torch.randn(B, K, Sk, D, generator=g) * 0.3).to(dtype).to(cuda)
    v = torch.randn(B, K, Sk, D, generator=g).to(dtype).to(cuda)
    before = fa_ops.mha.launches
    got = fa_ops.mha(q, k, v, causal=False)
    want = fa_ref.mha(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + 1
    _assert_flash_close(got, want, dtype)


def test_flash_bf16_model_layout_on_tensor_cores(cuda):
    """bf16 q, k, v in the model's (B, S, heads, D) layout through the
    tensor-core path: strides read in place, output in q's layout."""
    g = torch.Generator().manual_seed(6)
    B, S, H, K, D = 2, 333, 14, 2, 64
    q, k, v = (torch.randn(B, S, n, D, generator=g).bfloat16().to(cuda)
               for n in (H, K, K))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = fa_ops.mha(qt, kt, vt)
    want = fa_ref.mha(qt, kt, vt)
    assert got.stride() == qt.stride()
    _assert_flash_close(got, want, torch.bfloat16)


def test_flash_tensor_core_path_refuses_unaligned_rows(cuda):
    """The tensor-core path copies 16-byte rows: a seq stride that is not
    a multiple of 8 elements is refused with a clear error, and nothing
    falls back to the plain version."""
    base = torch.zeros(1, 2, 40, 68, dtype=torch.bfloat16, device=cuda)
    q = base[..., :64]  # rows of 68 elements: 136 bytes, not 16-aligned
    assert q.stride(2) == 68
    before = fa_ops.mha.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.mha(q, q, q)
    assert fa_ops.mha.launches == before
    got = fa_ops.mha(q.float(), q.float(), q.float())  # f32: FMA path
    assert fa_ops.mha.launches == before + 1 and got.shape == q.shape


def test_flash_kernel_reads_model_layout_in_place(cuda):
    """q, k, v as the model holds them, (B, S, heads, D) seen through a
    transpose: the kernel reads the strides, copies nothing, and writes its
    output in q's layout."""
    g = torch.Generator().manual_seed(5)
    B, S, H, K, D = 2, 200, 14, 2, 64
    q, k, v = (torch.randn(B, S, n, D, generator=g).to(cuda)
               for n in (H, K, K))
    got = fa_ops.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = fa_ref.mha(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2))
    assert got.stride() == q.transpose(1, 2).stride()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_flash_card_refuses_without_fallback(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    before = fa_ops.mha.launches
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.mha(q, q, q)
    with pytest.raises(TypeError, match="float32"):
        fa_ops.mha(q.half(), q.half(), q.half())
    assert fa_ops.mha.launches == before


def test_reduced_forward_on_card_matches_cpu(cuda):
    """The reduced qwen2-0.5b (float32) on the card, through the flash
    kernel, against the same forward on the CPU (plain attention)."""
    from repro_torch.models import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    m = Model(get_config("qwen2-0.5b", reduced=True))
    params = m.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 40)).astype(np.int32))
    want, _ = m.forward(params, toks)
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(cuda), params)
    before = fa_ops.mha.launches
    got, _ = m.forward(on_card, toks.to(cuda))
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + m.cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# -- SSD scan: float32 within 2e-4; bf16 y within rtol 1e-2 / atol 5e-2 (both
# sides sum in f32 and round y to bf16 once, so a rounding flip costs one
# bf16 ulp, 2^-8 of |y|); the f32 state within 2e-4 either way ----------------

SSD_SHAPES = [  # (batch, S, H, P, G, N)
    (4, 2048, 80, 64, 1, 128),  # the mamba2-2.7b forward
    (4, 2048, 64, 64, 1, 64),   # the zamba2-1.2b forward
    (1, 64, 2, 8, 2, 4),        # the reference tests' sizes, G = H
    (2, 33, 4, 16, 4, 16),      # ragged, G = H
    (1, 2047, 8, 64, 1, 128),   # ragged, long
    (2, 100, 6, 16, 2, 16),     # 1 < G < H
]


def _ssd_inputs(shape, dtype, device, seed=0):
    b, S, H, P, G, N = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, S, H, P, generator=g).to(dtype).to(device)
    dt = (torch.rand(b, S, H, generator=g) * 0.2).to(device)
    A = (-torch.rand(H, generator=g) - 0.1).to(device)
    B = (torch.randn(b, S, G, N, generator=g) * 0.3).to(dtype).to(device)
    C = (torch.randn(b, S, G, N, generator=g) * 0.3).to(dtype).to(device)
    return x, dt, A, B, C


@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(cuda, shape, dtype):
    x, dt, A, B, C = _ssd_inputs(shape, dtype, cuda, seed=shape[1])
    before = ssd_ops.ssd.launches
    y, hT = ssd_ops.ssd(x, dt, A, B, C, return_state=True)
    want_y, want_h = ssd_ref.ssd(x, dt, A, B, C, return_state=True)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == before + 1
    assert y.dtype == dtype and hT.dtype == torch.float32
    rtol, atol = (1e-2, 5e-2) if dtype == torch.bfloat16 else (2e-4, 2e-4)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(hT, want_h, rtol=2e-4, atol=2e-4)
    assert torch.equal(ssd_ops.ssd(x, dt, A, B, C), y)  # no state: same y


def test_ssd_kernel_reads_model_layout_in_place(cuda):
    """x, B and C as the model slices them out of one projection, (B, S, ·)
    views with the row stride of the whole width: read through their
    strides, nothing copied."""
    g = torch.Generator().manual_seed(3)
    b, S, H, P, N = 2, 130, 4, 64, 128
    xBC = torch.randn(b, S, H * P + 2 * N, generator=g).to(cuda) * 0.3
    x = xBC[..., :H * P].reshape(b, S, H, P)
    B = xBC[..., H * P:H * P + N].reshape(b, S, 1, N)
    C = xBC[..., H * P + N:].reshape(b, S, 1, N)
    dt = torch.rand(b, S, H, generator=g).to(cuda) * 0.1
    A = -torch.ones(H, device=cuda)
    assert not x.is_contiguous()
    got = ssd_ops.ssd(x, dt, A, B, C)
    want = ssd_ref.ssd(x, dt, A, B, C)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_ssd_card_refuses_without_fallback(cuda):
    x, dt, A, B, C = _ssd_inputs((1, 16, 2, 8, 1, 4), torch.float32, cuda)
    before = ssd_ops.ssd.launches
    with pytest.raises(TypeError, match="float32 or"):
        ssd_ops.ssd(x.half(), dt, A, B.half(), C.half())
    with pytest.raises(TypeError, match="dt and A"):
        ssd_ops.ssd(x, dt.bfloat16(), A, B, C)
    wide = x.new_zeros(1, 16, 2, 65)
    with pytest.raises(ValueError, match="P <="):
        ssd_ops.ssd(wide, dt, A, B, C)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                    B, C)
    assert ssd_ops.ssd.launches == before


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_reduced_ssm_on_card_matches_cpu(cuda, arch):
    """The reduced mamba2 / zamba2 (float32) on the card, through the SSD
    kernel (and the flash kernel in the shared block), against the same
    model on the CPU (plain versions): forward, prefill and one decode
    step, which starts from the state the kernel handed over."""
    from repro_torch.models import Model, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    m = Model(get_config(arch, reduced=True))
    params = m.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 70)).astype(np.int32))
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(cuda), params)
    n_mamba = sum(c for k, c in transformer.structure(m.cfg) if k == "mamba")
    n_shared = sum(1 for k, _ in transformer.structure(m.cfg)
                   if k == "shared_attn")
    before = ssd_ops.ssd.launches, fa_ops.mha.launches
    got, _ = m.forward(on_card, toks.to(cuda))
    torch.cuda.synchronize()
    assert (ssd_ops.ssd.launches, fa_ops.mha.launches) == (
        before[0] + n_mamba, before[1] + n_shared)
    want, _ = m.forward(params, toks)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    lp, cache = m.prefill(on_card, toks[:, :64].to(cuda), max_len=72)
    ld, _ = m.decode_step(on_card, cache, toks[:, 64:65].to(cuda))
    wp, wcache = m.prefill(params, toks[:, :64], max_len=72)
    wd, _ = m.decode_step(params, wcache, toks[:, 64:65])
    torch.testing.assert_close(lp.cpu(), wp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ld.cpu(), wd, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_reduced_ssm_serving_on_card_matches_one_slot_runs(cuda, arch):
    """The reduced model (float32) served on the card with 3 slots, slots
    reused: every request's tokens equal its run alone in a one-slot
    engine, so the mamba state's slot handling (reset, frozen rows) holds
    on the card."""
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import (LocalDecodeBackend, ServeEngine,
                                   build_decode_model)
    torch.backends.cuda.matmul.allow_tf32 = False
    model, params = build_decode_model(("model", arch, True), device=cuda)
    reqs = launcher.requests(6, model.cfg.vocab, 8)

    def serve(batch, n_slots):
        eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=n_slots,
                                             max_len=32))
        for r in batch:
            eng.submit(r)
        eng.run_until_drained()
        return {r.rid: eng.poll(r.rid).tokens for r in batch}

    together = serve(reqs, 3)
    for r in reqs:
        assert serve([r], 1)[r.rid] == together[r.rid], f"req {r.rid}"



# -- moe_gmm: float32 within rtol 1e-4 and 1e-4 of max|y| at D = 2048 (the
# reference's rtol = atol = 1e-5 at its own shapes), bf16 within 1e-2 (both
# sides sum in f32 and round y to bf16 once: a flip costs one bf16 ulp) ------

GMM_SHAPES = [  # (T tokens, k, E, D, F, tile_m)
    (512, 6, 64, 2048, 1408, 128),  # deepseek-moe-16b's gate/up, cut in T
    (512, 6, 64, 1408, 2048, 128),  # ... and its down
    (4, 6, 64, 2048, 1408, 128),    # a decode step of 4 slots
    (64, 1, 4, 16, 32, 16), (200, 1, 8, 32, 64, 16),
    (33, 1, 2, 8, 16, 8),           # the reference tests' shapes
    (100, 2, 16, 72, 40, 48),       # ragged D, F and tile_m
]


def _gmm_inputs(shape, x_dtype, w_dtype, device, skew=False, seed=0):
    T, k, E, D, F, _ = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T * k, D, generator=g).to(x_dtype).to(device)
    eo = torch.randint(0, E, (T * k,), generator=g)
    if skew:
        eo.fill_(E // 2)  # every row to one expert, the rest empty
    w = (torch.randn(E, D, F, generator=g) / D ** 0.5).to(w_dtype)
    return x, eo.to(device), w.to(device)


def _gmm_tol(shape, x_dtype, want):
    if x_dtype == torch.bfloat16:
        return 1e-2, 1e-2 * float(want.float().abs().max())
    if shape[3] <= 32:
        return 1e-5, 1e-5
    return 1e-4, 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("shape", GMM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("skew", [False, True])
def test_moe_gmm_kernel_matches_plain(cuda, shape, x_dtype, w_dtype, skew):
    x, eo, w = _gmm_inputs(shape, x_dtype, w_dtype, cuda, skew=skew)
    before = gmm_ops.moe_apply.launches
    got = gmm_ops.moe_apply(x, eo, w, tile_m=shape[5])
    want = gmm_ref.gmm(x, eo, w)
    torch.cuda.synchronize()
    assert gmm_ops.moe_apply.launches == before + 1
    assert got.dtype == x_dtype and got.shape == want.shape
    rtol, atol = _gmm_tol(shape, x_dtype, want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_moe_gmm_padding_is_never_read_or_written(cuda):
    """On the padded buffer of ``sort_by_expert`` (each padded row its own
    source): NaN in every padded row of x stays out of y, and the kernel
    writes the token rows of its output only."""
    x, eo, w = _gmm_inputs((300, 2, 8, 256, 192, 128), torch.bfloat16,
                           torch.float32, cuda, seed=5)
    x_p, te, (order, slot), valid, rows = gmm_ops.sort_by_expert(
        x, eo, 8, 128)
    x_p[~valid] = float("nan")
    y_p = torch.full((x_p.shape[0], 192), float("nan"), dtype=x.dtype,
                     device=cuda)
    identity = torch.arange(x_p.shape[0], dtype=torch.int32, device=cuda)
    gmm_kernel.launch(x_p, te, rows, identity, w, y_p, 128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y_p[valid]).all())
    assert bool(torch.isnan(y_p[~valid]).all())
    want = gmm_ref.gmm(x, eo, w)
    got = torch.empty_like(want).index_copy_(0, order, y_p[slot])
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2 * float(want.float().abs().max()))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_moe_gmm_row_gather_touches_token_rows_only(cuda, x_dtype):
    """The op's mode: padded row i reads x's row ``row_src[i]`` and writes
    y's.  x rows that no valid padded row names hold NaN and stay unread;
    y rows that none names stay as they were (NaN)."""
    x, eo, w = _gmm_inputs((300, 2, 8, 256, 192, 128), x_dtype,
                           torch.float32, cuda, seed=9)
    T = x.shape[0]
    te, rows, row_src = gmm_ops.route(eo, 8, 128)
    x_big = torch.full((T + 50, 256), float("nan"), dtype=x_dtype,
                       device=cuda)
    x_big[:T] = x
    y = torch.full((T + 50, 192), float("nan"), dtype=x_dtype, device=cuda)
    gmm_kernel.launch(x_big, te, rows, row_src, w, y, 128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y[:T]).all())
    assert bool(torch.isnan(y[T:]).all())
    want = gmm_ref.gmm(x, eo, w)
    rtol, atol = _gmm_tol((0, 0, 0, 256), x_dtype, want)
    torch.testing.assert_close(y[:T].float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_moe_gmm_past_the_old_row_block_limit(cuda, x_dtype):
    """4.3 M rows at D = F = 16: 33,6xx row tiles of 128, more than the
    65,535 row blocks a grid.y held (two 64-row slices a tile on the FMA
    path), launch through the 1-D grid and match the plain version."""
    x, eo, w = _gmm_inputs((4_300_000, 1, 8, 16, 16, 128), x_dtype,
                           torch.float32, cuda, seed=7)
    before = gmm_ops.moe_apply.launches
    got = gmm_ops.moe_apply(x, eo, w)
    want = gmm_ref.gmm(x, eo, w)
    torch.cuda.synchronize()
    assert gmm_ops.moe_apply.launches == before + 1
    rtol, atol = _gmm_tol((0, 0, 0, 16), x_dtype, want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_moe_gmm_card_refuses_without_fallback(cuda):
    x, eo, w = _gmm_inputs((16, 2, 4, 32, 16, 16), torch.float32,
                           torch.float32, cuda)
    before = gmm_ops.moe_apply.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gmm_ops.moe_apply(x.half(), eo, w)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_ops.moe_apply(x, eo, w.transpose(1, 2).contiguous()
                          .transpose(1, 2))
    with pytest.raises(ValueError, match="one device"):
        gmm_ops.moe_apply(x, eo.cpu(), w)
    assert gmm_ops.moe_apply.launches == before


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"])
def test_reduced_moe_on_card_matches_cpu(cuda, arch):
    """The reduced MoE model (float32) on its ragged path on the card,
    three kernel launches a MoE layer, against the same model on the CPU:
    forward (logits and aux), prefill and one decode step."""
    import dataclasses
    from repro_torch.models import Model, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    m = Model(dataclasses.replace(get_config(arch, reduced=True),
                                  moe_ragged=True))
    params = m.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 40)).astype(np.int32))
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(cuda), params)
    n_moe = sum(c for k, c in transformer.structure(m.cfg)
                if k == "attn_moe")
    before = gmm_ops.moe_apply.launches
    got, aux = m.forward(on_card, toks.to(cuda))
    torch.cuda.synchronize()
    assert gmm_ops.moe_apply.launches == before + 3 * n_moe
    want, want_aux = m.forward(params, toks)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)
    lp, cache = m.prefill(on_card, toks[:, :32].to(cuda), max_len=40)
    ld, _ = m.decode_step(on_card, cache, toks[:, 32:33].to(cuda))
    wp, wcache = m.prefill(params, toks[:, :32], max_len=40)
    wd, _ = m.decode_step(params, wcache, toks[:, 32:33])
    torch.testing.assert_close(lp.cpu(), wp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ld.cpu(), wd, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"])
def test_reduced_moe_serving_on_card_matches_one_slot_runs(cuda, arch):
    """The reduced MoE model (float32) served on the card on its ragged
    path with 3 slots, slots reused: every request's tokens equal its run
    alone in a one-slot engine, and every decode step launches the kernel
    three times a MoE layer."""
    import dataclasses
    from repro_torch.launch import serve as launcher
    from repro_torch.models import Model
    from repro_torch.serve import (LocalDecodeBackend, ServeEngine,
                                   build_decode_model)
    torch.backends.cuda.matmul.allow_tf32 = False
    base, params = build_decode_model(("model", arch, True), device=cuda)
    model = Model(dataclasses.replace(base.cfg, moe_ragged=True))
    reqs = launcher.requests(6, model.cfg.vocab, 8)

    def serve(batch, n_slots):
        eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=n_slots,
                                             max_len=32))
        for r in batch:
            eng.submit(r)
        eng.run_until_drained()
        return {r.rid: eng.poll(r.rid).tokens for r in batch}

    before = gmm_ops.moe_apply.launches
    together = serve(reqs, 3)
    assert gmm_ops.moe_apply.launches > before
    for r in reqs:
        assert serve([r], 1)[r.rid] == together[r.rid], f"req {r.rid}"


# -- every kernel op refuses to cut the autograd graph on the card ------------

def _grad_cases(cuda):
    g = torch.Generator().manual_seed(11)
    q = torch.randn(1, 2, 16, 32, generator=g).to(cuda)
    img = torch.randn(32, 32, generator=g).to(cuda)
    x, dt, A, B, C = _ssd_inputs((1, 16, 2, 8, 1, 4), torch.float32, cuda)
    gx, eo, gw = _gmm_inputs((16, 2, 4, 32, 16, 16), torch.float32,
                             torch.float32, cuda)
    return {
        "mha": (fa_ops.mha, lambda r: fa_ops.mha(q.requires_grad_(r), q, q)),
        "ssd": (ssd_ops.ssd,
                lambda r: ssd_ops.ssd(x, dt.requires_grad_(r), A, B, C)),
        "moe_apply": (gmm_ops.moe_apply,
                      lambda r: gmm_ops.moe_apply(gx, eo,
                                                  gw.requires_grad_(r))),
        "stencil2d": (st_ops.stencil2d,
                      lambda r: st_ops.stencil2d(img.requires_grad_(r),
                                                 np.ones((3, 3)))),
    }


@pytest.mark.parametrize("op", ["mha", "ssd", "moe_apply", "stencil2d"])
def test_kernel_ops_refuse_grad_on_card(cuda, op):
    """With grad mode on and an input that requires grad, the op raises
    before its launch (the kernel has no backward, so the launch would cut
    the graph silently); under no_grad the same input launches."""
    fn, call = _grad_cases(cuda)[op]
    before = fn.launches
    with pytest.raises(RuntimeError, match=f"{op}: .*no backward"):
        call(True)
    assert fn.launches == before
    with torch.no_grad():
        out = call(True)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and not out.requires_grad
    call(False)
    assert fn.launches == before + 2


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm"])
def test_tensor_core_instructions_in_sass(cuda, name):
    """The bf16 paths run on the tensor cores: the built library's SASS
    holds HMMA (mma.sync) or HGMMA (wgmma) instructions."""
    import shutil
    import subprocess
    from repro_torch.kernels import _build
    _build.load(name)
    tool = shutil.which("cuobjdump") or str(
        _build.Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    assert sum(("HMMA" in ln or "HGMMA" in ln)
               for ln in sass.splitlines()) > 0
