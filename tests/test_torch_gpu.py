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
from repro_torch.kernels.mandelbrot import (kernel as mb_kernel,
                                            ops as mb_ops, ref as mb_ref)
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


# (name, (H, W), x0, y0, delta, max_iterations): a window wholly inside the
# set (the main cardioid), one wholly outside, one pixel, a ragged width,
# and no step at all
MANDELBROT_WINDOWS = [
    ("inside", (64, 256), -0.4, -0.2, 0.4 / 256, 300),
    ("outside", (40, 200), 2.5, 2.5, 0.01, 300),
    ("one pixel", (1, 1), -0.75, 0.1, 0.01, 1000),
    ("ragged", (37, 1000), -2.2, -1.15, 3.0 / 1000, 1000),
    ("zero iterations", (33, 70), -2.2, -1.15, 0.04, 0),
    ("negative iterations", (33, 70), -2.2, -1.15, 0.04, -3),
]


@pytest.mark.parametrize("window", MANDELBROT_WINDOWS, ids=lambda w: w[0])
def test_mandelbrot_kernel_windows_equal_plain(cuda, window):
    name, (H, W), x0, y0, delta, iters = window
    kw = dict(x0=x0, y0=y0, pixel_delta=delta, max_iterations=iters)
    got = mb_ops.mandelbrot(H, W, device=cuda, **kw)
    want = mb_ref.mandelbrot(H, W, device=cuda, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if name == "inside":
        assert bool((got == iters).all())
    elif name == "outside":
        assert bool((got == 1).all())
    elif iters <= 0:
        assert not bool(got.any())


def test_mandelbrot_kernel_farm_bands_equal_plain(cuda):
    """All 64 bands of the farm (4096 x 2048, 1000 iterations), each band's
    top row read on the device, and the full image in one launch."""
    W, H, bands = 4096, 2048, 64
    kw = dict(x0=-2.2, y0=-1.15, pixel_delta=3.0 / W, max_iterations=1000)
    band_h = H // bands
    got = []
    for b in range(bands):
        r0 = torch.tensor(b * band_h, dtype=torch.int32, device=cuda)
        got.append(mb_ops.mandelbrot(band_h, W, row0=r0, **kw))
        assert torch.equal(got[-1], mb_ref.mandelbrot(band_h, W, row0=r0,
                                                      **kw)), f"band {b}"
    full = mb_ops.mandelbrot(H, W, device=cuda, **kw)
    assert torch.equal(full, torch.cat(got))


@pytest.mark.parametrize("hw", [(1, 1), (1, 33), (3, 31), (5, 64),
                                (37, 1000), (32, 4096)])
def test_mandelbrot_kernel_writes_every_pixel_once(cuda, hw):
    """The kernel's chunk order covers every pixel, for ragged H and W: an
    output filled with -1 beforehand keeps none of it and equals the plain
    version."""
    H, W = hw
    kw = dict(x0=-2.2, y0=-1.15, pixel_delta=3.0 / W, max_iterations=200)
    out = torch.full((H, W), -1, dtype=torch.int32, device=cuda)
    mb_kernel.launch(out, row0=None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, mb_ref.mandelbrot(H, W, device=cuda, **kw))


@pytest.mark.parametrize("hw", [(2048, 2048), (1000, 777), (8, 8)])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11, 15])  # > 9: runtime k
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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


# widths whose rows are not whole 16-byte copies (f32: W % 4, 16-bit: W %
# 8), one pixel, fewer rows or columns than k, a ragged last tile
@pytest.mark.parametrize("hw", [(64, 2046), (37, 2044), (130, 129), (1, 1),
                                (3, 5), (5, 2), (33, 136)])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_stencil_kernel_edges_equal_plain(cuda, hw, k, dtype):
    g = torch.Generator().manual_seed(100 + k)
    img = torch.randn(*hw, generator=g).to(dtype).to(cuda)
    taps = st_ops.taps_of(torch.randn(k, k, generator=g))
    got = st_ops.stencil2d(img, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, st_ref.stencil2d(img, taps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_stencil_zero_and_unit_taps_equal_plain(cuda, dtype):
    """Every tap but the centre -1 (subtracted without a multiply) or +1
    (multiplied), zero taps (skipped, as the plain version skips them: 0 * inf
    would be NaN; a ring around a zero centre too) and others, on an image
    holding signed zeros, infinities and NaN: the same values as the plain
    version, NaN where it has NaN."""
    from repro_torch.workloads import EDGE5
    g = torch.Generator().manual_seed(7)
    img = torch.randn(70, 264, generator=g)
    img[3, 5], img[10, 10], img[20, 30] = -0.0, float("inf"), float("nan")
    img[40, 100:140] = 0.0
    img = img.to(dtype).to(cuda)
    mixed = ((1.0, -1.0, 0.0), (-0.0, 2.5, 1.0), (-1.0, 0.0, -1.0))
    hollow = ((-1.0, -1.0, -1.0), (-1.0, 0.0, -1.0), (-1.0, -1.0, -1.0))
    for taps in (EDGE5, mixed, hollow, st_ops.taps_of(np.ones((7, 7))),
                 st_ops.taps_of(-np.ones((9, 9)))):
        got = st_ops.stencil2d(img, taps)
        want = st_ref.stencil2d(img, taps)
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan())
        same = torch.where(want.isnan(), torch.zeros_like(want), want)
        assert torch.equal(torch.where(got.isnan(), torch.zeros_like(got),
                                       got), same)


def test_stencil_card_refuses_without_fallback(cuda):
    """What the card once refused computes, one launch a call, exact
    against the plain version: a transposed image (copied once), a 7 x 7
    kernel, and a bool image (summed in float32, ``!= 0``); an int64
    image is still refused, with nothing launched."""
    img = torch.randn(64, 48, generator=torch.Generator().manual_seed(1)
                      ).to(cuda)
    taps = st_ops.taps_of(np.arange(49.0).reshape(7, 7) / 49.0 - 0.5)
    mask = img > 0.3
    for x in (img.t(), img, mask, mask.t()):
        before = st_ops.stencil2d.launches
        got = st_ops.stencil2d(x, taps)
        assert st_ops.stencil2d.launches == before + 1
        assert got.dtype == x.dtype and torch.equal(
            got, st_ref.stencil2d(x, taps))
    assert st_ops.stencil2d(mask, taps).any()
    before = st_ops.stencil2d.launches
    with pytest.raises(TypeError, match="float32, bfloat16"):
        st_ops.stencil2d(img.long(), taps)
    assert st_ops.stencil2d.launches == before


# -- flash attention: 2e-4 in float32, 5e-2 in bfloat16 (the plain version
# rounds its probabilities to bf16 before the PV product, the kernel keeps
# them in f32); and, scaled to the output, max |diff| within 2e-2 of
# max |want| and ||diff|| within 1e-2 of ||want||: near-uniform softmax
# over ~1,000 keys gives |o| ~ 0.03, below 5e-2 ---------------------------------


def _assert_flash_close(got, want, dtype):
    # float16: the plain version rounds its probabilities to f16 (2^-11 of
    # each) and both round o once, one f16 ulp (2e-3 at |o| < 4)
    tol = {torch.bfloat16: 5e-2, torch.float16: 5e-3}.get(dtype, 2e-4)
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
    (4, 8, 1, 2048, 2048, 256),  # the gemma-2b forward: MQA, D=256
    (2, 8, 2, 201, 201, 256),    # D=256, GQA group of 4, ragged
    (2, 4, 2, 1, 90, 256),       # D=256 decode: Sq = 1
    (4, 56, 8, 512, 512, 128),   # the yi-34b forward, cut in S: group of 7
    (4, 32, 8, 512, 512, 128),   # the phi3.5-moe forward, cut in S: of 4
    # qwen2-0.5b in the JAX package's prefill_32k cell: one row of 32,768
    # tokens, held against the plain version's query-chunked form
    (1, 14, 2, 32768, 32768, 64),
]

FLASH_NONCAUSAL_SHAPES = [  # (B, H, K, Sq, Sk, D), causal=False
    (2, 8, 2, 300, 300, 64),   # an encoder: Sq = Sk
    (3, 6, 6, 1, 1500, 64),    # cross-attention of a decode step: Sq = 1
    (2, 4, 2, 77, 250, 32),    # cross-attention, 1 < Sq < Sk
    (1, 4, 1, 130, 45, 128),   # Sq > Sk (only without causality)
    (1, 2, 2, 33, 70, 16), (1, 2, 1, 40, 65, 256),
    (2, 8, 1, 77, 250, 256),   # D=256 cross-attention, MQA, 1 < Sq < Sk
    (1, 4, 2, 130, 45, 256),   # D=256, Sq > Sk
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
    # past 4 GiB of (Sq, Sk) f32 logits (60 GB at 32k), the chunked form
    if B * H * Sq * Sk * 4 > 1 << 32:
        want = fa_ref.mha_chunked(q, k, v, causal=True, chunk=1024)
    else:
        want = fa_ref.mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + 1
    assert got.dtype == dtype
    _assert_flash_close(got, want, dtype)
    # the last query tile, whose online softmax sees every key tile
    _assert_flash_close(got[:, :, -128:], want[:, :, -128:], dtype)


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


@pytest.mark.parametrize("H,K", [(8, 1), (8, 2)], ids=["mqa", "gqa"])
def test_flash_d256_strided_on_tensor_cores(cuda, H, K):
    """bf16 at D = 256 on the tensor cores through strides: q, k, v in the
    model's (B, S, heads, D) layout read in place (output in q's layout),
    and rows whose seq stride is not a multiple of 8 elements copied once,
    each one launch against the plain version, causal and not."""
    from repro_torch.kernels.flash_attention import kernel
    assert kernel.tensor_core_path(torch.bfloat16, 256)
    g = torch.Generator().manual_seed(H + K)
    B, S, D = 2, 150, 256
    q, k, v = (torch.randn(B, S, n, D, generator=g).bfloat16().to(cuda)
               for n in (H, K, K))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    wide = torch.randn(B, K, S, D + 4, generator=g).bfloat16().to(cuda)
    kw = wide[..., :D]  # rows of 260 elements: not 16-byte copies
    assert kw.stride(2) == D + 4
    for causal in (True, False):
        before = fa_ops.mha.launches
        got = fa_ops.mha(qt, kt, vt, causal=causal)
        torch.cuda.synchronize()
        assert fa_ops.mha.launches == before + 1
        assert got.stride() == qt.stride()
        _assert_flash_close(got, fa_ref.mha(qt, kt, vt, causal=causal),
                            torch.bfloat16)
        got = fa_ops.mha(qt, kw, vt, causal=causal)
        torch.cuda.synchronize()
        assert fa_ops.mha.launches == before + 2
        _assert_flash_close(got, fa_ref.mha(qt, kw, vt, causal=causal),
                            torch.bfloat16)


def test_flash_tensor_core_path_refuses_unaligned_rows(cuda):
    """The tensor-core path copies 16-byte rows: bf16 q, k, v whose seq
    stride is not a multiple of 8 elements, or whose base is not 16-byte
    aligned, are copied once into fresh buffers and computed on the tensor
    cores, one launch a call, against the plain version."""
    g = torch.Generator().manual_seed(11)
    base = torch.randn(1, 2, 40, 68, generator=g).bfloat16().to(cuda)
    q = base[..., :64]  # rows of 68 elements: 136 bytes, not 16-aligned
    shifted = base[..., 1:65]  # base 2 bytes past an aligned one
    assert q.stride(2) == 68 and shifted.data_ptr() % 16 == 2
    for t in (q, shifted):
        before = fa_ops.mha.launches
        got = fa_ops.mha(t, t, t)
        torch.cuda.synchronize()
        assert fa_ops.mha.launches == before + 1 and got.shape == t.shape
        _assert_flash_close(got, fa_ref.mha(t, t, t), torch.bfloat16)


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


FLASH_EXTRA = [  # (B, H, K, Sq, Sk, D, dtype, causal)
    (1, 2, 2, 8, 8, 48, torch.float32, True),     # D padded to 64
    (2, 4, 2, 70, 70, 48, torch.float16, True),   # f16, D padded
    (2, 4, 2, 33, 90, 80, torch.bfloat16, False),  # bf16, D 80 -> 128
    (2, 8, 2, 128, 128, 64, torch.float16, True),
    (1, 4, 4, 40, 40, 256, torch.float16, True),
    (1, 2, 1, 50, 50, 200, torch.float32, True),  # D 200 -> 256
    (2, 8, 1, 90, 90, 200, torch.bfloat16, True),  # D 200 -> 256: tensor cores
]


@pytest.mark.parametrize("case", FLASH_EXTRA,
                         ids=lambda c: "x".join(map(str, c[:6]))
                         + f"-{str(c[6])[6:]}")
def test_flash_card_refuses_without_fallback(cuda, case):
    """What the card once refused computes, one launch a call, against the
    plain version: float16 (the FMA path), head dims outside
    ``kernel.HEAD_DIMS`` (zero-padded to the next, with the real scale),
    and a head dim that is not contiguous (copied once); D > 256 is still
    refused, with nothing launched."""
    B, H, K, Sq, Sk, D, dtype, causal = case
    g = torch.Generator().manual_seed(D + Sq)
    q = (torch.randn(B, H, Sq, D, generator=g) * 0.3).to(dtype).to(cuda)
    k = (torch.randn(B, K, Sk, D, generator=g) * 0.3).to(dtype).to(cuda)
    v = torch.randn(B, K, Sk, D, generator=g).to(dtype).to(cuda)
    strided = torch.empty(B, K, Sk, D, 2, dtype=dtype, device=cuda)[..., 0]
    strided.copy_(v)
    assert strided.stride(3) == 2
    for vv in (v, strided):
        before = fa_ops.mha.launches
        got = fa_ops.mha(q, k, vv, causal=causal)
        torch.cuda.synchronize()
        assert fa_ops.mha.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        _assert_flash_close(got, fa_ref.mha(q, k, v, causal=causal), dtype)
    wide = torch.zeros(1, 2, 8, 264, device=cuda, dtype=dtype)
    before = fa_ops.mha.launches
    with pytest.raises(ValueError, match="up to 256"):
        fa_ops.mha(wide, wide, wide)
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
    # the mamba2-2.7b forward in the JAX package's prefill_32k cell: one row
    # of 32,768 tokens, 512 chunks walked in series by each of 80 blocks
    (1, 32768, 80, 64, 1, 128),
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
    _assert_ssd_close(y, hT, want_y, want_h, dtype)
    # the last chunk's y, which carries the state of every chunk before it
    _assert_ssd_close(y[:, -64:], hT, want_y[:, -64:], want_h, dtype)
    assert torch.equal(ssd_ops.ssd(x, dt, A, B, C), y)  # no state: same y


def _assert_ssd_close(y, hT, want_y, want_h, dtype):
    """The reference's gates (bf16 y rtol 1e-2 / atol 5e-2; f32 2e-4; the
    f32 state 2e-4); bf16 y also within 2e-2 max |want| and its error's
    norm within 1e-2 of want's, so a dropped chunk term cannot hide under
    the absolute gate."""
    # float16 y: one f16 ulp (2e-3 at |y| < 4) once the f32 sums round
    rtol, atol = {torch.bfloat16: (1e-2, 5e-2),
                  torch.float16: (2e-3, 2e-3)}.get(dtype, (2e-4, 2e-4))
    got, want = y.float(), want_y.float()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    torch.testing.assert_close(hT, want_h, rtol=2e-4, atol=2e-4)
    if dtype == torch.bfloat16:
        diff = got - want
        assert float(diff.abs().max()) <= 2e-2 * float(want.abs().max())
        assert float(diff.norm()) <= 1e-2 * float(want.norm())


@pytest.mark.parametrize("pn", [(65, 16), (128, 128), (64, 256)],
                         ids=lambda v: f"P{v[0]}-N{v[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_any_p_and_n(cuda, pn, dtype):
    """Every P and N the reference takes: the op runs the kernel on P-slices
    of at most 64 and N-blocks of at most 128, one launch each."""
    P, N = pn
    shape = (2, 200, 4, P, 2, N)
    x, dt, A, B, C = _ssd_inputs(shape, dtype, cuda, seed=P + N)
    before = ssd_ops.ssd.launches
    y, hT = ssd_ops.ssd(x, dt, A, B, C, return_state=True)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == before + -(-P // 64) * -(-N // 128)
    assert y.dtype == dtype and hT.shape == (8, N, P)
    want_y, want_h = ssd_ref.ssd(x, dt, A, B, C, return_state=True)
    _assert_ssd_close(y, hT, want_y, want_h, dtype)


def test_ssd_bf16_unaligned_rows_computed(cuda):
    """bf16 rows that are not 16-byte aligned (odd base, odd row stride, P
    and N not multiples of 8) are read element by element, not refused."""
    g = torch.Generator().manual_seed(5)
    b, S, H, P, N = 2, 150, 4, 60, 36
    width = H * P + 2 * N + 3
    xBC = (torch.randn(b, S, width, generator=g) * 0.3).bfloat16().to(cuda)
    x = xBC[..., 1:1 + H * P].reshape(b, S, H, P)
    B = xBC[..., 1 + H * P:1 + H * P + N].reshape(b, S, 1, N)
    C = xBC[..., 1 + H * P + N:1 + H * P + 2 * N].reshape(b, S, 1, N)
    dt = torch.rand(b, S, H, generator=g).to(cuda) * 0.1
    A = -torch.ones(H, device=cuda)
    y, hT = ssd_ops.ssd(x, dt, A, B, C, return_state=True)
    want_y, want_h = ssd_ref.ssd(x, dt, A, B, C, return_state=True)
    _assert_ssd_close(y, hT, want_y, want_h, torch.bfloat16)


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


@pytest.mark.parametrize("shape", [(1, 16, 2, 8, 1, 4), (2, 300, 4, 64, 1,
                                                          128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_card_refuses_without_fallback(cuda, shape):
    """What the card once refused computes, one launch a call, against the
    plain version: float16 x, B, C (the FMA path) with a bf16 dt and A
    (cast to f32), x, B, C whose P and N axes are strided (copied once);
    S = 0 returns an empty y and the zero state with no launch."""
    x, dt, A, B, C = _ssd_inputs(shape, torch.float16, cuda, seed=7)
    dt, A = dt.bfloat16(), A.bfloat16()
    xs, Bs = (torch.empty(*t.shape, 2, dtype=t.dtype, device=cuda)[..., 0]
              .copy_(t) for t in (x, B))  # P and N strides 2
    assert xs.stride(3) == 2 and Bs.stride(3) == 2
    for args in ((x, dt, A, B, C), (xs, dt, A, Bs, C),
                 (x.float(), dt.float(), A.float(), B.float(), C.float())):
        before = ssd_ops.ssd.launches
        y, hT = ssd_ops.ssd(*args, return_state=True)
        torch.cuda.synchronize()
        assert ssd_ops.ssd.launches == before + 1
        assert y.dtype == args[0].dtype
        want_y, want_h = ssd_ref.ssd(*args, return_state=True)
        _assert_ssd_close(y, hT, want_y, want_h, y.dtype)
    before = ssd_ops.ssd.launches
    y0, h0 = ssd_ops.ssd(x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0],
                         return_state=True)
    assert ssd_ops.ssd.launches == before
    assert y0.shape == (shape[0], 0, *shape[2:4]) and y0.dtype == x.dtype
    assert h0.shape == hT.shape and h0.is_cuda and not h0.any()


def test_reduced_whisper_on_card_matches_cpu(cuda):
    """The reduced whisper-tiny on the card: every attention without a KV
    cache launches the flash kernel (forward: the encoder's layers, the
    decoder's causal self-attention and its cross-attention; prefill: the
    encoder and the cross-attention; a decode step: the cross-attention
    alone), float32 logits equal the same model on the CPU (plain
    attention) within 1e-4, and bf16 logits are finite."""
    import dataclasses
    from repro_torch.models import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("whisper-tiny", reduced=True)
    m = Model(cfg)
    params = m.init(seed=0, device="cpu", max_dec_len=64)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 40)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal(
        (2, 30, cfg.d_model)).astype(np.float32))
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(cuda), params)
    t_c, f_c = toks.to(cuda), frames.to(cuda)
    n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers

    def launched(fn):
        before = fa_ops.mha.launches
        out = fn()
        torch.cuda.synchronize()
        return out, fa_ops.mha.launches - before

    (got, _), n = launched(lambda: m.forward(on_card, t_c, frames=f_c))
    assert n == n_enc + 2 * n_dec
    want, _ = m.forward(params, toks, frames=frames)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    (lp, cache), n = launched(lambda: m.prefill(on_card, t_c[:, :32],
                                                max_len=48, frames=f_c))
    assert n == n_enc + n_dec
    (ld, cache), n = launched(lambda: m.decode_step(on_card, cache,
                                                    t_c[:, 32:33]))
    assert n == n_dec
    wp, wcache = m.prefill(params, toks[:, :32], max_len=48, frames=frames)
    wd, _ = m.decode_step(params, wcache, toks[:, 32:33])
    torch.testing.assert_close(lp.cpu(), wp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ld.cpu(), wd, rtol=1e-4, atol=1e-4)
    m16 = Model(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    (lb, _), n = launched(lambda: m16.forward(on_card, t_c, frames=f_c))
    assert n == n_enc + 2 * n_dec
    assert lb.dtype == torch.bfloat16 and bool(torch.isfinite(lb).all())


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
    (512, 2, 16, 4096, 6400, 128),  # phi3.5-moe's gate/up, cut in T
    (512, 2, 16, 6400, 4096, 128),  # ... and its down
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
@pytest.mark.parametrize("shape", [(8192, 6, 64, 2048, 1408, 128),
                                   (300, 2, 8, 256, 192, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_moe_gmm_rows_of_no_local_expert(cuda, shape, x_dtype):
    """Half the experts on this rank (a rank of an expert-split mesh, the
    first at deepseek-moe-16b's gate shape): the rows of the other half
    carry ids ≥ E.  One launch; those rows of y are exactly 0, the rest
    match the plain version; the gradient (the plain backward) is 0 on
    their x rows."""
    x, eo, w = _gmm_inputs(shape, x_dtype, torch.float32, cuda, seed=11)
    w = w[:shape[2] // 2].contiguous()
    far = eo >= w.shape[0]
    x.requires_grad_(True)
    before = gmm_ops.moe_apply.launches
    got = gmm_ops.moe_apply(x, eo, w, tile_m=shape[5])
    want = gmm_ref.gmm(x.detach(), eo, w)
    torch.cuda.synchronize()
    assert gmm_ops.moe_apply.launches == before + 1
    assert 0 < int(far.sum()) < far.numel()
    assert not got[far].any() and not want[far].any()
    rtol, atol = _gmm_tol(shape, x_dtype, want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    (gx,) = torch.autograd.grad(got.float().sum(), x)
    assert not gx[far].any() and bool(gx[~far].any())


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


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float16, torch.float32), (torch.float16, torch.bfloat16),
    (torch.float16, torch.float16), (torch.float32, torch.float16),
    (torch.bfloat16, torch.float16)])
def test_moe_gmm_card_refuses_without_fallback(cuda, x_dtype, w_dtype):
    """What the card once refused computes, one launch a call, against the
    plain version: float16 x or w (the FMA path; f16 w beside bf16 x is
    rounded to bf16 once), and a w that is not contiguous (copied once).
    Routing on another device is still refused, with nothing launched."""
    shape = (100, 2, 8, 72, 40, 48)
    x, eo, w = _gmm_inputs(shape, x_dtype, w_dtype, cuda, seed=3)
    wt = w.transpose(1, 2).contiguous().transpose(1, 2)
    assert not wt.is_contiguous()
    want = gmm_ref.gmm(x, eo, w)
    # float16 x: w rounded to f16 on both sides, sums of 72 products in
    # f32 in another order, y rounded to f16 once: 2 f16 ulps
    rtol, atol = ((2e-3, 2e-3 * float(want.float().abs().max()))
                  if x_dtype == torch.float16 else _gmm_tol(shape, x_dtype,
                                                            want))
    for ww in (w, wt):
        before = gmm_ops.moe_apply.launches
        got = gmm_ops.moe_apply(x, eo, ww, tile_m=shape[5])
        torch.cuda.synchronize()
        assert gmm_ops.moe_apply.launches == before + 1
        assert got.dtype == x_dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
    before = gmm_ops.moe_apply.launches
    with pytest.raises(ValueError, match="one device"):
        gmm_ops.moe_apply(x, eo.cpu(), w)
    assert gmm_ops.moe_apply.launches == before


def test_bf16_init_peaks_at_its_weights(cuda):
    """yi-34b at its published widths, cut to 2 layers, with bf16 weights
    (2.03e9 parameters, 4.07 GB): ``init`` on the card holds nothing but
    the finished bf16 weights, whatever order it builds them in.  Drawing
    a stack whole in f32 and scaling it into a second f32 tensor, as the
    port once did, peaks 1.76 GB higher at the last MLP stack."""
    import dataclasses
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("yi-34b"), n_layers=2,
                              param_dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = Model(cfg).init(seed=0, device=cuda)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    leaves = torch.utils._pytree.tree_leaves(params)
    weights = sum(t.numel() * t.element_size() for t in leaves)
    # slack for the caching allocator's rounding and the blocks it holds
    # beside the leaves (the card read 1 MiB over an earlier bound)
    assert peak <= weights + 2**21, (peak, weights)
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    del params


def test_decode_step_from_a_long_bf16_cache_holds_no_f32_copy(cuda):
    """Fault 23: zamba2-1.2b at its published widths, cut to its first
    segment (6 Mamba2 layers and one application of the shared block), f32
    weights and bf16 compute, decoding one row from a cache of 524,288
    positions (the JAX package's long_500k): the step peaks less than one
    float32 copy of the application's k (4.29 GB) above the weights and
    cache.  Casting the whole cache to f32, as the cached attention once
    did, holds that copy (and v's) in the step."""
    import dataclasses
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=6)
    model = Model(cfg)
    params = model.init(seed=0, device=cuda)
    T = 524_288
    with torch.inference_mode():
        cache = model.init_cache(1, T, device=cuda)
        tok = torch.ones((1, 1), dtype=torch.int32, device=cuda)
        model.decode_step(params, cache, tok)  # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        logits, _ = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    k = cache["segments"][1]["k"]
    assert k.dtype == torch.bfloat16 and k.shape[1] == T
    copy = k.numel() * 4
    print(f"[fault 23] decode step from {T} positions: peak {peak:,} B "
          f"above the resident {base:,} B; one f32 copy of k {copy:,} B")
    assert bool(torch.isfinite(logits).all())
    assert peak < copy, (peak, copy)
    del cache, params


def _mamba2_update_peak(cuda, donate: bool) -> tuple:
    """(peak above resident, bound, weights' bytes) of one AdamW update of
    mamba2-2.7b at its published widths cut to 8 layers (451 M parameters,
    1.80 GB of f32 weights; ``in_proj`` (8, 2560, 10576) its largest leaf)
    from given gradients: ``update_`` as the donating train step runs it
    (the gradients a list, each freed once applied), or the pure
    ``update``.  Resident before it: weights, moments, gradients.  The
    bound: the largest leaf's squares, which the global norm holds once as
    the pure update's norm does (its bits are kept), plus two layers of
    that leaf, plus slack for the caching allocator's rounding and its
    small blocks."""
    import dataclasses
    import torch.utils._pytree as pytree
    from repro_torch.models import Model
    from repro_torch.train import AdamW
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=8)
    params = Model(cfg).init(seed=0, device=cuda)
    opt = AdamW()
    state = opt.init(params)
    grads = pytree.tree_map(lambda p: torch.randn_like(p).mul_(1e-3), params)
    if donate:
        grads = pytree.tree_leaves(grads)
    leaves = pytree.tree_leaves(params)
    weights = sum(t.numel() * t.element_size() for t in leaves)
    largest = max(leaves, key=lambda t: t.numel())
    bound = largest.numel() * 4 + 2 * largest[0].numel() \
        * largest.element_size() + 2**21
    del leaves, largest
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = (opt.update_ if donate else opt.update)(grads, state, params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, params, state, grads
    torch.cuda.empty_cache()
    print(f"[update] mamba2-2.7b 8 layers, AdamW.update"
          f"{'_' if donate else ''}: weights {weights:,} B, resident {base:,} "
          f"B, peak above resident {peak:,} B ({peak / weights:.2f} x the "
          f"weights), bound {bound:,} B")
    return peak, bound, weights


def test_donating_update_holds_one_copy_of_the_state(cuda):
    """Fault 20: the donating update peaks within what is resident plus
    :func:`_mamba2_update_peak`'s bound."""
    peak, bound, _ = _mamba2_update_peak(cuda, donate=True)
    assert peak <= bound, (peak, bound)


def test_pure_update_holds_a_second_copy_of_the_state(cuda):
    """Fault 20's cause, and what the bound above catches: the pure update,
    which the train step ran before it donated, builds a clipped copy of
    the gradients and new moments and weights beside the resident ones,
    at least 3 x the weights' bytes more."""
    peak, bound, weights = _mamba2_update_peak(cuda, donate=False)
    assert peak >= 3 * weights > bound, (peak, weights, bound)


def _gemma_loss_head_peak(cuda, chunk: int) -> tuple:
    """(peak above resident, resident) of full-width gemma-2b's loss at
    (4, 4096) on the hidden states of its first 2 layers: with ``chunk``
    the chunked loss's forward and its backward to the hidden states and
    the tied (256000, 2048) table; with 0 the dense loss's forward alone
    (its f32 logits are 15.6 GiB, and its backward holds ~4 more copies,
    more than the card has)."""
    import dataclasses
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model, transformer
    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=2,
                              loss_chunk=chunk)
    params = Model(cfg).init(seed=0, device=cuda)
    batch = SyntheticLM(4, 4096, cfg.vocab, device=cuda).create(0)
    with torch.no_grad():
        hidden, _ = transformer.hidden_states(cfg, params, batch["tokens"])
    hidden.requires_grad_(True)
    table = params["embedding"]["embed"].detach().requires_grad_(True)
    head = {"embedding": {"embed": table}}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.enable_grad():
        if chunk:
            total = transformer._nll_chunked(cfg, head, hidden,
                                             batch["labels"])
            grads = torch.autograd.grad(total, (hidden, table))
            assert all(bool(torch.isfinite(g).all()) for g in grads)
            del grads
        else:
            total = transformer._nll_dense(cfg, head, hidden,
                                           batch["labels"])
        assert bool(torch.isfinite(total))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del total, hidden, table, head, params
    torch.cuda.empty_cache()
    what = (f"loss_chunk {chunk}, forward and backward" if chunk
            else "dense loss, forward")
    print(f"[loss] gemma-2b (4, 4096), 2 layers' hidden states, {what}"
          f": peak {peak:,} B ({peak / 2**30:.2f} GiB) above the "
          f"{base:,} B resident")
    return peak, base


def test_chunked_loss_holds_one_chunk_of_logits(cuda):
    """The chunked cross-entropy at train_4k's 4096 positions (gemma-2b,
    published widths, ``loss_chunk=512``): each chunk's logits are dropped
    by its checkpoint and recomputed in the backward, so the loss's
    forward and backward peak at most 6 f32 copies of one (4, 512, 256000)
    chunk (2.10 GB each) above what is resident, beside the table's f32
    gradient and its bf16 cast and the hidden states' gradient (17.0 GB
    in all).  Holding the 8 chunks' f32 logits for the backward alone
    would take 16.8 GB."""
    peak, _ = _gemma_loss_head_peak(cuda, 512)
    B, ck, V, D = 4, 512, 256000, 2048
    chunk_f32 = B * ck * V * 4
    bound = 6 * chunk_f32 + 2 * V * D * 4 + 2 * B * 4096 * D * 2 + 2**26
    assert peak <= bound, (peak, bound)


def test_dense_loss_holds_the_whole_logits(cuda):
    """What the chunked loss avoids: gemma-2b's dense loss at (4, 4096)
    holds at least one whole (4, 4096, 256000) f32 copy of its logits
    (15.6 GiB) in its forward alone."""
    peak, _ = _gemma_loss_head_peak(cuda, 0)
    assert peak >= 4 * 4096 * 256000 * 4, peak


def test_int8_cache_of_yi_34b_at_decode_32k_is_half(cuda):
    """yi-34b's caches at its published widths on the card, 2 slots of
    32,768 positions (the JAX package's decode_32k length): the int8 one
    (k and v in int8, an f32 scale a position and head) takes under 0.55x
    the bf16 one's bytes, as the JAX package's ``test_cache_half_size``
    asks, and so much device memory."""
    import dataclasses
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("yi-34b"), param_dtype="bfloat16")
    sizes = {}
    for quant in (False, True):
        model = Model(dataclasses.replace(cfg, kv_quant=quant))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cache = model.init_cache(2, 32768, device=cuda)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        leaves = torch.utils._pytree.tree_leaves(cache)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        assert held >= nbytes, (held, nbytes)
        if quant:
            assert {t.dtype for t in leaves} == {torch.int8, torch.float32,
                                                 torch.int32}
        sizes[quant] = nbytes
        del cache, leaves
        torch.cuda.empty_cache()
    print(f"[cache] yi-34b (2, 32768): bf16 {sizes[False]:,} B, int8 "
          f"{sizes[True]:,} B, {sizes[True] / sizes[False]:.4f}x")
    assert sizes[True] < 0.55 * sizes[False]


def test_donating_update_equals_update_on_card(cuda):
    """Three updates of reduced mamba2-2.7b's tree on the card, clipped
    hard, not at all and then slightly: ``update_`` gives ``update``'s
    parameters, moments and stats bit for bit, in its trees' storage."""
    import torch.utils._pytree as pytree
    from repro_torch.models import Model
    from repro_torch.train import AdamW, cosine_warmup
    params = Model(get_config("mamba2-2.7b", reduced=True)).init(
        seed=0, device=cuda)
    opt = AdamW(lr=cosine_warmup(3e-2, 1, 10))
    state = opt.init(params)
    p2, s2 = pytree.tree_map(torch.clone, (params, state))
    ptrs = [t.data_ptr() for t in pytree.tree_leaves((p2, s2["m"], s2["v"]))]
    g = torch.Generator(device=cuda).manual_seed(0)
    for scale in (30.0, 1e-3, 0.5):
        grads = pytree.tree_map(lambda t: torch.randn(
            t.shape, generator=g, device=cuda) * scale, params)
        params, state, stats = opt.update(grads, state, params)
        p2, s2, stats2 = opt.update_(pytree.tree_map(torch.clone, grads),
                                     s2, p2)
        for a, b in zip(pytree.tree_leaves((params, state)),
                        pytree.tree_leaves((p2, s2))):
            assert torch.equal(a, b)
        assert all(torch.equal(stats[k], stats2[k]) for k in stats)
    assert ptrs == [t.data_ptr() for t in
                    pytree.tree_leaves((p2, s2["m"], s2["v"]))]


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
    """op -> (wrapper, plain version, inputs, indices of the inputs that
    take a gradient, forward tolerance), at small shapes on the card."""
    g = torch.Generator().manual_seed(11)
    q = torch.randn(1, 4, 16, 32, generator=g).to(cuda)
    kv = torch.randn(1, 2, 16, 32, generator=g).to(cuda)
    img = torch.randn(32, 32, generator=g).to(cuda)
    x, dt, A, B, C = _ssd_inputs((1, 40, 2, 8, 1, 4), torch.float32, cuda)
    gx, eo, gw = _gmm_inputs((16, 2, 4, 32, 16, 16), torch.float32,
                             torch.float32, cuda)
    taps = st_ops.taps_of(np.arange(9.0).reshape(3, 3) / 9)
    return {
        "mha": (fa_ops.mha, fa_ref.mha, (q, kv, kv.clone()), (0, 1, 2),
                2e-5),
        "ssd": (lambda *t: ssd_ops.ssd(*t, chunk=16),
                lambda *t: ssd_ref.ssd(*t, chunk=16),
                (x, dt, A, B, C), (0, 1, 2, 3, 4), 2e-4),
        "moe_apply": (lambda a, w: gmm_ops.moe_apply(a, eo, w),
                      lambda a, w: gmm_ref.gmm(a, eo, w), (gx, gw), (0, 1),
                      2e-5),
        "stencil2d": (lambda t: st_ops.stencil2d(t, taps),
                      lambda t: st_ref.stencil2d(t, taps), (img,), (0,),
                      1e-5),
    }


_COUNTERS = {"mha": fa_ops.mha, "ssd": ssd_ops.ssd,
             "moe_apply": gmm_ops.moe_apply, "stencil2d": st_ops.stencil2d}


@pytest.mark.parametrize("op", ["mha", "ssd", "moe_apply", "stencil2d"])
def test_kernel_ops_grad_on_card(cuda, op):
    """Under grad mode the op launches its kernel once and its backward
    gives the plain version's gradients on the card (the same inputs and
    cotangent through ``torch.autograd`` of the plain version), within the
    op's forward tolerance; under no_grad it launches with no graph."""
    fn, plain, inputs, diff, tol = _grad_cases(cuda)[op]
    counter = _COUNTERS[op]
    ours = [t.clone().requires_grad_(i in diff) for i, t in
            enumerate(inputs)]
    theirs = [t.clone().requires_grad_(i in diff) for i, t in
              enumerate(inputs)]
    before = counter.launches
    out = fn(*ours)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and out.grad_fn is not None
    want = plain(*theirs)
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)
                      ).to(cuda)
    (out * cot).sum().backward()
    (want * cot).sum().backward()
    assert counter.launches == before + 1  # the backward launches nothing
    for i in diff:
        assert float(ours[i].grad.abs().max()) > 0
        torch.testing.assert_close(ours[i].grad, theirs[i].grad, rtol=tol,
                                   atol=tol)
    with torch.no_grad():
        out = fn(*ours)
    torch.cuda.synchronize()
    assert counter.launches == before + 2 and not out.requires_grad


def _train_pair(arch, device):
    """One reduced train step of ``arch`` on ``device`` from seed-0 weights
    drawn on the CPU: (new params, metrics)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.device import to_device
    from repro_torch.models import Model
    from repro_torch.train import AdamW, make_train_step
    m = Model(get_config(arch, reduced=True))
    p = to_device(m.init(seed=0, device="cpu"), device)
    opt = AdamW(lr=1e-3)
    batch = SyntheticLM(batch=4, seq=32, vocab=m.cfg.vocab,
                        device=device).create(0)
    p2, _, metrics = make_train_step(m, opt)(p, opt.init(p), batch)
    return p2, metrics


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_reduced_train_step_card_equals_cpu(cuda, arch):
    """A reduced f32 train step on the card (flash or SSD kernel forward,
    plain backward) against the same step on the CPU."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    p_gpu, m_gpu = _train_pair(arch, cuda)
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    assert launched["flash_attention" if arch == "qwen2-0.5b"
                    else "ssd_scan"] > 0
    p_cpu, m_cpu = _train_pair(arch, "cpu")
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) < 1e-4
    import torch.utils._pytree as pytree
    for a, b in zip(pytree.tree_leaves(p_gpu), pytree.tree_leaves(p_cpu)):
        assert float((a.cpu() - b).abs().max()) < 1e-4


def test_fault_tolerant_runner_on_card(cuda, tmp_path):
    """12 reduced steps on the card with failures at 4 and 9 and async
    saves: two restarts, and the clean run's parameters."""
    import torch.utils._pytree as pytree
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train import (AdamW, Checkpointer, FaultInjector,
                                   FaultTolerantRunner, make_train_step)
    m = Model(get_config("qwen2-0.5b", reduced=True))
    p = m.init(seed=0, device=cuda)
    opt = AdamW(lr=1e-3)
    src = SyntheticLM(batch=4, seq=16, vocab=m.cfg.vocab, device=cuda)
    step = make_train_step(m, opt)

    def step_fn(i, st):
        pp, oo, _ = step(st["params"], st["opt_state"], src.create(i))
        return {"params": pp, "opt_state": oo}

    state = {"params": p, "opt_state": opt.init(p)}
    runner = FaultTolerantRunner(Checkpointer(str(tmp_path),
                                              async_save=True))
    final = runner.run(total_steps=12, state=state, step_fn=step_fn,
                       save_every=3, injector=FaultInjector(fail_at=(4, 9)))
    runner.ckpt.wait()
    clean = state
    for i in range(12):
        clean = step_fn(i, clean)
    assert runner.restarts == 2
    ours = dict(pytree.tree_flatten_with_path(final["params"])[0])
    for path, leaf in pytree.tree_flatten_with_path(clean["params"])[0]:
        assert ours[path].is_cuda
        assert float((ours[path] - leaf).abs().max()) < 1e-6


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm", "ssd_scan"])
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


# -- integer stencil images: converted to float32, the float32 kernel, and
# converted back saturating as XLA does (the plain version's conversion) ----

@pytest.mark.parametrize("hw", [(256, 256), (64, 2046), (37, 2044),
                                (130, 129), (1, 1), (3, 5), (33, 136)])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.int16,
                                   torch.int32])
def test_stencil_int_images_equal_plain(cuda, hw, k, dtype):
    info = torch.iinfo(dtype)
    g = torch.Generator().manual_seed(200 + k)
    img = torch.randint(info.min, info.max, hw, generator=g,
                        dtype=torch.int64).to(dtype).to(cuda)
    taps = st_ops.taps_of(3.0 * torch.randn(k, k, generator=g))
    before = st_ops.stencil2d.launches
    got = st_ops.stencil2d(img, taps)
    want = st_ref.stencil2d(img, taps)
    torch.cuda.synchronize()
    assert st_ops.stencil2d.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)


# -- the cluster on the card -----------------------------------------------

@pytest.mark.parametrize("transport,hosts", [("device", 2), ("device", 4),
                                             ("pipe", 2)])
def test_cluster_farm_on_card_equals_sequential(cuda, transport, hosts):
    """The Mandelbrot farm over thread hosts on the card and over spawned
    host processes (each with its own CUDA context), three warm batches,
    bit-identical to the sequential oracle on the card; thread hosts launch
    the kernel once a band in this process."""
    from repro_torch import workloads
    from repro_torch.cluster import ClusterDeployment
    from repro_torch.core import run_sequential
    args = (512, 256, 16, 200)
    net = workloads.mandelbrot_factory(*args)
    seq = workloads.assemble(run_sequential(net, 16)["collect"])
    with ClusterDeployment(net, hosts=hosts, transport=transport,
                           microbatch_size=4, timeout_s=120,
                           factory=(workloads.mandelbrot_factory, args)
                           ) as dep:
        for _ in range(3):
            before = mb_ops.mandelbrot.launches
            out = dep.run(instances=16)
            img = workloads.assemble(out["collect"])
            assert np.array_equal(img, seq)
            assert mb_ops.mandelbrot.launches - before == (
                16 if transport == "device" else 0)
        assert sum(r.jit_builds for r in out.reports) == 0


def test_thread_hosts_launch_concurrently_without_losing_counts(cuda):
    """4 threads x 32 bands at once on one card: 128 launches counted and
    every band exact against the plain version."""
    import sys
    import threading
    W, band_h, iters = 1024, 32, 300
    kw = dict(x0=-2.2, y0=-1.15, pixel_delta=3.0 / W, max_iterations=iters)
    before = mb_ops.mandelbrot.launches
    results, errors = {}, []
    card = torch.cuda.current_device()

    def render(t):
        try:
            torch.cuda.set_device(card)  # as a thread host does
            for b in range(32):
                r0 = torch.tensor((t * 32 + b) * band_h, dtype=torch.int32,
                                  device=cuda)
                results[(t, b)] = (r0, mb_ops.mandelbrot(band_h, W, row0=r0,
                                                         **kw))
        except Exception as e:  # reported below, with the thread's result
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=render, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    assert mb_ops.mandelbrot.launches - before == 128
    for r0, got in results.values():
        assert torch.equal(got, mb_ref.mandelbrot(band_h, W, row0=r0, **kw))


# -- the shared-memory ring between devices -----------------------------------

def test_shm_ring_carries_cuda_bf16_leaves(cuda):
    """CUDA bf16 tensors (a 0-d one and a strided view among them) through
    the ring: written from the card into a slot, rebuilt on the consumer
    endpoint's device with the same bits, writable, and not aliasing the
    slot; the oversize chunk ships inline, counted, onto the card too."""
    from repro_torch.cluster import SharedMemoryRing
    chan = ("a", "b")
    t = SharedMemoryRing(slot_bytes=1 << 16)
    t.setup([chan], {chan: 2})
    try:
        consumer = t.endpoint(1)
        consumer.device = cuda
        g = torch.Generator().manual_seed(9)
        val = {"x": torch.randn(64, 96, generator=g).bfloat16().to(cuda),
               "s": torch.tensor(3.25, dtype=torch.bfloat16, device=cuda),
               "i": torch.arange(7, dtype=torch.int32, device=cuda)}
        val["xt"] = val["x"].t()
        t.send(chan, 0, val)
        got = consumer.recv(chan, 0)
        for key, want in val.items():
            assert got[key].device == want.device
            assert got[key].dtype == want.dtype
            assert got[key].shape == want.shape
            assert torch.equal(got[key], want)
        got["x"].add_(1)  # writable, and another chunk through the same
        t.send(chan, 1, {"x": torch.zeros_like(val["x"])})  # slots ...
        consumer.recv(chan, 1)
        assert torch.equal(got["x"], val["x"] + 1)  # ... leaves it alone
        big = torch.randn(300, 300, generator=g).bfloat16().to(cuda)
        t.send(chan, 2, big)
        assert torch.equal(consumer.recv(chan, 2), big)
        assert t.ring_counts() == {chan: (2, 1)}
    finally:
        t.close()
    assert not t.owned_names()


# -- durable deployments and serving on the card -----------------------------

_CARD_TRIP: dict = {}  # module-level: the adopting controller rebuilds it


def _card_farm(args, trip_at):
    """The Mandelbrot farm whose host-side Collect raises once, on its
    ``trip_at``-th item (past the fold snapshots of the batch)."""
    from repro_torch import workloads
    net = workloads.mandelbrot_factory(*args)
    coll = net.procs["collect"]
    fold = coll.fn

    def once(acc, item):
        _CARD_TRIP["n"] = _CARD_TRIP.get("n", 0) + 1
        if _CARD_TRIP["n"] == trip_at:
            raise RuntimeError("transient collector failure (injected)")
        return fold(acc, item)

    coll.fn = once
    return net


def test_durable_farm_on_card_snapshot_fail_recover_adopt(cuda, tmp_path):
    """Over ``device`` hosts: the Collect fails in chunk 6 of 8, recover()
    replays it from its chunk-6 fold snapshot (the renderer re-launching
    only the 4 bands after it), then the closed deployment is adopted
    fresh — each result equal to the single-host run."""
    from repro_torch import workloads
    from repro_torch.cluster import (ClusterDeployment, ClusterError,
                                     DeploymentStore)
    from repro_torch.core import run_sequential
    args = (512, 256, 16, 200)
    seq = workloads.assemble(run_sequential(
        workloads.mandelbrot_factory(*args), 16)["collect"])
    d = str(tmp_path)
    _CARD_TRIP.clear()
    try:
        dep = ClusterDeployment(_card_farm(args, 13), hosts=2,
                                transport="device", microbatch_size=2,
                                snapshot_every=2, snapshot_dir=d,
                                timeout_s=120)
        with dep:
            with pytest.raises(ClusterError):
                dep.run(instances=16)
            coll = dep.plan.assignment["collect"]
            snap = DeploymentStore(d).load_host_snapshot(coll)
            assert snap is not None and snap["next_ci"] == 6
            before = mb_ops.mandelbrot.launches
            rec = dep.recover()
            torch.cuda.synchronize()
            assert mb_ops.mandelbrot.launches - before == 16 - 2 * 6
            assert np.array_equal(workloads.assemble(rec["collect"]), seq)
            assert dep.events[-1].replay_from[coll] == 6
        with ClusterDeployment.adopt(
                d, factory=(_card_farm, (args, 0)),
                transport="device") as dep2:
            assert dep2.epoch == 3 and dep2.events[-1].refined is True
            out = dep2.run(instances=16)
            assert np.array_equal(workloads.assemble(out["collect"]), seq)
    finally:
        _CARD_TRIP.clear()


def test_snapshot_and_serving_state_hold_no_cuda_tensor(cuda, tmp_path):
    """The launcher's farm folds a device scalar (``jit_combine``): its
    host snapshot, unpickled, holds CPU tensors only, and a stream resumed
    from it puts the fold back on the card and ends at the oracle.  A
    serving engine's persisted state holds no CUDA tensor either."""
    import pickle
    from repro_torch.cluster import ClusterDeployment, DeploymentStore
    from repro_torch.cluster.durable import _from_blob
    from repro_torch.core import build, run_sequential
    from repro_torch.core.builder import make_emit_batch
    from repro_torch.core.stream import StreamExecutor
    from repro_torch.launch.cluster import make_mandelbrot
    from repro_torch.serve import (LocalDecodeBackend, Request, ServeEngine,
                                   build_decode_model)
    args = (16, 256, 256, 300)
    seq = run_sequential(make_mandelbrot(*args), 16)["collect"]
    with ClusterDeployment(factory=(make_mandelbrot, args), hosts=2,
                           transport="device", microbatch_size=2,
                           snapshot_every=2, snapshot_dir=str(tmp_path)
                           ) as dep:
        assert torch.equal(dep.run(instances=16)["collect"], seq)
        coll = dep.plan.assignment["collect"]
    snap = DeploymentStore(str(tmp_path)).load_host_snapshot(coll)
    leaves = torch.utils._pytree.tree_leaves(snap)
    assert any(isinstance(l, torch.Tensor) for l in leaves)
    assert not any(isinstance(l, torch.Tensor) and l.is_cuda for l in leaves)
    net = make_mandelbrot(*args)
    ex = StreamExecutor(build(net, device=cuda), microbatch_size=2)
    ex.snapshot_tag = (snap["batch_id"], snap["epoch"])
    out = ex.resume_from_state(snap, make_emit_batch(net, 16, device=cuda))
    assert out["collect"].is_cuda and torch.equal(out["collect"], seq)

    model, params = build_decode_model(("toy", 32, 8), device=cuda)
    store = DeploymentStore(str(tmp_path / "serve"))
    eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=2,
                                         max_len=16), store=store)
    eng.submit(Request(rid=0, prompt=(3, 4, 5), max_new=4))
    eng.step()
    state = eng._state()
    assert not any(isinstance(l, torch.Tensor) and l.is_cuda
                   for l in torch.utils._pytree.tree_leaves(state))
    blob = store.serve_checkpointer()
    _, tree = blob.restore({"blob": np.zeros((0,), np.uint8)}, device="cpu")
    assert _from_blob(tree)["steps_run"] == 1
    pickle.loads(pickle.dumps(state))  # no device in the pickle


def test_durable_serving_on_card_answers_once_with_uncrashed_tokens(
        cuda, tmp_path):
    """A reduced qwen2 on the card: the engine with a store crashes with
    two requests done and two in flight; a new engine adopting the store
    on a fresh backend answers every request exactly once, with the tokens
    of an uncrashed engine without a store."""
    from repro_torch.cluster import DeploymentStore
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import (LocalDecodeBackend, ServeEngine,
                                   build_decode_model)
    torch.backends.cuda.matmul.allow_tf32 = False
    model, params = build_decode_model(("model", "qwen2-0.5b", True),
                                       device=cuda)
    reqs = launcher.requests(6, model.cfg.vocab, 8)

    def backend():
        return LocalDecodeBackend(model, params, n_slots=3, max_len=32)

    plain = ServeEngine(backend())
    for r in reqs:
        plain.submit(r)
    plain.run_until_drained()
    eng = ServeEngine(backend(), store=DeploymentStore(str(tmp_path)))
    for r in reqs:
        eng.submit(r)
    while len(eng.completed) < 2 or len(eng._live) < 2:
        assert eng.step()
    del eng  # the crash
    eng2 = ServeEngine.adopt(backend(), DeploymentStore(str(tmp_path)))
    assert next(iter(torch.utils._pytree.tree_leaves(
        eng2.backend.cache))).is_cuda
    eng2.run_until_drained()
    answered = [r.rid for r in eng2.completed]
    assert sorted(answered) == [r.rid for r in reqs]
    for r in reqs:
        assert eng2.poll(r.rid).tokens == plain.poll(r.rid).tokens


# -- the fault-injection simulator on the card -------------------------------

def test_sim_scenario_on_card(cuda):
    """A seeded double kill over simulated hosts on the card: every
    invariant of the scenario holds, the oracle on the card too."""
    from repro_torch.cluster import sim
    r = sim.run_scenario(2)
    assert r.ok, r.failures
    assert r.kind == "double-kill" and r.recoveries >= 1


def test_sim_controller_crash_on_card(cuda):
    """A controller crash mid-batch, adopted with its hosts salvaged and
    the batch replayed from the Collect's fold snapshot, on the card."""
    from repro_torch.cluster import sim
    r = sim.run_kill_controller_scenario(7, variant="midbatch")
    assert r.ok, r.failures
    assert r.fired == 1 and r.recoveries >= 2


def test_sim_mandelbrot_farm_on_card_survives_a_seeded_kill(cuda):
    """The Mandelbrot farm (512 x 256, 8 bands) over 2 simulated hosts on
    the card under a seeded kill: every batch equal to the sequential run
    on the card, the kernel launched in the simulated hosts (threads of
    this process) at least once a band a batch."""
    import random
    from repro_torch import workloads
    from repro_torch.cluster import partition
    from repro_torch.cluster.sim import FaultSchedule, drive_scenario
    from repro_torch.core import run_sequential
    args = (512, 256, 8, 200)
    seq = workloads.assemble(run_sequential(
        workloads.mandelbrot_factory(*args), 8)["collect"])
    plan = partition(workloads.mandelbrot_factory(*args), hosts=2)
    seed = next(s for s in range(100) if FaultSchedule.random(
        random.Random(s), plan).kind == "kill")
    sched = FaultSchedule.random(random.Random(seed), plan)
    before = mb_ops.mandelbrot.launches
    run = drive_scenario(
        workloads.mandelbrot_factory(*args),
        (workloads.mandelbrot_factory, args), plan, sched, "restart",
        instances=8, microbatch_size=2, timeout_s=120,
        check=lambda out: None if np.array_equal(
            workloads.assemble(out["collect"]), seq) else "differs")
    torch.cuda.synchronize()
    assert not run.failures, run.failures
    assert len(run.outs) == 3 and sched.events[0].fired and run.events
    assert mb_ops.mandelbrot.launches - before >= 3 * 8


# -- the cost model and the autoscaler on the card ---------------------------

def test_calibrate_on_card_measures_every_stage(cuda):
    """``calibrate`` of the Mandelbrot farm (512 x 256, 8 bands) on the
    card: the render stage and the Collect measured, the kernel launched
    by the calibration, every bandwidth positive, and a cost cut that
    refines the network."""
    from repro_torch import workloads
    from repro_torch.cluster import (calibrate, check_refinement,
                                     cost_assignment, partition)
    net = workloads.mandelbrot_factory(512, 256, 8, 200)
    before = mb_ops.mandelbrot.launches
    prof = calibrate(net, instances=8, microbatch_size=2,
                     transports=("device", "pipe", "shm"))
    assert mb_ops.mandelbrot.launches > before
    assert set(prof.costs) == {"group"}  # its Collect folds on the host
    for c in prof.costs.values():
        assert c.source == "measured" and c.wall_s > 0 and c.out_bytes > 0
    assert prof.costs["group"].out_bytes == 2 * 4 + 2 * 32 * 512 * 4
    assert all(bw > 0 for bw in prof.bandwidths.values())
    assert set(prof.bandwidths) == {"device", "pipe", "shm"}
    plan = partition(net, assignment=cost_assignment(net, 2, prof,
                                                     transport="device"))
    assert check_refinement(net, plan)


@pytest.mark.parametrize("kind", ["spike", "straggler", "slow-start"])
def test_workload_scenario_on_card(cuda, kind):
    """One workload scenario of each kind over simulated hosts on the
    card: a spike scales out, a straggler is migrated away, a slow start
    causes no action, every batch equal to the oracle on the card."""
    from repro_torch.cluster import sim
    r = sim.run_workload_scenario(0, kind=kind)
    assert r.ok, r.failures
    assert r.recoveries == (0 if kind == "slow-start" else 1)


# -- the clustered decode farm on the card ------------------------------------

def test_reduced_farm_on_card_equals_local_two_slot_engine(cuda):
    """The reduced qwen2-0.5b (float32) farm over 2 ``device`` hosts on the
    card, 4 slots in shards of 2 rows, scaled to 3 hosts after the first
    step: every request's tokens equal a local engine of 2 slots (the
    shards' decode shape) on the same weights, every event refined."""
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import (ClusterDecodeBackend, LocalDecodeBackend,
                                   ServeEngine, build_decode_model)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = ("model", "qwen2-0.5b", True)
    model, params = build_decode_model(spec, device=cuda)
    reqs = launcher.requests(6, model.cfg.vocab, 8)
    eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=2,
                                         max_len=32))
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    want = {r.rid: eng.poll(r.rid).tokens for r in reqs}
    be = ClusterDecodeBackend(spec, n_slots=4, shards=2, hosts=2,
                              transport="device", max_len=32)
    try:
        assert all(l.is_cuda for c in be.shard_cache
                   for l in torch.utils._pytree.tree_leaves(c))
        eng = ServeEngine(be)
        for r in reqs[:3]:
            eng.submit(r)
        eng.step()
        ev = be.scale(3)
        assert ev.mode == "reconfigure" and ev.refined is True
        for r in reqs[3:]:
            eng.submit(r)
        eng.run_until_drained()
        assert all(e.refined is True for e in be.dep.events)
        got = {r.rid: eng.poll(r.rid).tokens for r in reqs}
    finally:
        be.close()
    assert got == want


def test_serve_kill_scenario_on_card(cuda):
    """One seeded kill under a live engine over simulated hosts on the
    card: every request answered once, equal to the one-slot oracle."""
    from repro_torch.cluster import sim
    r = sim.run_serve_kill_scenario(1)
    assert r.ok, r.describe()
    assert r.fired >= 1 and r.recoveries >= 1


# -- the mesh: 2 ranks sharing the card ----------------------------------------

@pytest.fixture(scope="module")
def card_world():
    """One world of 2 ranks on ``cuda:0`` (the host-staged gloo backend:
    NCCL refuses two ranks on one GPU) for every mesh check below; it
    leaves no rank process behind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    import multiprocessing

    import _torch_dist_worlds as worlds
    from repro_torch.launch.mesh import run_world
    res = run_world(worlds.gpu_world, 2, device="cuda", timeout=120)
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("rank")]
    return res


def test_mesh_farm_on_card_equals_one_device(card_world):
    """The Mandelbrot farm's 8 bands over 2 ranks: the one-device image,
    4 launches on each rank."""
    assert all(r["farm"] == (True, 4) for r in card_world)


def test_mesh_stencil_halo_on_card_equals_one_device(card_world):
    """EDGE5 with a 2-row halo from each neighbour: one launch an image on
    each rank, equal to the one-device image."""
    assert all(r["stencil"] == (True, 2) for r in card_world)


def test_mesh_tp_step_on_card_equals_cpu(card_world):
    """Reduced qwen2 (f32) on a (1, 2) mesh on the card, heads split over
    the ranks: loss and gradients within 1e-4 of the CPU's, flash
    launched once a layer on each rank."""
    for r in card_world:
        loss_err, grad_err, flash, layers = r["tp"]
        assert loss_err < 1e-4 and grad_err < 1e-4, r["tp"]
        assert flash == layers, r["tp"]


def test_mesh_ragged_moe_train_step_on_card_equals_cpu(card_world):
    """The reduced deepseek's ragged MoE path (f32) on a (1, 2) mesh on
    the card, 2 of its 4 experts a rank: loss and gradients within 1e-4
    of one CPU device, and every grouped matmul of the forward a kernel
    launch on each rank (3 a MoE layer; the backward is the plain one)."""
    for r in card_world:
        loss_err, grad_err, gmm, want = r["ragged_train"]
        assert loss_err < 1e-4 and grad_err < 1e-4, r["ragged_train"]
        assert gmm == want > 0, r["ragged_train"]


def test_mesh_ragged_moe_decode_on_card_equals_cpu(card_world):
    """Prefill and 4 decode steps of the reduced deepseek's ragged path
    under serve_rules() on (1, 2), the caches' positions and the experts
    split over the ranks: f32 logits within 1e-5 of one CPU device, and
    3 grouped-matmul launches a MoE layer a step on each rank."""
    for r in card_world:
        err, gmm, want = r["ragged_decode"]
        assert err < 1e-5 and gmm == want > 0, r["ragged_decode"]


def test_mesh_mha_selects_kv_heads_on_card(card_world):
    """6 query heads over 2 ranks with 3 KV heads, which 2 does not
    divide: each rank launches flash once on its 3 heads and their KV
    heads; the output and the gradients of q, k and v (k's and v's summed
    over the ranks) within 1e-4 of the CPU's."""
    for r in card_world:
        errs, flash = r["mha_select"]
        assert max(errs) < 1e-4 and flash == 1, r["mha_select"]


def test_mesh_ring_and_pipeline_on_card(card_world):
    """The int8 ring's two gates over 2 ranks; GPipe over 2 stages equal
    to the layers applied in order to each microbatch."""
    for r in card_world:
        rel1, rel2 = r["ring"]
        assert rel1 < 0.05 and rel2 < rel1, r["ring"]
        assert r["pipeline_err"] == 0.0, r["pipeline_err"]


# -- the dry-run's fake path on the card (phase 20) ----------------------------

@pytest.mark.parametrize("op", ["mha", "ssd", "moe_apply"])
def test_kernel_ops_on_fake_cuda_tensors_launch_nothing_on_card(cuda, op):
    """On the card's host, fake CUDA tensors take each op's fake rule:
    the output's shape, dtype and device, no launch, no device byte."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import launch_counts
    torch.cuda.synchronize()
    before, allocated = launch_counts(), torch.cuda.memory_allocated()
    with FakeTensorMode():
        if op == "mha":
            q = torch.empty(4, 14, 2048, 64, dtype=torch.bfloat16,
                            device=cuda)
            k = torch.empty(4, 2, 2048, 64, dtype=torch.bfloat16,
                            device=cuda)
            outs, want = [fa_ops.mha(q, k, k)], [((4, 14, 2048, 64),
                                                  torch.bfloat16)]
        elif op == "ssd":
            x = torch.empty(2, 256, 8, 64, device=cuda)
            dt = torch.empty(2, 256, 8, device=cuda)
            B = torch.empty(2, 256, 1, 128, device=cuda)
            outs = list(ssd_ops.ssd(x, dt, torch.empty(8, device=cuda), B, B,
                                    return_state=True))
            want = [((2, 256, 8, 64), torch.float32),
                    ((16, 128, 64), torch.float32)]
        else:
            x = torch.empty(300, 64, dtype=torch.bfloat16, device=cuda)
            outs = [gmm_ops.moe_apply(x, torch.zeros(300, dtype=torch.int64,
                                                     device=cuda),
                                      torch.empty(4, 64, 96, device=cuda))]
            want = [((300, 96), torch.bfloat16)]
        got = [(tuple(t.shape), t.dtype) for t in outs]
        assert all(t.device.type == "cuda" for t in outs)
    torch.cuda.synchronize()
    assert got == want
    assert launch_counts() == before
    assert torch.cuda.memory_allocated() == allocated


def test_flash_tensor_core_rule_equals_the_kernels(cuda):
    """The fake rule's tensor-core choice (Python) equals the C code's."""
    from repro_torch.kernels.flash_attention import kernel
    assert kernel.tensor_core_path(torch.bfloat16, 256)
    assert not kernel.tensor_core_path(torch.float16, 256)
    for dtype in kernel.DTYPES:
        for d in kernel.HEAD_DIMS:
            assert kernel.tensor_core_rule(dtype, d) == \
                kernel.tensor_core_path(dtype, d), (dtype, d)


@pytest.mark.parametrize("cell", [("qwen2-0.5b", "train_4k"),
                                  ("zamba2-1.2b", "long_500k")])
def test_dryrun_reduced_cells_on_card(cuda, cell, monkeypatch):
    """On the card's host the dry-run traces with fake CUDA tensors: two
    reduced cells give the record that fake CPU tensors standing for the
    card's give on the same host (the representation a host without CUDA
    takes), with no launch and no device byte, and the argument and output
    bytes a host without a card gives (``tests/_torch_dryrun_records.py``;
    the other numbers follow the host's ``DTensor`` rules).  Only the
    unfused traffic may differ between the two representations, by 1e-3
    of it: some aten ops decompose differently for CUDA and CPU tensors
    (the train cell read 134,217,728 B of 1.47e12 apart)."""
    import gc

    import _torch_dryrun_records as records
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import dryrun
    assert dryrun._trace_device("cuda")[0].type == "cuda"
    gc.collect()  # earlier tests' cyclic garbage is not the trace's to free
    before, allocated = launch_counts(), torch.cuda.memory_allocated()
    got = records.reduced_record(*cell)
    assert launch_counts() == before
    assert torch.cuda.memory_allocated() == allocated
    want = records.REDUCED_CELLS[cell]["mem"]
    for key in ("argument_bytes", "output_bytes"):
        assert got["mem"][key] == want[key], key
    monkeypatch.setattr(dryrun, "_trace_device",
                        lambda device: (torch.device("cpu"), True))
    cpu = records.reduced_record(*cell)
    b_cpu, b_cuda = cpu.pop("bytes_per_dev"), got.pop("bytes_per_dev")
    assert abs(b_cpu - b_cuda) <= 1e-3 * b_cuda
    assert cpu == got
