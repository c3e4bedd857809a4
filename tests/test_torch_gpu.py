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
@pytest.mark.parametrize("k", [3, 5])
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
    img = torch.zeros(64, 64, device=cuda)
    before = st_ops.stencil2d.launches
    with pytest.raises(ValueError, match="contiguous"):
        st_ops.stencil2d(img.t(), np.ones((3, 3)))
    with pytest.raises(ValueError, match="k in"):
        st_ops.stencil2d(img, np.ones((7, 7)))
    assert st_ops.stencil2d.launches == before


# -- flash attention: 2e-4 in float32, 5e-2 in bfloat16 (the plain version
# rounds its probabilities to bf16 before the PV product, the kernel keeps
# them in f32) -----------------------------------------------------------------

FLASH_SHAPES = [  # (B, H, K, Sq, Sk, D)
    (4, 14, 2, 2048, 2048, 64),  # the qwen2-0.5b forward: GQA group of 7
    (1, 4, 2, 64, 64, 32), (2, 8, 1, 96, 96, 64), (2, 4, 4, 128, 128, 32),
    (1, 2, 2, 33, 33, 16),       # ragged
    (2, 4, 2, 1, 80, 32),        # decode: Sq = 1
    (1, 8, 1, 100, 100, 128), (1, 8, 1, 70, 70, 256),
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
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
