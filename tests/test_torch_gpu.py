"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit, and skips without
them.  The file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

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
