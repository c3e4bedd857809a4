"""The kernel ops' gradient helper, on the CPU.

:func:`repro_torch.kernels._autograd.launch` runs a kernel forward and the
plain version's backward.  A CUDA kernel cuts the autograd graph: its
output has no ``grad_fn``.  Here a stand-in "kernel" computes the plain
result under ``torch.no_grad()``, which cuts the graph the same way, and
counts its calls, so the helper is held on the CPU to what it must give on
the card: the plain version's gradients for every input that asks for one
(several outputs, non-tensor arguments, integer tensors and inputs that do
not require grad included), the kernel called once a forward, and a bare
call with no graph under ``no_grad`` and ``inference_mode``.
"""

import pytest
import torch

from repro_torch.kernels import _autograd


def _stand_in(plain):
    """(kernel, calls): ``plain`` under no_grad, as a launch cuts the
    graph."""
    calls = []

    def kernel(*args, **kw):
        calls.append(1)
        with torch.no_grad():
            return plain(*args, **kw)

    return kernel, calls


def _plain_one(x, idx, w, *, scale):
    return (x * scale) @ w[idx.long()].sum(0) + torch.sin(x).sum()


def _plain_two(a, b, *, k):
    return a * b + k, (a ** 2).sum(-1)


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(5, 3, generator=g),
            torch.tensor([0, 2, 2], dtype=torch.int32),
            torch.randn(4, 3, 6, generator=g))


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)],
                         ids=["both", "x-only", "w-only"])
def test_grads_equal_the_plain_versions(needs):
    kernel, calls = _stand_in(_plain_one)
    x, idx, w = _inputs()
    ours = [t.clone().requires_grad_(n) for t, n in zip((x, w), needs)]
    theirs = [t.clone().requires_grad_(n) for t, n in zip((x, w), needs)]
    out = _autograd.launch(kernel, _plain_one, ours[0], idx, ours[1],
                           scale=0.5)
    assert calls == [1] and out.grad_fn is not None
    want = _plain_one(theirs[0], idx, theirs[1], scale=0.5)
    torch.testing.assert_close(out, want)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (out * cot).sum().backward()
    (want * cot).sum().backward()
    assert calls == [1]  # the backward runs the plain version, no launch
    for o, t, n in zip(ours, theirs, needs):
        if n:
            torch.testing.assert_close(o.grad, t.grad, rtol=0, atol=0)
        else:
            assert o.grad is None


def test_two_outputs_and_an_unused_one():
    kernel, calls = _stand_in(_plain_two)
    g = torch.Generator().manual_seed(3)
    a0, b0 = torch.randn(3, 4, generator=g), torch.randn(3, 4, generator=g)
    a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    ra, rb = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    y, s = _autograd.launch(kernel, _plain_two, a, b, k=2.0)
    wy, ws = _plain_two(ra, rb, k=2.0)
    (y.sum() + 3 * s.sum()).backward()
    (wy.sum() + 3 * ws.sum()).backward()
    torch.testing.assert_close(a.grad, ra.grad, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, rb.grad, rtol=0, atol=0)
    # only the first output reaches the loss: the second's grad is zero
    a.grad = b.grad = None
    y, s = _autograd.launch(kernel, _plain_two, a, b, k=2.0)
    y.pow(2).sum().backward()
    torch.testing.assert_close(b.grad, 2 * (a0 * b0 + 2.0) * a0)
    assert calls == [1, 1]


def test_gradient_keeps_a_strided_inputs_shape():
    """A kernel that writes in its input's layout (the flash op on the
    model's (B, S, H, D) view): the gradient comes back in that shape."""
    def plain(q):
        return q * 2.0

    kernel, _ = _stand_in(plain)
    base = torch.randn(2, 5, 3, 4, requires_grad=True)
    q = base.transpose(1, 2)  # (B, H, S, D) view of (B, S, H, D)
    out = _autograd.launch(kernel, plain, q)
    out.transpose(1, 2).sum().backward()
    assert base.grad.shape == base.shape
    torch.testing.assert_close(base.grad, torch.full_like(base, 2.0))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "no-input-requires-grad"])
def test_bare_call_without_a_gradient(mode):
    kernel, calls = _stand_in(_plain_one)
    x, idx, w = _inputs()
    if mode == "no-input-requires-grad":
        out = _autograd.launch(kernel, _plain_one, x, idx, w, scale=1.0)
    else:
        ctx = torch.no_grad() if mode == "no_grad" else \
            torch.inference_mode()
        with ctx:
            out = _autograd.launch(kernel, _plain_one,
                                   x.requires_grad_(), idx, w, scale=1.0)
    assert calls == [1] and out.grad_fn is None and not out.requires_grad
