"""The port's SSD scan against the JAX package's, on the CPU.

The same numpy-seeded x, dt, A, B, C go through the JAX oracles
(``ssd_naive``, ``ssd_chunked``), its Pallas ``ssd_scan`` in interpret mode
and its public ``ssd`` op, and through the port's plain versions and its
wrapper, which on a CPU tensor runs the plain version of the CUDA kernel.
The tolerance is the reference's own (``tests/test_kernels.py``): rtol
1e-4, atol 1e-5.  The CUDA kernel itself is held against the plain version
on the card by ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jops, ref as jref
from repro.kernels.ssd_scan.kernel import ssd_scan as jssd_scan
from repro_torch.kernels.ssd_scan import ops, ref

RTOL, ATOL = 1e-4, 1e-5


def _folded(rng, BH, S, P, N, dt_scale=0.1):
    """The reference tests' inputs: (BH, S, ·) with negative A."""
    x = rng.normal(size=(BH, S, P)).astype(np.float32)
    dt = (rng.random((BH, S)) * dt_scale).astype(np.float32)
    A = (-rng.random(BH) - 0.1).astype(np.float32)
    B = (rng.normal(size=(BH, S, N)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(BH, S, N)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _heads(rng, b, S, H, P, G, N):
    """The public op's inputs: (batch, S, H, ·) and (batch, S, G, N)."""
    x = rng.normal(size=(b, S, H, P)).astype(np.float32)
    dt = (rng.random((b, S, H)) * 0.2).astype(np.float32)
    A = (-rng.random(H) - 0.1).astype(np.float32)
    B = (rng.normal(size=(b, S, G, N)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(ours, theirs, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(theirs, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_and_naive_match_jax(chunk):
    """S = 64 crosses chunks, so the state is carried; y and hT."""
    args = _folded(np.random.default_rng(chunk), 2, 64, 8, 4)
    jy0, jh0 = jref.ssd_naive(*_j(*args))
    y0, h0 = ref.ssd_naive(*_t(*args))
    y1, h1 = ref.ssd_chunked(*_t(*args), chunk=chunk)
    for y, h in ((y0, h0), (y1, h1)):
        _close(y, jy0)
        _close(h, jh0)
    jy1, jh1 = jref.ssd_chunked(*_j(*args), chunk=chunk)
    _close(y1, jy1)
    _close(h1, jh1)


@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_matches_jax_pallas_interpret(chunk):
    x, dt, A, B, C = _folded(np.random.default_rng(7 + chunk), 2, 64, 8, 4)
    jy = jssd_scan(*_j(x, dt), jnp.asarray(dt * A[:, None]), *_j(B, C),
                   chunk=chunk, interpret=True)
    y, _ = ref.ssd_chunked(*_t(x, dt, A, B, C), chunk=chunk)
    _close(y, jy)


@pytest.mark.parametrize("S", [32, 33, 48], ids=["S32", "ragged33", "S48"])
@pytest.mark.parametrize("groups", ["G1", "GH"])
@pytest.mark.parametrize("return_state", [False, True])
def test_ops_matches_jax_ops(S, groups, return_state):
    """The public op on CPU tensors: head folding, group broadcast, the
    one-chunk rule for a ragged S, with and without the final state."""
    H = 4
    G = 1 if groups == "G1" else H
    x, dt, A, B, C = _heads(np.random.default_rng(S + G), 2, S, H, 16, G, 8)
    ours = ops.ssd(*_t(x, dt, A, B, C), chunk=16, return_state=return_state)
    theirs = jops.ssd(*_j(x, dt, A, B, C), chunk=16,
                      return_state=return_state)
    if return_state:
        _close(ours[0], theirs[0])
        _close(ours[1], theirs[1])
        assert ours[1].shape == (2 * H, 8, 16)
        assert ours[1].dtype == torch.float32
    else:
        assert ours.shape == (2, S, H, 16)
        _close(ours, theirs)


@pytest.mark.parametrize("groups", ["G1", "GH"])
def test_ops_matches_jax_pallas_path(groups):
    """The JAX op with its Pallas kernel (interpret mode) computes what the
    port's op computes on the CPU."""
    H = 4
    G = 1 if groups == "G1" else H
    args = _heads(np.random.default_rng(3), 2, 64, H, 16, G, 16)
    ours = ops.ssd(*_t(*args), chunk=16)
    theirs = jops.ssd(*_j(*args), chunk=16, use_pallas=True, interpret=True)
    _close(ours, theirs)


def test_ops_groups_between_one_and_heads():
    """G | H with 1 < G < H: head h reads group h // (H // G), which is the
    G = H op on B and C repeated over each group's heads."""
    H, G = 4, 2
    x, dt, A, B, C = _t(*_heads(np.random.default_rng(5), 1, 32, H, 8, G, 4))
    got = ops.ssd(x, dt, A, B, C, chunk=16)
    want = ops.ssd(x, dt, A, B.repeat_interleave(2, dim=2),
                   C.repeat_interleave(2, dim=2), chunk=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_decode_steps_reproduce_the_scan():
    """Recurrent decode, step by step, gives the scan's y and final state
    (the port's and the JAX package's decode step alike)."""
    x, dt, A, B, C = _folded(np.random.default_rng(11), 2, 40, 8, 4,
                             dt_scale=0.2)
    y_scan, h_scan = ref.ssd_chunked(*_t(x, dt, A, B, C), chunk=8)
    h = torch.zeros(2, 4, 8)
    jh = jnp.zeros((2, 4, 8))
    for t in range(x.shape[1]):
        step = (x[:, t], dt[:, t], A, B[:, t], C[:, t])
        y_t, h = ref.ssd_decode_step(h, *_t(*step))
        jy_t, jh = jref.ssd_decode_step(jh, *_j(*step))
        _close(y_t, y_scan[:, t])
        _close(y_t, jy_t)
    _close(h, h_scan)
    _close(h, jh)


def test_large_decays_give_no_nan():
    """|dt·A| large enough that exp(cum_t - cum_s) above the diagonal
    overflows to inf: the masked weights stay zero, not NaN."""
    rng = np.random.default_rng(13)
    x, _, _, B, C = _folded(rng, 2, 64, 8, 4)
    dt = (rng.random((2, 64)) * 20 + 10).astype(np.float32)
    A = np.full(2, -20.0, np.float32)  # a = dt·A down to -600 per step
    y, h = ref.ssd_chunked(*_t(x, dt, A, B, C), chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    y0, h0 = ref.ssd_naive(*_t(x, dt, A, B, C))
    _close(y, y0)
    _close(h, h0)
    jy, _ = jref.ssd_chunked(*_j(x, dt, A, B, C), chunk=32)
    _close(y, jy)


def test_large_decays_give_finite_gradients():
    """Full-width mamba2's decays (dt 0.1 and A = -16 span 102 in a chunk
    of 64, past f32's exp range): the chunked version's gradients with
    respect to every input are finite and equal the naive scan's, in the
    port and in the JAX package (whose chunked version's are NaN there:
    it exponentiates before it masks)."""
    rng = np.random.default_rng(19)
    x, _, _, B, C = _folded(rng, 2, 128, 8, 16)
    dt = np.full((2, 128), 0.1, np.float32)
    A = np.array([-16.0, -1.0], np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def grads(fn):
        leaves = [t.requires_grad_() for t in _t(x, dt, A, B, C)]
        y, h = fn(*leaves)
        return torch.autograd.grad((y * torch.from_numpy(w)).sum()
                                   + h.sum(), leaves)

    ours = grads(lambda *a: ref.ssd_chunked(*a, chunk=64))
    naive = grads(ref.ssd_naive)
    jnaive = jax.grad(lambda *a: jnp.sum(jref.ssd_naive(*a)[0] * w)
                      + jnp.sum(jref.ssd_naive(*a)[1]),
                      argnums=(0, 1, 2, 3, 4))(*_j(x, dt, A, B, C))
    for g, g0, jg in zip(ours, naive, jnaive):
        assert torch.isfinite(g).all()
        _close(g.detach(), g0.detach())
        _close(g.detach(), jg)


def test_bf16_inputs_round_only_y():
    """bf16 x, B, C: the sums run in f32 and y is rounded to bf16 once, as
    in the JAX oracle; the state stays f32."""
    args = _heads(np.random.default_rng(17), 1, 32, 2, 16, 1, 16)
    x, dt, A, B, C = _t(*args)
    y, hT = ops.ssd(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(),
                    chunk=16, return_state=True)
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    jy, jh = jops.ssd(jnp.asarray(args[0], jnp.bfloat16), *_j(*args[1:3]),
                      jnp.asarray(args[3], jnp.bfloat16),
                      jnp.asarray(args[4], jnp.bfloat16), chunk=16,
                      return_state=True)
    _close(y.float(), np.asarray(jy, np.float32), rtol=1e-2, atol=1e-2)
    _close(hT, jh, rtol=1e-4, atol=1e-4)


def test_ops_rejects_misfit_shapes():
    x, dt, A, B, C = _t(*_heads(np.random.default_rng(0), 1, 8, 4, 8, 1, 4))
    with pytest.raises(ValueError, match="required"):
        ops.ssd(x[0], dt, A, B, C)
    with pytest.raises(ValueError, match="does not fit"):
        ops.ssd(x, dt[:, :4], A, B, C)
    with pytest.raises(ValueError, match="does not fit"):
        ops.ssd(x, dt, A, B.expand(1, 8, 3, 4), C.expand(1, 8, 3, 4))


@pytest.mark.parametrize("P,N", [(80, 160), (80, 256), (130, 160),
                                 (130, 256), (130, 16), (40, 256)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("groups", ["G1", "GH"])
def test_kernel_branch_pieces_match_jax_ops(P, N, groups):
    """The CUDA branch's split of a wide scan into launches of P <= 64 and
    N <= 128, on CPU tensors with the plain version standing in for the
    launch: y and the state match the JAX op's plain path (ragged S), and
    every launch gets a piece it can take, each column of y and row of the
    state written by the pieces that own it."""
    H = 2
    G = 1 if groups == "G1" else H
    args = _heads(np.random.default_rng(P + N + G), 1, 33, H, P, G, N)
    calls = []

    def run(x, dt, A, B, C, y, hT):
        assert x.shape[3] <= 64 and B.shape[3] <= 128 and x.stride(3) == 1
        assert hT is None or hT.is_contiguous()
        calls.append((x.shape[3], B.shape[3]))
        got = ref.ssd(x, dt, A, B, C, return_state=hT is not None)
        if hT is None:
            y.copy_(got)
        else:
            y.copy_(got[0])
            hT.copy_(got[1])

    for return_state in (False, True):
        calls.clear()
        y, hT = ops._pieces(run, *_t(*args), return_state)
        assert len(calls) == -(-P // 64) * -(-N // 128)
        theirs = jops.ssd(*_j(*args), return_state=True)
        assert y.shape == (1, 33, H, P) and y.dtype == torch.float32
        _close(y, theirs[0])
        if return_state:
            assert hT.shape == (H, N, P) and hT.dtype == torch.float32
            _close(hT, theirs[1])
        else:
            assert hT is None


def test_kernel_branch_pieces_cast_wide_n_to_f32_once():
    """N > 128 in bf16: the blocks run on f32 operands and y is rounded to
    bf16 once, after the blocks' f32 sum (and not block by block)."""
    args = _t(*_heads(np.random.default_rng(19), 1, 32, 2, 16, 1, 256))
    x, B, C = args[0].bfloat16(), args[3].bfloat16(), args[4].bfloat16()
    dtypes = []

    def run(x_, dt, A, B_, C_, y, hT):
        dtypes.append((x_.dtype, B_.dtype, C_.dtype, y.dtype))
        y.copy_(ref.ssd(x_, dt, A, B_, C_))

    y, _ = ops._pieces(run, x, args[1], args[2], B, C, False)
    assert dtypes == [(torch.float32,) * 4] * 2
    want = sum(ref.ssd(x.float(), args[1], args[2], B[..., n].float(),
                       C[..., n].float())
               for n in (slice(0, 128), slice(128, 256)))
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, want.bfloat16(), rtol=0, atol=0)
