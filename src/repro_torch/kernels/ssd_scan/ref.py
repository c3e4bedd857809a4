"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

``ssd_naive`` is the literal per-step recurrence (the gold oracle)::

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t ⊗ x_t        h: (N, P)
    y_t = C_t · h_t

``ssd_chunked`` is the chunked form (intra-chunk dual "attention" products
plus the inter-chunk state recurrence), algebraically identical to
``ssd_naive``; :func:`ssd` folds heads and groups around it with the
contract of the public op.  The JAX package's oracles, with Python loops
over steps and chunks where they run ``lax.scan``.  On a CPU tensor the
public op (:mod:`.ops`) runs :func:`ssd`; on the card it is the reference
the CUDA kernel is held against.
"""

from __future__ import annotations

import torch


def ssd_naive(x, dt, A, B, C):
    """x: (BH, S, P); dt: (BH, S); A: (BH,) (negative); B, C: (BH, S, N).

    Returns y: (BH, S, P) in x's dtype, final state h: (BH, N, P) f32."""
    BH, S, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t] * Af)
        h = (da[:, None, None] * h + dtf[:, t, None, None]
             * (Bf[:, t, :, None] * xf[:, t, None, :]))
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 64):
    """Chunked SSD, same contract as :func:`ssd_naive`.  S % chunk == 0."""
    BH, S, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of the "
                         f"chunk {chunk}")
    nc = S // chunk
    if nc == 0:  # nothing to scan: an empty y and the zero state
        return (x.new_empty((BH, 0, P)),
                torch.zeros((BH, N, P), dtype=torch.float32,
                            device=x.device))
    xf = x.float().reshape(BH, nc, chunk, P)
    dtf = dt.float().reshape(BH, nc, chunk)
    Bf = B.float().reshape(BH, nc, chunk, N)
    Cf = C.float().reshape(BH, nc, chunk, N)
    a = dtf * A.float()[:, None, None]  # (BH, nc, L) log-decays
    cum = torch.cumsum(a, dim=-1)  # inclusive
    total = cum[..., -1]

    # intra-chunk: y[t] = sum_{s<=t} exp(cum t - cum s) dt_s (C_t·B_s) x_s.
    # Above the diagonal the exponent is positive and may overflow, so it
    # is masked to -inf before the exp: the decay there is 0, and so is
    # its gradient.  (The reference exponentiates first and masks after:
    # its forward is the same, but once a chunk's log-decays span more
    # than ~88 its gradient is exp' = inf times the where's 0, NaN.)  The
    # where after it keeps the product's signed zeros out of y.
    G = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    decay = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :],
                                  -torch.inf))
    W = torch.where(mask, G * decay, 0.0) * dtf[..., None, :]
    y_intra = torch.einsum("bcts,bcsp->bctp", W, xf)

    # chunk state contributions: Z_c = sum_s exp(total - cum s) dt_s B_s⊗x_s
    w_state = torch.exp(total[..., None] - cum) * dtf  # (BH, nc, L)
    Z = torch.einsum("bcsn,bcs,bcsp->bcnp", Bf, w_state, xf)

    # inter-chunk recurrence over nc: h_c = exp(total_c) h_{c-1} + Z_c
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)  # the state *entering* chunk c
        h = torch.exp(total[:, c])[:, None, None] * h + Z[:, c]
    h_in = torch.stack(h_in, dim=1)  # (BH, nc, N, P)

    # inter-chunk output: y[t] += (C_t * exp(cum t)) · h_in
    y_inter = torch.einsum("bctn,bct,bcnp->bctp", Cf, torch.exp(cum), h_in)
    y = (y_intra + y_inter).reshape(BH, S, P)
    return y.to(x.dtype), h


def ssd(x, dt, A, B, C, *, chunk: int = 64, return_state: bool = False):
    """Multi-head SSD, the plain version of :func:`.ops.ssd`.

    x: (batch, S, H, P); dt: (batch, S, H); A: (H,); B, C: (batch, S, G, N)
    with G dividing H (head h reads group h // (H // G)).  Returns y:
    (batch, S, H, P); with ``return_state`` also the final state
    (batch·H, N, P) in f32.  A sequence that is not a multiple of ``chunk``
    is one chunk, as in the JAX package."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    xf = x.movedim(2, 1).reshape(b * H, S, P)
    dtf = dt.movedim(2, 1).reshape(b * H, S)
    if G != H:
        B = B.repeat_interleave(H // G, dim=2)
        C = C.repeat_interleave(H // G, dim=2)
    Bf = B.movedim(2, 1).reshape(b * H, S, N)
    Cf = C.movedim(2, 1).reshape(b * H, S, N)
    Af = A.repeat(b)  # (b*H,): head h of every batch row
    ch = chunk if S % chunk == 0 else S
    y, hT = ssd_chunked(xf, dtf, Af, Bf, Cf, chunk=ch)
    out = y.reshape(b, H, S, P).movedim(1, 2)
    return (out, hT) if return_state else out


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t):
    """One recurrent decode step.  h: (BH, N, P); x_t: (BH, P); dt_t: (BH,);
    B_t, C_t: (BH, N).  Returns (y_t in x_t's dtype, h_new f32)."""
    da = torch.exp(dt_t.float() * A.float())  # (BH,)
    h_new = (da[:, None, None] * h
             + dt_t.float()[:, None, None]
             * torch.einsum("bn,bp->bnp", B_t.float(), x_t.float()))
    y = torch.einsum("bn,bnp->bp", C_t.float(), h_new)
    return y.to(x_t.dtype), h_new
