"""Plain PyTorch versions of the SSD scan kernel (``csrc/ssd_scan.cu``).

``ssd_ref`` is the reference's sequential oracle
(``repro/kernels/ssd_scan/ref.py``) on ``[BH, L, P]``:

    h_t = a_t * h_{t-1} + b_t (x) x_t         h in R^{N x P}
    y_t = c_t^T h_t

``ssd_chunked`` is the chunked form the model runs
(``repro/models/mamba.py:_ssd_chunked``) in the model's layout, b/c
shared over heads: the plain version of the kernel.

``ssd_chunked_bwd`` is its gradient from h = 0, written out as the
backward kernel (``csrc/ssd_scan_bwd.cu``) computes it: the plain
version of that kernel (the reference differentiates ``_ssd_chunked``
with XLA).
"""
from __future__ import annotations

from typing import Optional

import torch


def ssd_ref(x, loga, b, c):
    """x [BH, L, P], loga [BH, L] (log decay <= 0), b/c [BH, L, N], from h = 0.
    Returns (y [BH, L, P] f32, h_final [BH, N, P] f32)."""
    BH, L, P = x.shape
    N = b.shape[-1]
    h = torch.zeros((BH, N, P), device=x.device)
    x, loga, b, c = x.float(), loga.float(), b.float(), c.float()
    ys = []
    for t in range(L):
        h = torch.exp(loga[:, t])[:, None, None] * h + b[:, t, :, None] * x[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", c[:, t], h))
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, loga, b, c, h0: Optional[torch.Tensor], chunk: int):
    """x [B,S,H,P], loga [B,S,H], b/c [B,S,N], h0 [B,H,N,P] (None: zeros).

    Returns (y [B,S,H,P] in x's dtype, h_final [B,H,N,P] f32).
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    G = S // chunk
    xg = x.reshape(B, G, chunk, H, P).float()
    lg = loga.reshape(B, G, chunk, H).float()
    bg = b.reshape(B, G, chunk, N).float()
    cg = c.reshape(B, G, chunk, N).float()

    lc = torch.cumsum(lg, dim=2)                                  # [B,G,Q,H]
    # Intra-chunk masked term. The exponent is clamped UNDER the mask:
    # for j > i it is positive and exp() would overflow.
    s = torch.einsum("bgin,bgjn->bgij", cg, bg)
    ii = torch.arange(chunk, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    delta = lc[:, :, :, None, :] - lc[:, :, None, :, :]           # [B,G,i,j,H]
    decay = torch.exp(torch.where(mask, delta, 0.0))
    sd = torch.where(mask, s[..., None] * decay, 0.0)
    y = torch.einsum("bgijh,bgjhp->bgihp", sd, xg)

    # Chunk summaries and the inter-chunk recurrence.
    w_end = torch.exp(lc[:, :, -1:, :] - lc)                      # [B,G,Q,H]
    summ = torch.einsum("bgjn,bgjh,bgjhp->bghnp", bg, w_end, xg)  # [B,G,H,N,P]
    chunk_decay = torch.exp(lc[:, :, -1, :])                      # [B,G,H]
    h = torch.zeros((B, H, N, P), device=x.device) if h0 is None else h0.float()
    h_in = []
    for g in range(G):
        h_in.append(h)                                            # state entering chunk g
        h = chunk_decay[:, g, :, None, None] * h + summ[:, g]
    h_in = torch.stack(h_in, dim=1)                               # [B,G,H,N,P]

    # Carried-state contribution.
    y = y + torch.einsum("bgin,bgih,bghnp->bgihp", cg, torch.exp(lc), h_in)
    return y.reshape(B, S, H, P).to(x.dtype), h


def ssd_chunked_bwd(x, loga, b, c, dy, chunk: int):
    """Gradient of ``ssd_chunked(x, loga, b, c, None, chunk)[0]`` (y; the
    final state is not an output) against ``dy`` [B,S,H,P].

    Returns (dx [B,S,H,P] in x's dtype, dloga [B,S,H] in loga's, db, dc
    [B,S,N] in b's and c's), computed in f32 (f64 from f64 inputs, for an
    exact yardstick: ``tools/ssd_dloga_accuracy.py``). Per chunk g and head, with
    lc the chunk-local cumulative log decay, D_ij = exp(lc_i - lc_j) for
    j <= i (else 0), H_g the state entering chunk g and dH_g its gradient:

        dH_g  = sum_i exp(lc_i) c_i dy_i^T + exp(lc_Q) dH_{g+1}      (dH_G = 0)
        dx_j  = sum_i (c_i . b_j) D_ij dy_i + exp(lc_Q - lc_j) dH_{g+1}^T b_j
        dS_ij = D_ij (dy_i . x_j)
        db_j  = sum_h [sum_i dS_ij c_i + exp(lc_Q - lc_j) dH_{g+1} x_j]
        dc_i  = sum_h [sum_j dS_ij b_j + exp(lc_i) H_g dy_i]
        dloga_t = sum_{j < t <= i} A_ij + sum_{i >= t} exp(lc_i) dy_i . (c_i H_g)
                  + sum_{j < t} exp(lc_Q - lc_j) x_j . (b_j dH_{g+1}) + exp(lc_Q) <H_g, dH_{g+1}>

    with A_ij = (c_i . b_j) dS_ij and t, i, j in chunk g: each term of y and
    of the next state goes to the log decays its decay factor spans (D_ij
    spans j < t <= i, exp(lc_i) the chunk's steps up to i, exp(lc_Q - lc_j)
    those after j, exp(lc_Q) all). Every sum adds terms of one quantity; the
    shorter form sum_{s >= t} (dy_s . y_s - dx_s . x_s) subtracts two sums
    of a larger scale and loses accuracy (``tools/ssd_dloga_accuracy.py``).
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    G = S // chunk
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xg = x.reshape(B, G, chunk, H, P).to(acc)
    dyg = dy.reshape(B, G, chunk, H, P).to(acc)
    lg = loga.reshape(B, G, chunk, H).to(acc)
    bg = b.reshape(B, G, chunk, N).to(acc)
    cg = c.reshape(B, G, chunk, N).to(acc)

    lc = torch.cumsum(lg, dim=2)                                  # [B,G,Q,H]
    ii = torch.arange(chunk, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    delta = lc[:, :, :, None, :] - lc[:, :, None, :, :]           # [B,G,i,j,H]
    decay = torch.where(mask, torch.exp(torch.where(mask, delta, 0.0)), 0.0)
    sd = torch.einsum("bgin,bgjn->bgij", cg, bg)[..., None] * decay
    el = torch.exp(lc)                                            # exp(lc_i)
    w_end = torch.exp(lc[:, :, -1:, :] - lc)                      # exp(lc_Q - lc_j)
    chunk_decay = torch.exp(lc[:, :, -1, :])                      # [B,G,H]

    # the states entering each chunk, forward; their gradients, in reverse
    summ = torch.einsum("bgjn,bgjh,bgjhp->bghnp", bg, w_end, xg)
    dsumm = torch.einsum("bgin,bgih,bgihp->bghnp", cg, el, dyg)
    h = torch.zeros((B, H, N, P), dtype=acc, device=x.device)
    h_in = []
    for g in range(G):
        h_in.append(h)
        h = chunk_decay[:, g, :, None, None] * h + summ[:, g]
    h_in = torch.stack(h_in, dim=1)                               # H_g       [B,G,H,N,P]
    dh = torch.zeros_like(h)
    dh_out = [None] * G
    for g in reversed(range(G)):
        dh_out[g] = dh
        dh = chunk_decay[:, g, :, None, None] * dh + dsumm[:, g]
    dh_out = torch.stack(dh_out, dim=1)                           # dH_{g+1}  [B,G,H,N,P]

    dx = (torch.einsum("bgijh,bgihp->bgjhp", sd, dyg)
          + w_end[..., None] * torch.einsum("bgjn,bghnp->bgjhp", bg, dh_out))
    ds = torch.einsum("bgihp,bgjhp->bgijh", dyg, xg) * decay
    db = (torch.einsum("bgijh,bgin->bgjn", ds, cg)
          + torch.einsum("bgjh,bghnp,bgjhp->bgjn", w_end, dh_out, xg))
    dc = (torch.einsum("bgijh,bgjn->bgin", ds, bg)
          + torch.einsum("bgih,bghnp,bgihp->bgin", el, h_in, dyg))

    # dloga: the pair terms A_ij over the rectangle j < t <= i (row prefix
    # sums, then sums down each column), the state terms by step
    a = sd * torch.einsum("bgihp,bgjhp->bgijh", dyg, xg)          # A_ij, 0 for j > i
    pre = torch.cumsum(a, dim=3) - a                              # [b,g,i,t]: sum_{j < t} A_ij
    rect = torch.where(mask, pre, 0.0).sum(2)                     # [B,G,t,H]: sum_{i >= t}
    st_y = el * (dyg * torch.einsum("bgin,bghnp->bgihp", cg, h_in)).sum(-1)
    st_x = w_end * (xg * torch.einsum("bgjn,bghnp->bgjhp", bg, dh_out)).sum(-1)
    carry = chunk_decay * (h_in * dh_out).sum((-2, -1))           # [B,G,H]
    dloga = (rect + torch.flip(torch.cumsum(torch.flip(st_y, (2,)), dim=2), (2,))
             + torch.cumsum(st_x, dim=2) - st_x + carry[:, :, None, :])
    return (dx.reshape(B, S, H, P).to(x.dtype), dloga.reshape(B, S, H).to(loga.dtype),
            db.reshape(B, S, N).to(b.dtype), dc.reshape(B, S, N).to(c.dtype))
