"""Plain PyTorch versions of the SSD scan kernel (``csrc/ssd_scan.cu``).

``ssd_ref`` is the reference's sequential oracle
(``repro/kernels/ssd_scan/ref.py``) on ``[BH, L, P]``:

    h_t = a_t * h_{t-1} + b_t (x) x_t         h in R^{N x P}
    y_t = c_t^T h_t

``ssd_chunked`` is the chunked form the model runs
(``repro/models/mamba.py:_ssd_chunked``) in the model's layout, b/c
shared over heads: the plain version of the kernel.
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
