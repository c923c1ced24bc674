"""Plain PyTorch version of the T_GR histogram kernel (``csrc/gain_ratio_hist.cu``).

The same function as the kernel: for every tree, every non-parked
sample adds ``w[t, i] * base[i, c]`` at ``[t, slot, f, x[i, f], c]``
(packed mode adds ``w[t, i] * max_c base[i, c]`` at the argmax class,
which gives the same numbers for one-hot channels). Parked samples
(``slot < 0``) land in a dump row that is sliced off. Built with one
``index_add_`` per tree over a flat index, so integer weights give
bitwise the same histogram as the kernel's atomics in any order.
"""
from __future__ import annotations

import torch


def multi_tree_hist_ref(
    x_bins: torch.Tensor,   # [N, W] uint8 (a column slice view is fine)
    base: torch.Tensor,     # [N, C] float32 unweighted channels
    w: torch.Tensor,        # [tc, N] float32 per-tree DSI weights
    slot: torch.Tensor,     # [tc, N] int32 frontier slot, -1 = parked
    *,
    n_slots: int,
    n_bins: int,
    packed: bool = False,
) -> torch.Tensor:
    """hist[t,s,f,b,c] = sum_i w[t,i]*base[i,c]*[slot[t,i]=s]*[x[i,f]=b]. [tc,S,W,B,C] f32."""
    N, W = x_bins.shape
    tc, C = w.shape[0], base.shape[1]
    S, B = n_slots, n_bins
    dev = base.device
    xb = x_bins.long()                                            # [N, W]
    out = torch.zeros((tc, (S + 1) * W * B * C), dtype=torch.float32, device=dev)
    fcol = torch.arange(W, device=dev)[None, :]
    if packed:
        cls = torch.argmax(base, dim=-1)                          # [N]
        wcls = base.max(dim=-1).values                            # [N]
    for t in range(tc):
        seg = torch.where(slot[t] >= 0, slot[t].long(), S)        # parked -> dump row
        seg = torch.where(seg < S, seg, S)
        cell = ((seg[:, None] * W + fcol) * B + xb) * C           # [N, W]
        if packed:
            vals = (w[t] * wcls)[:, None].expand(N, W)
            out[t].index_add_(0, (cell + cls[:, None]).reshape(-1), vals.reshape(-1))
        else:
            ch = w[t][:, None] * base                             # [N, C]
            idx = cell[:, :, None] + torch.arange(C, device=dev)
            vals = ch[:, None, :].expand(N, W, C)
            out[t].index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return out.reshape(tc, S + 1, W, B, C)[:, :S].contiguous()
