"""Plain PyTorch version of the T_GR histogram kernel (``csrc/gain_ratio_hist.cu``).

The same function as the kernel: for every tree, every non-parked
sample adds ``w[t, i] * base[i, c]`` at ``[t, slot, f, x[i, f], c]``
(packed mode adds ``w[t, i] * max_c base[i, c]`` at the argmax class,
which gives the same numbers for one-hot channels). Parked samples
(``slot < 0``) land in a dump row that is sliced off. Built with one
``index_add_`` per tree over a flat index, so integer weights give
bitwise the same histogram as the kernel's atomics in any order.

``multi_tree_hist_fixed_ref`` is the plain version of the kernel's
fixed-point mode (``FixedPoint``): channels ``[c0, C)`` (regression's
``y`` and ``y^2``) are quantised to ``round(p * 2^shift)`` (half to even)
and summed as int64, which is exact, so the sum does not depend on the
order of the samples even under CUDA's atomic ``index_add_``; each sum is
then rounded once to float32. The kernel equals it bitwise.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class FixedPoint(NamedTuple):
    """Channels ``[c0, C)`` of a histogram summed in fixed point at
    ``2^shift`` (``fixed_shift``): the same ``shift`` for every call of
    one growth, so every partial histogram rounds alike."""
    c0: int
    shift: int


def fixed_shift(n_samples: int, max_weight: float, max_abs_value: float) -> int:
    """The largest ``s`` with ``n_samples * max_weight * max_abs_value * 2^s
    <= 2^62``: no sum of at most ``n_samples`` contributions ``w * v``
    (``|w| <= max_weight``, ``|v| <= max_abs_value``), each rounded to a
    multiple of ``2^-s``, can pass 2^62, so int64 sums never overflow."""
    bound = float(n_samples) * float(max_weight) * float(max_abs_value)
    if not math.isfinite(bound) or bound < 0:
        raise ValueError(f"fixed_shift: no scale for a bound of {bound} "
                         f"({n_samples} x {max_weight} x {max_abs_value})")
    if bound == 0.0:
        return 0                                       # every contribution is zero
    m, e = math.frexp(bound)                           # bound = m * 2^e, 0.5 <= m < 1
    return 62 - (e - 1 if m == 0.5 else e)             # the least e with bound <= 2^e


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


def multi_tree_hist_fixed_ref(
    x_bins: torch.Tensor,   # [N, W] uint8
    base: torch.Tensor,     # [N, C] float32
    w: torch.Tensor,        # [tc, N] float32
    slot: torch.Tensor,     # [tc, N] int32, -1 = parked
    *,
    n_slots: int,
    n_bins: int,
    fixed: FixedPoint,
) -> torch.Tensor:
    """``multi_tree_hist_ref`` with channels ``[fixed.c0, C)`` summed in
    fixed point: each contribution ``p = w[t, i] * base[i, c]`` (float32)
    becomes ``round(p * 2^s)`` in int64, the sums are exact, and each is
    rounded once to float32 as ``float(double(acc) * 2^-s)``. Channels
    ``[0, c0)`` (integer counts) are the float version's. [tc, S, W, B, C]."""
    N, W = x_bins.shape
    tc, C = w.shape[0], base.shape[1]
    S, B, c0 = n_slots, n_bins, fixed.c0
    if not 0 <= c0 < C:
        raise ValueError(f"fixed point from channel {c0} of {C}")
    dev = base.device
    ints = multi_tree_hist_ref(x_bins, base[:, :c0].contiguous(), w, slot, n_slots=S, n_bins=B)
    Cf = C - c0
    xb = x_bins.long()
    fcol = torch.arange(W, device=dev)[None, :]
    acc = torch.zeros((tc, (S + 1) * W * B * Cf), dtype=torch.int64, device=dev)
    scale = 2.0 ** fixed.shift
    for t in range(tc):
        seg = torch.where((slot[t] >= 0) & (slot[t] < S), slot[t].long(), S)
        cell = ((seg[:, None] * W + fcol) * B + xb) * Cf                # [N, W]
        q = torch.round((w[t][:, None] * base[:, c0:]).double() * scale).long()   # [N, Cf]
        idx = cell[:, :, None] + torch.arange(Cf, device=dev)
        acc[t].index_add_(0, idx.reshape(-1), q[:, None, :].expand(N, W, Cf).reshape(-1))
    acc = acc.reshape(tc, S + 1, W, B, Cf)[:, :S]
    flt = (acc.double() * 2.0 ** -fixed.shift).float()
    return torch.cat([ints, flt], dim=-1)
