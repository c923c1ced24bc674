"""Plain PyTorch version of the split-scan kernel (``csrc/split_scan.cu``).

Same contract as the kernel: score one histogram slab (Eq. 2-6 gain
ratios, or variance gains for regression, from one bin cumsum), mask
features to -inf, take the first-occurrence argmax over (feature,
threshold), gather the winner's child counts from the same cumsum, and
fold the result into the running-best carry (strictly greater, or carry
feature < 0). Feature ids are global: ``f_base`` + position in the slab.
"""
from __future__ import annotations

import torch

from ...core.gain import (
    _bin_cumsum, _mask_scores, _select_winners, split_gain_ratios_from_cumsum,
    variance_gains_from_cumsum,
)


def init_carry(tc: int, S: int, C: int, device) -> tuple:
    """Neutral running-best carry: no winner yet (feature = -1)."""
    return (
        torch.full((tc, S), -torch.inf, dtype=torch.float32, device=device),
        torch.full((tc, S), -1, dtype=torch.int32, device=device),
        torch.zeros((tc, S), dtype=torch.int32, device=device),
        torch.zeros((tc, S, C), dtype=torch.float32, device=device),
        torch.zeros((tc, S, C), dtype=torch.float32, device=device),
    )


def split_scan_block_ref(
    hist: torch.Tensor,          # [tc, S, W, B, C]
    mask: torch.Tensor,          # [tc, W] bool
    carry: tuple,
    f_base: int = 0,
    *,
    regression: bool = False,
) -> tuple:
    """Reference running-best update over one slab. Returns a new carry."""
    cum = _bin_cumsum(hist)
    total = cum[..., -1, :]
    if regression:
        sc = variance_gains_from_cumsum(cum, total)
    else:
        sc = split_gain_ratios_from_cumsum(cum, total)
    win = _select_winners(_mask_scores(sc, mask), cum, total)
    f_glob = win.feature + f_base
    gr0, f0, thr0, l0, r0 = carry
    better = (win.gain_ratio > gr0) | (f0 < 0)
    return (
        torch.where(better, win.gain_ratio, gr0),
        torch.where(better, f_glob, f0),
        torch.where(better, win.threshold, thr0),
        torch.where(better[..., None], win.left_counts, l0),
        torch.where(better[..., None], win.right_counts, r0),
    )
