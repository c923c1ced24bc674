"""Wrapper of the split-scan kernel (``csrc/split_scan.cu``).

Replaces ``repro/kernels/split_scan/kernel.py:split_scan_block`` (and its
one-shot ``split_scan_scores``). On CUDA tensors it launches the kernel
(counted in ``launches``); on CPU tensors it runs ``ref.py``. What bounds
the kernel and how its design answers that is in the source's note.
"""
from __future__ import annotations

import torch

from ...core.gain import SplitScores
from .ref import init_carry, split_scan_block_ref

launches = 0   # kernel launches in this process (the CPU path does not count)
MAX_HIST_BYTES = 200 * 1024   # shared memory of a block: its warps' [B, Ct | 1] buffers
WARPS = 8                     # warps (slots) a block takes at most


def class_tile(n_bins: int, n_channels: int) -> int:
    """Classes a warp's buffer holds at once: all C while one ``[B, C | 1]``
    float histogram fits ``MAX_HIST_BYTES`` (C < 200 at B 256), else the
    largest odd tile that lets ``WARPS`` buffers fit (25 at B 256), which
    the wide kernel passes over (classification only)."""
    if n_bins * (n_channels | 1) * 4 <= MAX_HIST_BYTES:
        return n_channels
    per = MAX_HIST_BYTES // (WARPS * n_bins * 4)
    return min(n_channels, per if per % 2 else per - 1)


def split_scan_block(
    hist: torch.Tensor,          # [tc, S, W, B, C] float32 histogram slab
    mask,                        # [tc, W] bool feature mask, or None (all admitted)
    carry,                       # running best (init_carry or a prior result), or None
    f_base: int = 0,             # global feature id of hist[:, :, 0]
    *,
    regression: bool = False,
) -> tuple:
    """Fold one slab into the running-best carry; returns the new carry
    ``(gain [tc,S] f32, feature [tc,S] i32, threshold [tc,S] i32,
    left_counts [tc,S,C] f32, right_counts [tc,S,C] f32)``."""
    global launches
    if hist.dim() != 5 or hist.dtype != torch.float32:
        raise TypeError("hist must be a float32 [tc, S, W, B, C] tensor")
    tc, S, W, B, C = hist.shape
    if not 2 <= B <= 256:
        raise ValueError(f"n_bins must be in [2, 256], got {B}")
    if regression and C != 3:
        raise ValueError(f"regression scoring needs 3 channels, got {C}")
    if mask is None:
        mask = torch.ones((tc, W), dtype=torch.bool, device=hist.device)
    if tuple(mask.shape) != (tc, W) or mask.device != hist.device:
        raise ValueError(f"mask must be [{tc}, {W}] on {hist.device}")
    if carry is None:
        carry = init_carry(tc, S, C, hist.device)
    if not hist.is_cuda:
        return split_scan_block_ref(hist, mask.bool(), carry, f_base, regression=regression)
    from .._build import launch

    hist = hist.contiguous()
    mask_u8 = mask.to(torch.uint8).contiguous()
    gain, feat, thr, left, right = (c.clone().contiguous() for c in carry)
    launch(
        "prf_split_scan", hist.data_ptr(), mask_u8.data_ptr(), int(f_base),
        gain.data_ptr(), feat.data_ptr(), thr.data_ptr(), left.data_ptr(),
        right.data_ptr(), tc, S, W, B, C, int(regression), class_tile(B, C),
    )
    launches += 1
    return gain, feat, thr, left, right


def split_scan_scores(hist: torch.Tensor, mask, *, regression: bool = False) -> SplitScores:
    """Score a full [tc, S, F, B, C] histogram in one call."""
    return SplitScores(*split_scan_block(hist, mask, None, 0, regression=regression))
