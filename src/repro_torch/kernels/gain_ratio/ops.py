"""Wrapper of the T_GR histogram kernel (``csrc/gain_ratio_hist.cu``).

Replaces ``repro/kernels/gain_ratio/kernel.py:multi_tree_hist_pallas``.
On a CUDA tensor it launches the kernel (and counts the launch in
``launches``); on a CPU tensor it runs the plain version in ``ref.py``.
What bounds the kernel on an H100 and how its design answers that is in
the source's note.
"""
from __future__ import annotations

import torch

from .ref import multi_tree_hist_ref

launches = 0   # kernel launches in this process (the CPU path does not count)


def _check(x_bins, base, w, slot):
    N, W = x_bins.shape
    tc = w.shape[0]
    if x_bins.dtype != torch.uint8:
        raise TypeError(f"x_bins must be uint8, got {x_bins.dtype}")
    if x_bins.stride(1) != 1:
        raise ValueError("x_bins must have unit stride along features")
    if base.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("base and w must be float32")
    if slot.dtype != torch.int32:
        raise TypeError(f"slot must be int32, got {slot.dtype}")
    if base.shape[0] != N or tuple(w.shape) != (tc, N) or tuple(slot.shape) != (tc, N):
        raise ValueError(
            f"shape mismatch: x {tuple(x_bins.shape)}, base {tuple(base.shape)}, "
            f"w {tuple(w.shape)}, slot {tuple(slot.shape)}"
        )
    devs = {t.device for t in (x_bins, base, w, slot)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def multi_tree_hist(
    x_bins: torch.Tensor,   # [N, W] uint8; a column slice of a wider matrix is fine
    base: torch.Tensor,     # [N, C] float32
    w: torch.Tensor,        # [tc, N] float32
    slot: torch.Tensor,     # [tc, N] int32, -1 = parked
    *,
    n_slots: int,
    n_bins: int,
    packed: bool = False,
) -> torch.Tensor:
    """Multi-tree histograms [tc, S, W, B, C] float32 (bins must be < n_bins)."""
    global launches
    _check(x_bins, base, w, slot)
    if not x_bins.is_cuda:
        return multi_tree_hist_ref(
            x_bins, base, w, slot, n_slots=n_slots, n_bins=n_bins, packed=packed
        )
    from .._build import launch

    base, w, slot = base.contiguous(), w.contiguous(), slot.contiguous()
    N, W = x_bins.shape
    tc, C = w.shape[0], base.shape[1]
    out = torch.zeros((tc, n_slots, W, n_bins, C), dtype=torch.float32, device=base.device)
    launch(
        "prf_hist", x_bins.data_ptr(), x_bins.stride(0), base.data_ptr(),
        w.data_ptr(), slot.data_ptr(), out.data_ptr(), N, W, tc, n_slots,
        n_bins, C, int(packed),
    )
    launches += 1
    return out
