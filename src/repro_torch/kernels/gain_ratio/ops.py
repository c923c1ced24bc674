"""Wrapper of the T_GR histogram kernel (``csrc/gain_ratio_hist.cu``).

Replaces ``repro/kernels/gain_ratio/kernel.py:multi_tree_hist_pallas``.
On a CUDA tensor it launches the kernel (and counts the launch in
``launches``); on a CPU tensor it runs the plain version in ``ref.py``,
which needs no ordering and ignores one it is given. ``slot_order``
groups each tree's live samples by slot, the grouping the kernel walks;
the growth engine computes it once per level and hands it to every
feature slab. What bounds the kernel on an H100 and how its design
answers that is in the source's note.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ref import multi_tree_hist_ref

launches = 0   # kernel launches in this process (the CPU path does not count)
MAX_ROW_BYTES = 227 * 1024    # shared memory a block may take
TILE_ROW_BYTES = 48 * 1024    # a class tile's [B, Ct] int histogram (+ pad): several blocks an SM


def class_tile(n_bins: int, n_channels: int) -> int:
    """Classes a block holds at once: all C while one feature's ``[B, C]``
    int histogram, plus its pad word, fits ``MAX_ROW_BYTES`` (C < 227 at
    B 256), else tiles of a multiple of 4 classes (whole float4 flushes)
    whose row fits ``TILE_ROW_BYTES`` (44 at B 256)."""
    if (n_bins * n_channels + 1) * 4 <= MAX_ROW_BYTES:
        return n_channels
    ct = (TILE_ROW_BYTES // 4 - 1) // n_bins
    return max(1, ct - ct % 4 if ct >= 8 else ct)


class SlotOrder(NamedTuple):
    """Each tree's live samples grouped by slot: ``order[t, seg[t, s]:seg[t, s + 1]]``
    are the samples of slot s in ascending index order; ``seg[t, S]`` counts
    the live samples, and the positions after it hold the rest."""
    order: torch.Tensor   # [tc, N] int32 sample indices
    seg: torch.Tensor     # [tc, S + 1] int32 segment starts


def slot_order(slot: torch.Tensor, w: torch.Tensor, n_slots: int) -> SlotOrder:
    """Stable grouping of the live samples (slot in [0, n_slots), nonzero
    weight) by slot, per tree: parked and zero-weight samples keyed past the
    last slot, then one stable sort of all trees' keys offset by tree (one
    flat sort is faster on the card than a sort along the sample axis, and
    a radix sort of 16-bit keys takes half the passes of 32-bit ones)."""
    tc, N = slot.shape
    S1 = n_slots + 1
    if tc * S1 >= 2 ** 31:
        raise ValueError(f"slot_order: {tc} trees x {S1} keys overflow the int32 sort key")
    dev = slot.device
    live = (slot >= 0) & (slot < n_slots) & (w != 0)
    tree = torch.arange(tc, dtype=torch.int32, device=dev)[:, None]
    key = torch.where(live, slot, n_slots).to(torch.int32) + tree * S1
    if tc * S1 < 2 ** 15:
        key = key.to(torch.int16)
    key_sorted, flat = torch.sort(key.reshape(-1), stable=True)
    order = (flat.view(tc, N) - tree.long() * N).to(torch.int32)
    starts = (torch.arange(S1, dtype=torch.int32, device=dev) + tree * S1).to(key.dtype)
    seg = torch.searchsorted(key_sorted.view(tc, N), starts)
    return SlotOrder(order, seg.to(torch.int32))


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


def _check_order(order: SlotOrder, slot: torch.Tensor, n_slots: int):
    tc, N = slot.shape
    if order.order.dtype != torch.int32 or order.seg.dtype != torch.int32:
        raise TypeError(f"order and seg must be int32, got {order.order.dtype}, {order.seg.dtype}")
    if tuple(order.order.shape) != (tc, N) or tuple(order.seg.shape) != (tc, n_slots + 1):
        raise ValueError(f"order {tuple(order.order.shape)} / seg {tuple(order.seg.shape)} do not "
                         f"fit slot {tuple(slot.shape)} with {n_slots} slots")
    if order.order.device != slot.device or order.seg.device != slot.device:
        raise ValueError("order and slot on different devices")


def multi_tree_hist(
    x_bins: torch.Tensor,   # [N, W] uint8; a column slice of a wider matrix is fine
    base: torch.Tensor,     # [N, C] float32
    w: torch.Tensor,        # [tc, N] float32
    slot: torch.Tensor,     # [tc, N] int32, -1 = parked
    *,
    n_slots: int,
    n_bins: int,
    packed: bool = False,
    order: Optional[SlotOrder] = None,   # slot_order(slot, w, n_slots); made here if None
    out: Optional[torch.Tensor] = None,  # [tc, S, W, B, C] float32 to add into
) -> torch.Tensor:
    """Multi-tree histograms [tc, S, W, B, C] float32 (bins must be < n_bins).

    With ``out`` the histogram is added into it, in place, and ``out`` is
    returned: the kernel's atomics flush into it as into its own zeroed
    output, the plain version does ``out += hist``. With integer counts
    the sum is exact, so a histogram accumulated over sample blocks is
    bitwise the one-shot histogram."""
    global launches
    _check(x_bins, base, w, slot)
    if order is not None:
        _check_order(order, slot, n_slots)
    N, W = x_bins.shape
    tc, C = w.shape[0], base.shape[1]
    if out is not None:
        shape = (tc, n_slots, W, n_bins, C)
        if out.dtype != torch.float32 or tuple(out.shape) != shape or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous float32 {list(shape)} tensor")
        if out.device != x_bins.device:
            raise ValueError(f"out on {out.device}, bins on {x_bins.device}")
    if not x_bins.is_cuda:
        hist = multi_tree_hist_ref(
            x_bins, base, w, slot, n_slots=n_slots, n_bins=n_bins, packed=packed
        )
        return hist if out is None else out.add_(hist)
    from .._build import launch

    base, w, slot = base.contiguous(), w.contiguous(), slot.contiguous()
    if order is None and n_slots > 1:
        order = slot_order(slot, w, n_slots)
    order_ptr = seg_ptr = None      # one slot: the kernel takes the samples in index order
    if order is not None:
        order = SlotOrder(order.order.contiguous(), order.seg.contiguous())
        order_ptr, seg_ptr = order.order.data_ptr(), order.seg.data_ptr()
    if out is None:
        out = torch.zeros((tc, n_slots, W, n_bins, C), dtype=torch.float32, device=base.device)
    launch(
        "prf_hist", x_bins.data_ptr(), x_bins.stride(0), base.data_ptr(),
        w.data_ptr(), slot.data_ptr(), order_ptr, seg_ptr, out.data_ptr(), N, W, tc,
        n_slots, n_bins, C, int(packed), class_tile(n_bins, C),
    )
    launches += 1
    return out
