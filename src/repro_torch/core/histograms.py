"""Weighted class-histogram construction — the T_GR stage (paper §4.2.1).

Counterpart of ``repro/core/histograms.py``. ``level_histograms`` is the
one entry point for every histogram the trainer builds (growth and
dimension reduction). Backends, by ``ForestConfig.hist_backend``:

* ``"pallas"``      — the CUDA kernel ``csrc/gain_ratio_hist.cu``;
* ``"segment_sum"`` — its plain PyTorch version (``kernels/gain_ratio/ref.py``);
* ``"auto"``        — the kernel for CUDA tensors, the plain version on the CPU.

The kernel takes every shape: a class axis whose ``[B, C]`` histogram
does not fit its shared memory (C >= 227 at B 256, the paper's
hundreds-of-classes datasets) goes in class tiles
(``kernels/gain_ratio/ops.class_tile``), so ``"auto"`` on CUDA always
resolves to the kernel.

The per-tree DSI weight multiply is applied inside the per-tree step, so
the ``[k, N, C]`` weighted-channel tensor never exists. A feature slab is
a column slice view of the ``[N, F]`` bins (no copy); its histogram
equals the slice of the full one, since every feature is independent.
The kernel walks each tree's live samples grouped by slot
(``slot_order``); a caller that builds several slabs from one level
makes the grouping once and passes it to each.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..kernels.gain_ratio.ops import SlotOrder, slot_order  # slot_order: re-exported

BACKENDS = ("auto", "pallas", "segment_sum")

# Per-tree byte budget of one feature slab of the fused T_GR -> T_NS loop.
_SLAB_BYTES_PER_TREE = 8 << 20


def resolve_backend(backend: str, device: torch.device) -> str:
    """'auto' -> 'pallas' (CUDA kernel) for CUDA tensors, 'segment_sum' on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"hist_backend={backend!r} not in {BACKENDS}")
    if backend == "auto":
        return "pallas" if device.type == "cuda" else "segment_sum"
    if backend == "pallas" and device.type != "cuda":
        raise ValueError("hist_backend='pallas' is the CUDA kernel; tensors are on the CPU")
    return backend


def hist_feature_slab(N: int, F: int, S: int, B: int, C: int) -> int:
    """Feature-slab width of the fused loop: as many features as fit
    ``_SLAB_BYTES_PER_TREE`` of ``[S, W, B, C]`` float32 per tree (at
    least 1, at most F). The port's own width: the CUDA kernel takes any
    width, and every slab's histogram is the slice of the full one."""
    per_feature = S * B * C * 4
    return max(1, min(F, _SLAB_BYTES_PER_TREE // per_feature))


def level_histograms(
    x_binned: torch.Tensor,      # [N, F] uint8 (a column slice view is fine)
    base_channels: torch.Tensor, # [N, C] float32 unweighted channels
    weights: torch.Tensor,       # [k, N] float32 per-tree in-bag weights
    sample_slot: torch.Tensor,   # [k, N] int32, -1 = parked
    *,
    n_slots: int,
    n_bins: int,
    packed: bool = False,
    backend: str = "auto",
    order: Optional[SlotOrder] = None,   # slot_order(sample_slot, weights, n_slots)
    out: Optional[torch.Tensor] = None,  # [k, S, F, B, C] float32 to add into
) -> torch.Tensor:
    """hist[t,s,f,b,c] = sum_i w[t,i] * base[i,c] * [slot_i = s] * [x_if = b].

    Returns [k, S, F, B, C] float32, or ``out`` with the histogram added
    into it. ``order`` only steers the kernel; the plain version gives
    the same histogram without it.
    """
    backend = resolve_backend(backend, x_binned.device)
    if backend == "pallas":
        from ..kernels.gain_ratio.ops import multi_tree_hist

        return multi_tree_hist(
            x_binned, base_channels, weights, sample_slot,
            n_slots=n_slots, n_bins=n_bins, packed=packed, order=order, out=out,
        )
    from ..kernels.gain_ratio.ref import multi_tree_hist_ref

    hist = multi_tree_hist_ref(
        x_binned, base_channels, weights, sample_slot,
        n_slots=n_slots, n_bins=n_bins, packed=packed,
    )
    return hist if out is None else out.add_(hist)


def blocked_level_histograms(
    x_binned: torch.Tensor,      # [N, F] uint8
    base_channels: torch.Tensor, # [N, C]
    weights: torch.Tensor,       # [k, N]
    sample_slot: torch.Tensor,   # [k, N] int32, -1 = parked
    *,
    n_slots: int,
    n_bins: int,
    sample_block: int,
    packed: bool = False,
    backend: str = "auto",
    orders: Optional[Sequence[SlotOrder]] = None,   # block_slot_orders(...)
) -> torch.Tensor:
    """``level_histograms`` accumulated over ``[sample_block, F]`` row
    blocks, each added into one carry (``out=``): the resumable
    sample-axis carry of the T_GR stage (reference:
    ``repro/core/histograms.py:blocked_level_histograms``). Exact for
    integer counts (every partial sum an exact float below 2^24), so it
    equals ``level_histograms`` bitwise for classification; regression
    channels agree to rounding. The remainder block is a shorter slice:
    both the kernel and the plain version take any N (the reference pads
    it with parked samples, which add nothing). ``orders`` hands in each
    block's slot grouping for the kernel."""
    N, F = x_binned.shape
    k = weights.shape[0]
    acc = torch.zeros((k, n_slots, F, n_bins, base_channels.shape[-1]),
                      dtype=torch.float32, device=x_binned.device)
    for j, r0 in enumerate(range(0, N, sample_block)):
        r1 = min(r0 + sample_block, N)
        level_histograms(
            x_binned[r0:r1], base_channels[r0:r1], weights[:, r0:r1], sample_slot[:, r0:r1],
            n_slots=n_slots, n_bins=n_bins, packed=packed, backend=backend,
            order=None if orders is None else orders[j], out=acc,
        )
    return acc


def block_slot_orders(sample_slot: torch.Tensor, weights: torch.Tensor, n_slots: int,
                      sample_block: int) -> list:
    """``slot_order`` of each ``sample_block``-row block, made once a level
    and shared by every feature slab of ``blocked_level_histograms``."""
    N = sample_slot.shape[1]
    return [slot_order(sample_slot[:, r0:r0 + sample_block], weights[:, r0:r0 + sample_block],
                       n_slots) for r0 in range(0, N, sample_block)]


# Sibling-subtraction reuse (ForestConfig.hist_reuse). Only the *smaller*
# child of every split is histogrammed, into R = max_splits_per_level
# rank segments (samples of large children park in the dump segment);
# ``sibling_expand`` rebuilds the full S-row tensor in rank-paired row
# order — rows [0, R) the small children, rows [R, 2R) their siblings as
# ``parent - small`` — and ``sibling_perm`` maps slots to those rows, so
# only the O(k*S) split descriptors are reordered, never the histogram.
# Unoccupied rows are exactly zero, as direct histograms of empty slots
# are; with integer counts every subtraction is exact, so classification
# forests grown with reuse equal those grown without it bitwise.


def sibling_segments(
    sample_slot: torch.Tensor,   # [k, N] int32 frontier slots, -1 parked
    small_right: torch.Tensor,   # [k, R] int32, 1 = right child is smaller
) -> torch.Tensor:
    """Rank segment of each sample: ``slot // 2`` when its slot is the
    *small* child of its pair, -1 (dump) otherwise. At level 0 the init
    cache (``small_right = 0``) puts every sample in segment 0."""
    R = small_right.shape[1]
    live = sample_slot >= 0
    s = torch.where(live, sample_slot, 0)
    r = s // 2
    side = s - 2 * r
    sr = torch.gather(small_right, 1, torch.clamp_max(r, R - 1).long())
    keep = live & (side == sr) & (r < R)
    return torch.where(keep, r, -1).to(torch.int32)


def sibling_perm(small_right: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Slot -> paired-row map [k, S]: slot ``2r + side`` reads row ``r``
    (small) or ``R + r`` (large); slots past ``2R`` read themselves."""
    k, R = small_right.shape
    s = torch.arange(n_slots, dtype=torch.int32, device=small_right.device)[None, :]
    r = torch.clamp_max(s // 2, R - 1)
    side = s - 2 * r
    sr = torch.gather(small_right, 1, r.expand(k, n_slots).long())
    pair = torch.where(side == sr, r, R + r)
    return torch.where(s < 2 * R, pair, s).to(torch.int32)


def sibling_expand(
    packed: torch.Tensor,       # [k, R, F, B, C] small-child histograms
    cache_hist: torch.Tensor,   # [k, S, F, B, C] previous level, paired rows
    cache_perm: torch.Tensor,   # [k, S] previous level's slot -> row map
    parent: torch.Tensor,       # [k, R] parent *slot* of each rank, -1 invalid
    n_slots: int,
) -> torch.Tensor:
    """The full level histogram [k, S, F, B, C] in rank-paired row order:
    rows [0, R) = ``packed``, rows [R, 2R) = ``parent - packed``, rows
    [2R, S) = zero. Plain PyTorch (a gather and a subtraction), as the
    reference leaves it to XLA."""
    k, R = parent.shape
    valid = parent >= 0
    rows = torch.gather(cache_perm, 1, torch.where(valid, parent, 0).long())
    parent_h = cache_hist[torch.arange(k, device=rows.device)[:, None], rows.long()]
    large = torch.where(valid[:, :, None, None, None], parent_h - packed,
                        torch.zeros((), dtype=packed.dtype, device=packed.device))
    hist = torch.cat([packed, large], dim=1)
    if 2 * R < n_slots:
        hist = torch.nn.functional.pad(hist, (0, 0, 0, 0, 0, 0, 0, n_slots - 2 * R))
    return hist[:, :n_slots]


def class_channels(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """onehot(y) -> [N, C] float32 (labels outside [0, C) give a zero row)."""
    y = y.long()
    valid = (y >= 0) & (y < n_classes)
    oh = torch.nn.functional.one_hot(torch.where(valid, y, 0), n_classes).to(torch.float32)
    return oh * valid[:, None]


def regression_channels(y: torch.Tensor) -> torch.Tensor:
    """[1, y, y^2] -> [N, 3] float32."""
    y = y.to(torch.float32)
    return torch.stack([torch.ones_like(y), y, y * y], dim=-1)
