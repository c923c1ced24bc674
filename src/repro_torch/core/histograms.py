"""Weighted class-histogram construction — the T_GR stage (paper §4.2.1).

Counterpart of ``repro/core/histograms.py``. ``level_histograms`` is the
one entry point for every histogram the trainer builds (growth and
dimension reduction). Backends, by ``ForestConfig.hist_backend``:

* ``"pallas"``      — the CUDA kernel ``csrc/gain_ratio_hist.cu``;
* ``"segment_sum"`` — its plain PyTorch version (``kernels/gain_ratio/ref.py``);
* ``"auto"``        — the kernel for CUDA tensors, the plain version on the CPU.

The per-tree DSI weight multiply is applied inside the per-tree step, so
the ``[k, N, C]`` weighted-channel tensor never exists. A feature slab is
a column slice view of the ``[N, F]`` bins (no copy); its histogram
equals the slice of the full one, since every feature is independent.
The kernel walks each tree's live samples grouped by slot
(``slot_order``); a caller that builds several slabs from one level
makes the grouping once and passes it to each.
"""
from __future__ import annotations

from typing import Optional

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
) -> torch.Tensor:
    """hist[t,s,f,b,c] = sum_i w[t,i] * base[i,c] * [slot_i = s] * [x_if = b].

    Returns [k, S, F, B, C] float32. ``order`` only steers the kernel;
    the plain version gives the same histogram without it.
    """
    backend = resolve_backend(backend, x_binned.device)
    if backend == "pallas":
        from ..kernels.gain_ratio.ops import multi_tree_hist

        return multi_tree_hist(
            x_binned, base_channels, weights, sample_slot,
            n_slots=n_slots, n_bins=n_bins, packed=packed, order=order,
        )
    from ..kernels.gain_ratio.ref import multi_tree_hist_ref

    return multi_tree_hist_ref(
        x_binned, base_channels, weights, sample_slot,
        n_slots=n_slots, n_bins=n_bins, packed=packed,
    )


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
