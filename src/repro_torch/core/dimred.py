"""Dimension reduction in the training process (paper §3.2, Alg. 3.1).

Counterpart of ``repro/core/dimred.py``. Per tree: multiway gain ratio
of every feature on the bootstrap sample (root histograms through
``level_histograms`` with one slot), variable importance (Eq. 7), the
top ``k_imp`` features by importance, and ``m - k_imp`` more drawn
uniformly from the rest.

The uniform draws ``u [k, F]`` are an input (the reference draws them
inside ``select_features`` from its key), so tests can hand in the
reference's draws. Ranks use stable sorts, as JAX's sort is stable.
``dimension_reduction_streamed`` builds the root histograms block by
block from a ``BlockFeeder`` (the streaming data plane).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, host_array, resolve_device
from .gain import multiway_gain_ratio, variable_importance
from .histograms import class_channels, hist_feature_slab, level_histograms
from .types import ForestConfig


def root_gain_ratios(x_binned: torch.Tensor, y: torch.Tensor, weights: torch.Tensor,
                     config: ForestConfig) -> torch.Tensor:
    """GR(y_ij) of every feature on every tree's bootstrap sample. [k, F]."""
    k, N = weights.shape
    F = x_binned.shape[1]
    B, C = config.n_bins, config.n_classes
    base = class_channels(y, C)
    slot0 = torch.zeros((k, N), dtype=torch.int32, device=weights.device)
    W = hist_feature_slab(N, F, 1, B, C)
    parts = []
    for f0 in range(0, F, W):
        hist = level_histograms(
            x_binned[:, f0:f0 + W], base, weights, slot0, n_slots=1, n_bins=B,
            backend=config.hist_backend,
        )                                                # [k, 1, W, B, C]
        parts.append(multiway_gain_ratio(hist[:, 0]))
    return torch.cat(parts, dim=1)


def _rank(v: torch.Tensor) -> torch.Tensor:
    """Rank of each entry in descending order of ``v`` (ties: lower index first)."""
    return torch.argsort(torch.argsort(-v, dim=-1, stable=True), dim=-1, stable=True)


def select_features(gr: torch.Tensor, u: torch.Tensor, *, n_selected: int,
                    n_important: int) -> torch.Tensor:
    """Alg. 3.1 steps 10-19: top-k_imp by VI + (m - k_imp) of the rest by ``u``.

    Args: gr [k, F], u [k, F] uniform draws. Returns mask [k, F] bool.
    """
    top_mask = _rank(variable_importance(gr)) < n_important
    u = torch.where(top_mask, torch.full_like(u, -torch.inf), u)
    rest_mask = _rank(u) < (n_selected - n_important)
    return top_mask | rest_mask


def random_feature_mask(u: torch.Tensor, *, n_selected: int) -> torch.Tensor:
    """Breiman-RF feature selection: the m features with the largest ``u``."""
    return _rank(u) < n_selected


def dimension_reduction(x_binned, y, weights, config: ForestConfig, u) -> torch.Tensor:
    """Full Alg. 3.1. Returns the per-tree feature mask [k, F]."""
    cfg = config.resolved(x_binned.shape[1])
    gr = root_gain_ratios(x_binned, y, weights, cfg)
    return select_features(gr, u, n_selected=cfg.n_selected, n_important=cfg.n_important)


def dimension_reduction_streamed(x_binned, y, weights, config: ForestConfig, u, *,
                                 prefetch: int = 2, device=None) -> torch.Tensor:
    """Alg. 3.1 over host sample blocks (reference:
    ``repro/core/dimred.py:dimension_reduction_streamed``). The root
    histogram is a sum over samples, so each block adds into one
    ``[k, 1, F, B, C]`` carry (``out=``); with integer DSI counts it is
    exact, and the mask equals ``dimension_reduction``'s bitwise (the
    gain ratio is per feature, so scoring all F at once matches the
    resident slab sweep). ``x_binned``: an ``[N, F]`` array or memmap
    (sliced per ``config.sample_block``) or a list of ``[Nb, F]``
    blocks; ``u [k, F]``: the selection's uniform draws. Returns the
    mask [k, F] on ``device`` (default ``cuda``)."""
    from ..data.pipeline import BlockFeeder, stream_blocks

    dev = resolve_device(device)
    y_np = host_array(y)
    w_np = host_array(weights).astype(np.float32, copy=False)
    blocks = stream_blocks(x_binned, config.sample_block, what="dimension_reduction_streamed",
                           n_y=y_np.shape[0], n_w=w_np.shape[1])
    feeder = BlockFeeder(blocks, placement=dev, prefetch=prefetch)
    F = blocks[0].shape[1]
    cfg = config.resolved(F)
    k = w_np.shape[0]
    hist = torch.zeros((k, 1, F, cfg.n_bins, cfg.n_classes), dtype=torch.float32, device=dev)
    o = 0
    with feeder:
        for xb_b in feeder.sweep():
            n = xb_b.shape[0]
            w_b = feeder.pin(w_np[:, o:o + n])
            slot0 = torch.zeros(w_b.shape, dtype=torch.int32, device=dev)
            level_histograms(xb_b, class_channels(feeder.pin(y_np[o:o + n]), cfg.n_classes), w_b,
                             slot0, n_slots=1, n_bins=cfg.n_bins, backend=cfg.hist_backend,
                             out=hist)
            o += n
    gr = multiway_gain_ratio(hist[:, 0])                 # [k, F]
    return select_features(gr, as_tensor(u, dev, torch.float32), n_selected=cfg.n_selected,
                           n_important=cfg.n_important)
