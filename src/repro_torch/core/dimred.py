"""Dimension reduction in the training process (paper §3.2, Alg. 3.1).

Counterpart of ``repro/core/dimred.py``. Per tree: multiway gain ratio
of every feature on the bootstrap sample (root histograms through
``level_histograms`` with one slot), variable importance (Eq. 7), the
top ``k_imp`` features by importance, and ``m - k_imp`` more drawn
uniformly from the rest.

The uniform draws ``u [k, F]`` are an input (the reference draws them
inside ``select_features`` from its key), so tests can hand in the
reference's draws. Ranks use stable sorts, as JAX's sort is stable.
"""
from __future__ import annotations

import torch

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
