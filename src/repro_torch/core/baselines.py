"""The paper's comparison algorithms (§5): original RF and Spark-MLRF-like.

Counterpart of ``repro/core/baselines.py``:

* ``train_rf``        — Breiman RF as the paper describes it (§3.1): m
  features drawn uniformly per tree, unweighted majority voting
  (``train_prf`` under ``rf_config``).
* ``train_mlrf_like`` — Spark MLlib RF's accuracy-relevant deviation:
  split candidates come from a sampled subset of the data. Bin edges are
  fit on a fixed ``sample_budget`` subsample, so as N grows with a fixed
  budget the quantiles get coarser and accuracy decays (the paper's
  Fig. 9). No screening, no OOB weights: ``tree_weight`` stays as growth
  leaves it. ``fit_mlrf_like_from_draws`` is everything after its random
  draws, where tests hand in the reference's subsample, DSI counts and
  uniforms.

Both reuse the PRF growth engine and its kernels (the algorithms differ
in sampling, feature selection, voting and data motion, not in the split
criterion). ``data_volume_bytes`` is the §4.3.2 volume model of Fig. 14.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from .api import PRFModel, train_prf
from .binning import apply_bins, fit_bins
from .dimred import random_feature_mask
from .dsi import bootstrap_counts
from .forest import grow_forest
from .types import ForestConfig


def rf_config(config: ForestConfig) -> ForestConfig:
    """The baselines' config: random per-tree features, plain majority vote."""
    return dataclasses.replace(config, feature_mode="random", weighted_voting=False)


def train_rf(x: np.ndarray, y: np.ndarray, config: ForestConfig, seed: int = 0, *,
             device=None) -> PRFModel:
    """Original RF baseline: ``train_prf`` under ``rf_config``."""
    return train_prf(x, y, rf_config(config), seed=seed, device=device)


def train_mlrf_like(x: np.ndarray, y: np.ndarray, config: ForestConfig, seed: int = 0,
                    sample_budget: int = 2000, *, device=None) -> PRFModel:
    """Spark-MLRF-style: split thresholds from a bounded random subsample.

    The subsample is the reference's, ``np.random.default_rng(seed)
    .choice(n, min(sample_budget, n), replace=False)``; the DSI counts and
    the feature-selection uniforms come from a ``torch.Generator`` on the
    device seeded with ``seed`` (``train_prf``'s draws, not JAX's)."""
    dev = resolve_device(device)
    n, f = np.shape(x)
    idx = np.random.default_rng(seed).choice(n, size=min(sample_budget, n), replace=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    weights = bootstrap_counts(gen, config.n_trees, n, dev)
    u = torch.rand((config.n_trees, f), generator=gen, device=dev)
    return fit_mlrf_like_from_draws(x, y, config, idx, weights, u, device=dev)


def fit_mlrf_like_from_draws(x: np.ndarray, y: np.ndarray, config: ForestConfig, idx, weights, u,
                             *, device=None) -> PRFModel:
    """``train_mlrf_like`` after its draws: ``idx`` the subsample's rows,
    ``weights [k, N]`` the DSI counts, ``u [k, F]`` the uniforms whose
    ``n_selected`` largest pick each tree's features. Edges are fit on
    ``x[idx]`` (host), every row is binned on the device, then growth."""
    dev = resolve_device(device)
    cfg = rf_config(config).resolved(np.shape(x)[1])
    edges = fit_bins(np.asarray(x)[np.asarray(idx)], cfg.n_bins)   # <- sampled split candidates
    xb = apply_bins(as_tensor(x, dev), torch.from_numpy(edges).to(dev))
    mask = random_feature_mask(as_tensor(u, dev, torch.float32), n_selected=cfg.n_selected)
    y_t = as_tensor(np.asarray(y), dev, torch.float32 if cfg.regression else None)
    forest = grow_forest(xb, y_t, weights, cfg, mask, device=dev)
    return PRFModel(forest=forest, bin_edges=edges)


# ---------------------------------------------------------------------------
# Analytical data-volume model (paper §4.3.2 / Fig. 14)
# ---------------------------------------------------------------------------


def data_volume_bytes(algorithm: str, n_samples: int, n_features: int, n_trees: int,
                      value_bytes: int = 8) -> int:
    """Training-set volume each algorithm materialises.

    Paper: RF and Spark-MLRF sample copies -> N*M*k; PRF keeps one
    vertical copy + the DSI -> ~2*N*M, flat in k. The binned
    implementation (``"prf-tpu"``, the reference's name) goes further: one
    binned copy (N*M uint8) + k*N float32 in-bag counts.
    """
    N, M, k = n_samples, n_features, n_trees
    if algorithm in ("rf", "spark-mlrf"):
        return N * M * k * value_bytes
    if algorithm == "prf-paper":                     # vertical FS_j = <idx, y_j, y_target>
        return 2 * N * M * value_bytes
    if algorithm == "prf-tpu":                       # binned matrix + DSI counts
        return N * M * 1 + k * N * 4
    raise ValueError(algorithm)
