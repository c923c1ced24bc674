"""Synthetic tabular classification/regression generators (numpy copy of
``repro/data/tabular.py``, so the port does not import the JAX package).

Mirrors the traits of the paper's datasets (Tables 3-4): large N, high
dimensionality M, many classes, heavy noise — without shipping UCI data.
A fraction of features is informative (class-conditional Gaussian blobs),
a fraction is redundant (linear mixes of informative ones), the rest is
pure noise; a label-noise rate flips a share of labels, reproducing the
"noisy data" regime the paper's accuracy experiments target.
"""
from __future__ import annotations

import numpy as np


def make_classification(
    n_samples: int = 4096,
    n_features: int = 64,
    n_classes: int = 4,
    n_informative: int = 12,
    n_redundant: int = 8,
    class_sep: float = 1.6,
    label_noise: float = 0.05,
    seed: int = 0,
):
    """Returns (x [N, M] float32, y [N] int32)."""
    rng = np.random.default_rng(seed)
    n_informative = min(n_informative, n_features)
    n_redundant = min(n_redundant, n_features - n_informative)

    centers = rng.normal(0.0, class_sep, (n_classes, n_informative))
    y = rng.integers(0, n_classes, n_samples)
    x_inf = centers[y] + rng.normal(0.0, 1.0, (n_samples, n_informative))

    mix = rng.normal(0.0, 1.0, (n_informative, n_redundant))
    x_red = x_inf @ mix / np.sqrt(n_informative)

    n_noise = n_features - n_informative - n_redundant
    x_noise = rng.normal(0.0, 1.0, (n_samples, n_noise))

    x = np.concatenate([x_inf, x_red, x_noise], axis=1).astype(np.float32)
    perm = rng.permutation(n_features)
    x = x[:, perm]

    flip = rng.random(n_samples) < label_noise
    y = np.where(flip, rng.integers(0, n_classes, n_samples), y)
    return x, y.astype(np.int32)


def make_regression(
    n_samples: int = 4096,
    n_features: int = 32,
    n_informative: int = 8,
    noise: float = 0.1,
    seed: int = 0,
):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (n_samples, n_features)).astype(np.float32)
    w = np.zeros(n_features)
    idx = rng.choice(n_features, min(n_informative, n_features), replace=False)
    w[idx] = rng.normal(0.0, 1.0, len(idx))
    y = np.tanh(x @ w) + noise * rng.normal(0.0, 1.0, n_samples)
    return x, y.astype(np.float32)


def train_test_split(x, y, test_frac=0.25, seed=0):
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    return x[tr], y[tr], x[te], y[te]
