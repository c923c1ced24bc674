"""Data-Sampling-Index (DSI) table (counterpart of ``repro/core/dsi.py``).

Histogram training only needs *how many times* each sample was drawn, so
the ``[k, N]`` bootstrap index table collapses into ``counts[k, N]``
in-bag weights. The port draws with an explicit ``torch.Generator``;
its numbers differ from JAX's threefry draws, so parity tests build the
index table with numpy (or take the reference's counts) and hand it in.
"""
from __future__ import annotations

import torch


def make_dsi(generator: torch.Generator, n_trees: int, n_samples: int,
             device=None) -> torch.Tensor:
    """Bootstrap index table [k, N] int64, rows i.i.d. uniform with replacement."""
    return torch.randint(
        0, n_samples, (n_trees, n_samples), generator=generator,
        device=device if device is not None else generator.device,
    )


def dsi_counts(dsi: torch.Tensor, n_samples: int) -> torch.Tensor:
    """counts[t, i] = #{j : dsi[t, j] == i}, float32 [k, N]."""
    counts = torch.zeros((dsi.shape[0], n_samples), dtype=torch.float32, device=dsi.device)
    ones = torch.ones(dsi.shape, dtype=torch.float32, device=dsi.device)
    return counts.scatter_add_(1, dsi.long(), ones)


def oob_mask(counts: torch.Tensor) -> torch.Tensor:
    """Out-Of-Bag mask [k, N] bool — samples never drawn by tree t."""
    return counts == 0.0


def bootstrap_counts(generator: torch.Generator, n_trees: int, n_samples: int,
                     device=None) -> torch.Tensor:
    """make_dsi + dsi_counts."""
    return dsi_counts(make_dsi(generator, n_trees, n_samples, device), n_samples)
