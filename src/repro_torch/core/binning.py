"""Quantile binning (counterpart of ``repro/core/binning.py``).

``fit_bins`` is the reference's numpy code, copied so the port does not
import the JAX package. ``apply_bins`` keeps the float32 boundary
contract: both ``x`` and the float64-fitted edges are compared in
float32, ``searchsorted(right=True)``, so a sample bit-equal to edge
``e_j`` lands in bin ``j + 1``; ``host_digitize`` is the host-side
reference of exactly that rule. Bin ids are ``uint8``, hence the cap of
256 bins (``BinCountError``).

The streaming sketch (``fit_bins_blocked``) is not ported in this slice.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_BINS = 256


class BinCountError(ValueError):
    """Raised when n_bins (or an edges array) exceeds the uint8 bin-id range."""


def validate_n_bins(n_bins) -> int:
    """Validate ``2 <= n_bins <= MAX_BINS``; returns the int value."""
    if isinstance(n_bins, bool) or not isinstance(n_bins, (int, np.integer)):
        raise BinCountError(
            f"n_bins must be an int, got {type(n_bins).__name__}: {n_bins!r}"
        )
    n = int(n_bins)
    if not 2 <= n <= MAX_BINS:
        raise BinCountError(
            f"n_bins must be in [2, {MAX_BINS}] (bin ids are uint8; larger "
            f"counts would silently wrap), got {n}"
        )
    return n


def fit_bins(x: np.ndarray, n_bins: int = 64) -> np.ndarray:
    """Per-feature quantile bin edges [F, B-1] float64, ascending."""
    n_bins = validate_n_bins(n_bins)
    x = np.asarray(x)
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T  # [F, B-1]
    return np.maximum.accumulate(edges, axis=1)


def apply_bins(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Digitize [N, F] features into uint8 bin ids with [F, B-1] edges.

    Runs on the device of ``x``; both operands are cast to float32.
    """
    if edges.shape[-1] > MAX_BINS - 1:
        raise BinCountError(
            f"edges has {edges.shape[-1]} boundaries -> {edges.shape[-1] + 1} "
            f"bins, beyond the uint8 limit of {MAX_BINS}"
        )
    xf = x.to(torch.float32)
    ef = edges.to(device=x.device, dtype=torch.float32).contiguous()
    bins = torch.searchsorted(ef, xf.t().contiguous(), right=True)   # [F, N]
    return bins.t().to(torch.uint8).contiguous()


def host_digitize(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Host-side reference for ``apply_bins``' float32 boundary contract."""
    xf = np.asarray(x, np.float32)
    ef = np.asarray(edges, np.float32)
    out = np.empty(xf.shape, np.uint8)
    for f in range(ef.shape[0]):
        out[:, f] = np.searchsorted(ef[f], xf[:, f], side="right")
    return out


def bin_dataset(x: np.ndarray, n_bins: int = 64, *, device="cpu"):
    """Fit + apply. Returns (binned [N, F] uint8 tensor on ``device``, edges)."""
    edges = fit_bins(x, n_bins)
    xt = torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))).to(device)
    return apply_bins(xt, torch.from_numpy(edges).to(device)), edges
