"""Quantile binning (counterpart of ``repro/core/binning.py``).

``fit_bins`` is the reference's numpy code, copied so the port does not
import the JAX package. ``apply_bins`` keeps the float32 boundary
contract: both ``x`` and the float64-fitted edges are compared in
float32, ``searchsorted(right=True)``, so a sample bit-equal to edge
``e_j`` lands in bin ``j + 1``; ``host_digitize`` is the host-side
reference of exactly that rule. Bin ids are ``uint8``, hence the cap of
256 bins (``BinCountError``).

The out-of-core edge fit (``fit_bins_blocked`` over a
``StreamingQuantileSketch``) is a verbatim copy of the reference's numpy
code: below the compression threshold (``2 * DEFAULT_SKETCH_SIZE``
distinct values a feature) its edges equal ``fit_bins`` bitwise, and
above it they equal the reference sketch's bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device

MAX_BINS = 256

# Per-feature summary size the sketch compresses down to. A summary is kept
# exact (uncompressed) until it would exceed 2 * max_size distinct points,
# so any source with <= 2 * DEFAULT_SKETCH_SIZE rows per feature reproduces
# np.quantile bitwise.
DEFAULT_SKETCH_SIZE = 4096


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


def _weighted_quantiles(v: np.ndarray, c: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Quantiles of a weighted sorted summary, replicating np.quantile.

    ``v`` is sorted (any float dtype), ``c`` the float64 cumulative weights
    (``c[-1]`` = total mass W). The rule, bit-for-bit numpy's
    ``method='linear'`` when all weights are 1:

    * virtual position ``pos = q * (W - 1)``; ``lo = floor(pos)``,
      ``gamma = pos - lo`` (float64);
    * bracketing elements ``a = v[searchsorted(c, lo, 'right')]`` and
      ``b = v[searchsorted(c, lo + 1, 'right')]`` (clamped to the last
      element) — ties broken toward the *higher* cumulative rank;
    * two-sided lerp ``b - (b-a)*(1-gamma)`` if ``gamma >= 0.5`` else
      ``a + (b-a)*gamma``, with the difference ``b - a`` computed in the
      *source dtype* (float32 in -> float32 diff) exactly as numpy does.
    """
    total = c[-1]
    pos = qs * (total - 1.0)
    lo = np.floor(pos)
    gamma = pos - lo
    last = v.size - 1
    ia = np.minimum(np.searchsorted(c, lo, side="right"), last)
    ib = np.minimum(np.searchsorted(c, lo + 1.0, side="right"), last)
    a = v[ia]
    b = v[ib]
    diff = b - a  # source dtype on purpose — bitwise parity with np.quantile
    return np.where(gamma >= 0.5, b - diff * (1.0 - gamma), a + diff * gamma)


class StreamingQuantileSketch:
    """Mergeable per-feature quantile summary with deterministic compression.

    Feed ``[n_block, F]`` blocks via :meth:`update`; combine shard sketches
    with :meth:`merge`; read per-feature quantiles/edges at the end. Memory
    is bounded by O(F * max_size) points independent of total rows.

    Deterministic rules (no RNG, no order sensitivity beyond float
    associativity in weight sums — weights are integer-valued counts until
    a compression, so uncompressed merges are exactly associative):

    * Values are kept in the source float dtype (integers promote to
      float64, matching ``np.quantile``); exact duplicates are coalesced by
      summing weights, which preserves the CDF exactly.
    * A summary is exact until it would exceed ``2 * max_size`` points;
      it is then recompressed to ``max_size`` representatives: bucket j of
      equal mass ``W / max_size`` is represented by the element at
      cumulative mass ``W * (j + 0.5) / max_size`` (ties toward the higher
      rank), carrying the bucket's full mass. Rank error after k
      compressions is at most ``k / (2 * max_size)`` of total mass.
    * Quantiles interpolate exactly like ``np.quantile(method='linear')``
      — see :func:`_weighted_quantiles` — so while every feature summary
      is uncompressed the result is **bitwise identical** to the resident
      ``fit_bins``.
    * NaN cells are dropped (deterministically — the validator's screening
      masks arrive via ``update(exclude=...)`` for cells that were imputed
      upstream); ±inf are kept, as ``np.quantile`` would.
    * A feature with no surviving samples yields edges of 0.0.
    """

    def __init__(self, n_features: int, *, max_size: int = DEFAULT_SKETCH_SIZE):
        if n_features < 1:
            raise ValueError(f"n_features must be >= 1, got {n_features}")
        if max_size < 2:
            raise ValueError(f"max_size must be >= 2, got {max_size}")
        self.n_features = int(n_features)
        self.max_size = int(max_size)
        self._v = [np.empty(0, np.float64) for _ in range(self.n_features)]
        self._w = [np.empty(0, np.float64) for _ in range(self.n_features)]
        self._compressed = np.zeros(self.n_features, np.bool_)
        self.count = np.zeros(self.n_features, np.int64)
        self._vdtype: np.dtype | None = None

    # -- properties ------------------------------------------------------

    @property
    def exact(self) -> bool:
        """True while every feature summary is an exact (uncompressed) CDF."""
        return not bool(self._compressed.any())

    @property
    def value_dtype(self) -> np.dtype:
        return np.dtype(self._vdtype if self._vdtype is not None else np.float64)

    def summary_sizes(self) -> np.ndarray:
        """Stored points per feature (memory = sum * 16 bytes, roughly)."""
        return np.array([v.size for v in self._v], np.int64)

    # -- ingest ----------------------------------------------------------

    def _promote(self, dtype: np.dtype) -> None:
        dt = np.dtype(dtype)
        if not np.issubdtype(dt, np.floating):
            dt = np.dtype(np.float64)  # np.quantile promotes ints to float64
        if self._vdtype is None:
            self._vdtype = dt
        elif dt != self._vdtype:
            target = np.result_type(self._vdtype, dt)
            if target != self._vdtype:
                self._v = [v.astype(target) for v in self._v]
                self._vdtype = target

    def update(self, block, exclude=None) -> "StreamingQuantileSketch":
        """Absorb one ``[n_block, F]`` block.

        ``exclude`` (optional ``[n_block, F]`` bool) marks cells to leave
        out — the streamed trainer passes the validator's imputed-cell
        masks here so sanitized blocks contribute only their finite,
        original values.
        """
        b = np.asarray(block)
        if b.ndim != 2 or b.shape[1] != self.n_features:
            raise ValueError(
                f"expected [n, {self.n_features}] block, got shape {b.shape}"
            )
        if b.shape[0] == 0:
            return self
        self._promote(b.dtype)
        ex = None
        if exclude is not None:
            ex = np.asarray(exclude, np.bool_)
            if ex.shape != b.shape:
                raise ValueError(
                    f"exclude mask shape {ex.shape} != block shape {b.shape}"
                )
        for f in range(self.n_features):
            col = b[:, f]
            if ex is not None:
                col = col[~ex[:, f]]
            col = col[~np.isnan(col)]
            if col.size == 0:
                continue
            self.count[f] += col.size
            v = np.sort(col.astype(self._vdtype, copy=False))
            self._insert(f, v, np.ones(v.size, np.float64))
        return self

    def merge(self, other: "StreamingQuantileSketch") -> "StreamingQuantileSketch":
        """Fold another sketch in (exact while both are uncompressed)."""
        if other.n_features != self.n_features:
            raise ValueError(
                f"cannot merge sketches over {other.n_features} vs "
                f"{self.n_features} features"
            )
        # Only a sketch that actually holds points can force a dtype
        # promotion — merging an empty (e.g. blockless-shard) sketch must
        # be a strict no-op, or it would widen f32 summaries to f64 and
        # break bitwise parity with np.quantile on f32 sources.
        if other._vdtype is not None and any(v.size for v in other._v):
            self._promote(other._vdtype)
        for f in range(self.n_features):
            ov = other._v[f]
            if ov.size:
                self._insert(f, ov.astype(self.value_dtype, copy=False), other._w[f])
        self.count += other.count
        self._compressed |= other._compressed
        return self

    def _insert(self, f: int, v: np.ndarray, w: np.ndarray) -> None:
        if self._v[f].size:
            v = np.concatenate([self._v[f], v])
            w = np.concatenate([self._w[f], w])
            order = np.argsort(v, kind="stable")
            v = v[order]
            w = w[order]
        if v.size > 1:
            keep = np.empty(v.size, np.bool_)
            keep[0] = True
            np.not_equal(v[1:], v[:-1], out=keep[1:])
            if not keep.all():
                idx = np.cumsum(keep) - 1
                w = np.bincount(idx, weights=w)
                v = v[keep]
        if v.size > 2 * self.max_size:
            v, w = self._compress(v, w)
            self._compressed[f] = True
        self._v[f] = v
        self._w[f] = w

    def _compress(self, v: np.ndarray, w: np.ndarray):
        """Deterministic recompression to ``max_size`` representatives."""
        c = np.cumsum(w)
        total = c[-1]
        m = self.max_size
        t = total * (np.arange(m, dtype=np.float64) + 0.5) / m
        idx = np.minimum(np.searchsorted(c, t, side="right"), v.size - 1)
        nv = v[idx]
        nw = np.full(m, total / m, np.float64)
        keep = np.empty(m, np.bool_)
        keep[0] = True
        np.not_equal(nv[1:], nv[:-1], out=keep[1:])
        if not keep.all():
            gi = np.cumsum(keep) - 1
            nw = np.bincount(gi, weights=nw)
            nv = nv[keep]
        return nv, nw

    # -- readout ---------------------------------------------------------

    def quantiles(self, qs) -> np.ndarray:
        """Per-feature quantiles, [F, len(qs)] float64."""
        qs = np.asarray(qs, np.float64)
        out = np.zeros((self.n_features, qs.size), np.float64)
        for f in range(self.n_features):
            v = self._v[f]
            if v.size == 0:
                continue  # empty feature -> 0.0 edges (documented)
            c = np.cumsum(self._w[f])
            out[f] = _weighted_quantiles(v, c, qs)
        return out

    def edges(self, n_bins: int) -> np.ndarray:
        """Bin edges [F, n_bins-1] float64 — same contract as ``fit_bins``."""
        n_bins = validate_n_bins(n_bins)
        qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
        e = self.quantiles(qs)
        return np.maximum.accumulate(e, axis=1)

    # -- serialization (mesh exchange) -----------------------------------

    def state(self, pad_to: int | None = None) -> dict:
        """Dense-array snapshot for cross-shard exchange.

        Values are carried as float64 (exact for any narrower float) with
        the source dtype recorded, so ``from_state`` round-trips bitwise.
        ``pad_to`` fixes the row width (required for collective transport,
        where every shard must ship the same shape; stored summaries never
        exceed ``2 * max_size`` points).
        """
        m = max(int(v.size) for v in self._v)
        width = m if pad_to is None else int(pad_to)
        if width < m:
            raise ValueError(f"pad_to={pad_to} < largest summary {m}")
        width = max(width, 1)
        vals = np.zeros((self.n_features, width), np.float64)
        wts = np.zeros((self.n_features, width), np.float64)
        for f in range(self.n_features):
            vals[f, : self._v[f].size] = self._v[f]
            wts[f, : self._w[f].size] = self._w[f]
        return {
            "values": vals,
            "weights": wts,
            "count": self.count.copy(),
            "compressed": self._compressed.copy(),
            "value_dtype": self.value_dtype.str,
            "max_size": self.max_size,
        }

    @classmethod
    def from_state(cls, state: dict) -> "StreamingQuantileSketch":
        vals = np.asarray(state["values"], np.float64)
        wts = np.asarray(state["weights"], np.float64)
        sk = cls(vals.shape[0], max_size=int(state["max_size"]))
        vdt = np.dtype(state["value_dtype"])
        sk._vdtype = vdt
        for f in range(sk.n_features):
            live = wts[f] > 0  # padding rows carry weight 0
            sk._v[f] = vals[f, live].astype(vdt, copy=False)
            sk._w[f] = wts[f, live].copy()
        sk.count = np.asarray(state["count"], np.int64).copy()
        sk._compressed = np.asarray(state["compressed"], np.bool_).copy()
        return sk


def fit_bins(x: np.ndarray, n_bins: int = 64) -> np.ndarray:
    """Per-feature quantile bin edges [F, B-1] float64, ascending."""
    n_bins = validate_n_bins(n_bins)
    x = np.asarray(x)
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T  # [F, B-1]
    return np.maximum.accumulate(edges, axis=1)


def fit_bins_blocked(
    blocks,
    n_bins: int = 64,
    *,
    exclude_masks=None,
    max_size: int = DEFAULT_SKETCH_SIZE,
) -> np.ndarray:
    """Out-of-core bin-edge fitting over an iterable of ``[n_i, F]`` blocks.

    One pass, O(block) + O(F * max_size) memory: each block is absorbed
    into a :class:`StreamingQuantileSketch` and released. While the total
    distinct values per feature stay <= ``2 * max_size`` the result is
    bitwise identical to ``fit_bins`` over the concatenated blocks;
    beyond that the sketch compresses deterministically with bounded rank
    error (same blocks -> same edges, always).

    Args:
      blocks: iterable of [n_i, F] arrays (e.g. ``sample_blocks`` views of
        an ``np.memmap``); ragged last block fine.
      n_bins: number of bins in [2, 256].
      exclude_masks: optional per-block bool cell masks (True = leave the
        cell out). Either a sequence aligned with ``blocks`` (None entries
        allowed) or a dict keyed by block position — the streamed trainer
        passes the validator's imputed-cell masks this way.
      max_size: per-feature summary budget (see the sketch docstring).

    Returns:
      edges: [F, n_bins-1] float64, ascending per feature.
    """
    n_bins = validate_n_bins(n_bins)
    sketch = None
    for i, b in enumerate(blocks):
        b = np.asarray(b)
        if sketch is None:
            sketch = StreamingQuantileSketch(b.shape[1], max_size=max_size)
        if exclude_masks is None:
            mask = None
        elif isinstance(exclude_masks, dict):
            mask = exclude_masks.get(i)
        else:
            mask = exclude_masks[i]
        sketch.update(b, exclude=mask)
    if sketch is None:
        raise ValueError("fit_bins_blocked: no blocks provided")
    return sketch.edges(n_bins)


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


def bin_dataset(x: np.ndarray, n_bins: int = 64, *, device=None):
    """Fit + apply. Returns (binned [N, F] uint8 tensor on ``device``, edges).
    ``device`` as ``device.resolve_device``: ``cuda`` unless the caller asks
    for the CPU, and ``RuntimeError`` without a card. Spans: ``binning.fit``
    (the host's quantiles), ``binning.copy`` (to the device),
    ``binning.digitize`` (``apply_bins``)."""
    device = resolve_device(device)
    with tracing.span("binning.fit"):
        edges = fit_bins(x, n_bins)
    with tracing.span("binning.copy"):
        xt = torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))).to(device)
        edges_dev = torch.from_numpy(edges).to(device)
    with tracing.span("binning.digitize"):
        return apply_bins(xt, edges_dev), edges
