"""Entropy / gain ratio / variable importance (paper Eq. 2-7).

Counterpart of ``repro/core/gain.py``. Every quantity comes from
weighted class histograms ``hist[t, s, f, b, c]``; one cumulative sum
over the bin axis scores every candidate binary split at once.

Sums over the small class/channel axis are taken **sequentially**
(``_csum``), the order the CUDA split-scan kernel (``csrc/split_scan.cu``)
uses per thread, so the plain version and the kernel round op for op.
The log is the reference CPU backend's own (``_log``) and the one
multiply-add its compiler fuses in Eq. (3) is fused here too
(``_fma``), so split gains — and with them the beam ranking of splits
and every pool id — match the reference bitwise on the CPU, and the
plain version and the kernel on the card.

1e-38 is a subnormal float32 that XLA on the CPU flushes to zero while
PyTorch and CUDA keep it. Where a ``where`` guard masks the rows it
protects, the reference's ``maximum(x, 1e-38)`` stays. The two guards
that reach a result unmasked (``multiway_gain_ratio``'s sample count
and ``variable_importance``'s sum) are ``maximum(x, 0)`` here, the
reference as it runs: a zero-mass row is 0/0 = NaN in both.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_TINY = 1e-38
_SPLIT_INFO_FLOOR = 1e-12


def _csum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (``((x0 + x1) + x2) + ...``)."""
    s = x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c]
    return s


def _bin_cumsum(hist: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the bin axis (-2) in float32, left to right:
    the reference's ``jnp.cumsum`` on the CPU and the split-scan kernel's
    regression lanes. (``torch.cumsum`` on the CPU accumulates float32 in
    float64: the same values for integer counts, other roundings for the
    regression channels ``y`` and ``y^2``.)"""
    cum = hist.clone()
    for b in range(1, hist.shape[-2]):
        cum[..., b, :] += cum[..., b - 1, :]
    return cum


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (a fused multiply-add).

    PyTorch has no fused multiply-add op, so the product and sum are
    formed in float64 (the product of two float32s is exact there) and
    the one case where rounding the float64 sum to float32 can differ
    from rounding the exact value — the sum landing exactly on a float32
    midpoint — is settled with the sum's exact error term (TwoSum).
    """
    a, b, c = torch.broadcast_tensors(
        torch.as_tensor(a, dtype=torch.float32),
        torch.as_tensor(b, dtype=torch.float32, device=a.device if torch.is_tensor(a) else None),
        torch.as_tensor(c, dtype=torch.float32, device=a.device if torch.is_tensor(a) else None),
    )
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)            # s + err == p + c exactly
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, torch.full_like(r, torch.inf), torch.full_like(r, -torch.inf))
    nxt = torch.nextafter(r, toward)
    tie = (d != 0) & (d == (nxt.double() - r.double()) / 2)
    return torch.where(tie & (err * d > 0), nxt, r)


_MIN_NORMAL = 1.17549435e-38
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)


def _log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 values, bit for bit the log of the
    reference's CPU backend (XLA's Cephes polynomial, evaluated with fused
    multiply-adds). ``csrc/split_scan.cu`` evaluates the same sequence with
    ``fmaf``, so the reference, the plain version and the kernel agree
    bitwise on every gain. Arguments below the smallest normal float are
    clamped to it; no caller passes zero, negatives or NaN.

    Probabilities of integer counts take few distinct values, so the
    polynomial runs once per distinct value. The values are grouped by
    their bit patterns: equal bits are equal values here (the clamp leaves
    no zeros of either sign), and on the CPU the integer sort is several
    times faster than the float one."""
    bits = torch.clamp_min(x.to(torch.float32), _MIN_NORMAL).contiguous().view(torch.int32)
    vals, inverse = torch.unique(bits, return_inverse=True)
    return _log_poly(vals.view(torch.float32))[inverse]


def _log_poly(x: torch.Tensor) -> torch.Tensor:
    i = x.view(torch.int32)
    m = ((i & ~0x7F800000) | 0x3F000000).view(torch.float32)    # mantissa in [0.5, 1)
    e = 1.0 + ((i >> 23) - 0x7F).to(torch.float32)
    below = m < 0.707106781186547524
    m_lo = torch.where(below, m, torch.zeros_like(m))
    m = m - 1.0
    e = e - below.to(torch.float32)
    m = m + m_lo
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, -2.12194440e-4 * e)
    m = m - x2 * 0.5
    m = m + y
    return m + 0.693359375 * e


def _xlogx(p: torch.Tensor) -> torch.Tensor:
    """x * log(x), safe at 0 (0 log 0 := 0)."""
    return torch.where(p > 0, p * _log(torch.clamp_min(p, _TINY)), torch.zeros_like(p))


def entropy_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Shannon entropy over the last axis of an unnormalized count vector. Eq. (2)."""
    total = _csum(counts)[..., None]
    p = counts / torch.clamp_min(total, _TINY)
    return -_csum(_xlogx(p))


class SplitScores(NamedTuple):
    """Per-(tree, slot) best split, after the T_NS argmax."""

    gain_ratio: torch.Tensor    # [k, S] best gain ratio
    feature: torch.Tensor       # [k, S] int32 best feature
    threshold: torch.Tensor     # [k, S] int32 best bin threshold (left: bin <= thr)
    left_counts: torch.Tensor   # [k, S, C] class counts of left child
    right_counts: torch.Tensor  # [k, S, C] class counts of right child


def split_gain_ratios_from_cumsum(cum: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Eq. (2)-(6) from bin prefix sums.

    Args:
      cum:   [..., F, B, C] ``cumsum(hist, dim=-2)``.
      total: [..., F, C] node class counts (``cum[..., -1, :]``).
    Returns:
      gr: [..., F, B-1]; invalid (empty-side) splits get -inf.
    """
    n = _csum(total)                                 # [..., F]
    h_node = entropy_from_counts(total)              # [..., F]

    left = cum[..., :-1, :]                          # [..., F, B-1, C]
    right = total[..., None, :] - left
    n_l = _csum(left)                                # [..., F, B-1]
    n_r = _csum(right)
    n_tot = torch.clamp_min(n[..., None], _TINY)

    # Eq. (3). The reference's CPU compiler contracts this sum into one
    # fused multiply-add around the right-hand product; so do we.
    h_cond = _fma(
        n_r / n_tot, entropy_from_counts(right),
        (n_l / n_tot) * entropy_from_counts(left),
    )
    gain = h_node[..., None] - h_cond                # Eq. (5)

    p_l = n_l / n_tot
    p_r = n_r / n_tot
    split_info = -(_xlogx(p_l) + _xlogx(p_r))        # Eq. (4)

    gr = gain / torch.clamp_min(split_info, _SPLIT_INFO_FLOOR)   # Eq. (6)
    valid = (n_l > 0) & (n_r > 0)
    return torch.where(valid, gr, torch.full_like(gr, -torch.inf))


def split_gain_ratios(hist: torch.Tensor) -> torch.Tensor:
    """Gain ratio of every candidate split of [..., F, B, C] histograms."""
    cum = _bin_cumsum(hist)
    return split_gain_ratios_from_cumsum(cum, cum[..., -1, :])


def variance_gains_from_cumsum(cum: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Regression analogue over [count, sum, sumsq] channels. [..., F, B-1]."""

    def sse(h):
        return h[..., 2] - h[..., 1] * h[..., 1] / torch.clamp_min(h[..., 0], _TINY)

    left = cum[..., :-1, :]
    right = total[..., None, :] - left
    gain = sse(total)[..., None] - sse(left) - sse(right)
    valid = (left[..., 0] > 0) & (right[..., 0] > 0)
    return torch.where(valid, gain, torch.full_like(gain, -torch.inf))


def _select_winners(gr: torch.Tensor, cum: torch.Tensor, total: torch.Tensor) -> SplitScores:
    """T_NS argmax (first occurrence) + child counts from the scoring cumsum."""
    k, S, F, B, C = cum.shape
    flat = gr.reshape(k, S, F * (B - 1))
    best = torch.argmax(flat, dim=-1)                # [k, S], first maximum
    best_gr = torch.gather(flat, -1, best[..., None])[..., 0]
    best_f = torch.div(best, B - 1, rounding_mode="floor")
    best_thr = best - best_f * (B - 1)

    cum_f = torch.gather(
        cum, 2, best_f[..., None, None, None].expand(k, S, 1, B, C)
    )[:, :, 0]                                       # [k, S, B, C]
    left_counts = torch.gather(
        cum_f, 2, best_thr[..., None, None].expand(k, S, 1, C)
    )[:, :, 0]
    total_f = torch.gather(
        total, 2, best_f[..., None, None].expand(k, S, 1, C)
    )[:, :, 0]
    right_counts = total_f - left_counts
    return SplitScores(
        best_gr, best_f.to(torch.int32), best_thr.to(torch.int32),
        left_counts, right_counts,
    )


def _mask_scores(sc: torch.Tensor, feature_mask) -> torch.Tensor:
    if feature_mask is None:
        return sc
    return torch.where(
        feature_mask.bool()[:, None, :, None], sc, torch.full_like(sc, -torch.inf)
    )


def best_splits(hist: torch.Tensor, feature_mask=None) -> SplitScores:
    """The node-splitting task T_NS: global best split of [k, S, F, B, C]."""
    cum = _bin_cumsum(hist)
    total = cum[..., -1, :]
    gr = _mask_scores(split_gain_ratios_from_cumsum(cum, total), feature_mask)
    return _select_winners(gr, cum, total)


def node_counts(scores: SplitScores, *, regression: bool = False) -> torch.Tensor:
    """Node sample count [k, S] recovered from the winner's child counts."""
    if regression:
        return scores.left_counts[..., 0] + scores.right_counts[..., 0]
    return _csum(scores.left_counts) + _csum(scores.right_counts)


def sibling_plan(
    scores: SplitScores,
    split_rank: torch.Tensor,   # [k, S] int32 dense rank of admitted splits, -1 else
    is_split: torch.Tensor,     # [k, S] bool
    *,
    n_ranks: int,               # R = ForestConfig.max_splits_per_level
    regression: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plan next level's sibling-subtraction reuse (``hist_reuse``).

    For every admitted split rank r: its parent frontier slot, and which
    child is the *smaller* one (fewer weighted samples, read off the
    winner's child counts; ties go left) — the only child the next level
    histograms directly; the sibling is ``parent - small``.

    Returns ``(parent [k, R] int32 slot, -1 for unused ranks;
    small_right [k, R] int32, 1 = the right child is the small one)``.
    """
    k, S = split_rank.shape
    R = n_ranks
    if regression:
        n_l, n_r = scores.left_counts[..., 0], scores.right_counts[..., 0]
    else:
        n_l, n_r = _csum(scores.left_counts), _csum(scores.right_counts)
    sr_slot = (n_r < n_l).to(torch.int32)
    # Rank -> slot scatter: admitted ranks are unique per tree; every other
    # slot lands in the sliced-off row R.
    rank = torch.where(is_split, split_rank, R).long()
    slots = torch.arange(S, dtype=torch.int32, device=rank.device).expand(k, S)
    parent = torch.full((k, R + 1), -1, dtype=torch.int32, device=rank.device)
    small_right = torch.zeros((k, R + 1), dtype=torch.int32, device=rank.device)
    parent.scatter_(1, rank, slots)
    small_right.scatter_(1, rank, sr_slot)
    return parent[:, :R], small_right[:, :R]


SPLIT_BACKENDS = ("auto", "pallas", "xla")


def resolve_split_backend(backend: str, device: torch.device) -> str:
    """'auto' -> 'pallas' (CUDA kernel) for CUDA tensors, 'xla' (plain) on the CPU.

    Forcing 'pallas' for CPU tensors raises: the kernel has no CPU form.
    The kernel takes every histogram shape (a class axis too wide for
    its shared memory goes in tiles), so no shape leaves the kernel.
    """
    if backend not in SPLIT_BACKENDS:
        raise ValueError(f"split_backend={backend!r} not in {SPLIT_BACKENDS}")
    if backend == "auto":
        return "pallas" if device.type == "cuda" else "xla"
    if backend == "pallas" and device.type != "cuda":
        raise ValueError("split_backend='pallas' is the CUDA kernel; tensors are on the CPU")
    return backend


def level_scores(
    hist: torch.Tensor,
    feature_mask,
    *,
    regression: bool = False,
    backend: str = "auto",
) -> tuple[SplitScores, torch.Tensor]:
    """T_NS stage 1: per-(tree, slot) winning split + node sample count."""
    backend = resolve_split_backend(backend, hist.device)
    if backend == "pallas":
        from ..kernels.split_scan.ops import split_scan_scores

        scores = split_scan_scores(hist, feature_mask, regression=regression)
    elif regression:
        cum = _bin_cumsum(hist)
        total = cum[..., -1, :]
        gains = _mask_scores(variance_gains_from_cumsum(cum, total), feature_mask)
        scores = _select_winners(gains, cum, total)
    else:
        scores = best_splits(hist, feature_mask)
    return scores, node_counts(scores, regression=regression)


def multiway_gain_ratio(hist: torch.Tensor) -> torch.Tensor:
    """Faithful multiway Eq. (2)-(6) over the bin values. [..., F, B, C] -> [..., F]."""
    total = hist.sum(dim=-2)                          # [..., F, C]
    n = _csum(total)                                  # [..., F]; 0/0 = NaN, as in the reference
    h_node = entropy_from_counts(total)
    n_b = _csum(hist)                                 # [..., F, B]
    p_b = n_b / n[..., None]
    h_cond = torch.sum(p_b * entropy_from_counts(hist), dim=-1)
    gain = h_node - h_cond
    split_info = -torch.sum(_xlogx(p_b), dim=-1)
    return gain / torch.clamp_min(split_info, _SPLIT_INFO_FLOOR)


def variable_importance(gr: torch.Tensor) -> torch.Tensor:
    """Eq. (7): VI = GR / sum_a GR, per tree. [k, F] -> [k, F]."""
    g = torch.clamp_min(gr, 0.0)
    return g / g.sum(dim=-1, keepdim=True)            # 0/0 = NaN, as in the reference
