"""The plain reference of the PRF main path, against which ``correct`` is decided.

Plain NumPy and PyTorch. It imports nothing of the program under test
(``repro_torch``) and takes nothing the program made: it is handed the
benchmark's own inputs (the rows, the labels, the DSI weights and the
selection's uniforms) and works out the bin edges, the bins, the feature
mask, the forest, the OOB tree weights and the labels again.

The reference's arithmetic is the paper's (Eq. 2-10, Alg. 3.1 and 4.2)
in the roundings the configuration states: float32 throughout, the
natural log as the Cephes polynomial evaluated with fused multiply-adds
(``_log``), class sums taken left to right (``_csum``). Where the
algorithm leaves a summation order open and the sum is not exact, the
reference sums in the shapes and order of a plain PyTorch run on the
same device (Eq. 7's sums over bins and over features); everything else
is either elementwise or a sum of integer counts, exact in any order.

Where this file does less work than a literal reading of the algorithm,
the result is the same bit for bit: histograms hold integer counts below
2^24 (exact in float32 whatever the order of the additions), only the
in-bag samples of live slots add anything, and a tree's split scoring
reads only its selected features (the others score -inf).

``hist_dtype`` and ``score_dtype`` are the controls: the same reference
with its split histograms, or its vote, held in a lower precision.
``reordered`` is a sound reordering, a witness of what a correct change
of summation order reads: every float sum whose order the algorithm
leaves open is taken in another order (class and bin sums right to left,
Eq. 7's normalisation over features right to left, the vote tree by tree
from the last tree).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

_TINY = 1e-38
_SPLIT_INFO_FLOOR = 1e-12
_MIN_NORMAL = 1.17549435e-38
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
SLAB_BYTES_PER_TREE = 8 << 20       # Eq. 7's gain ratios are summed in feature slabs of this size


@dataclasses.dataclass(frozen=True)
class Forest:
    """A forest as a flat node pool: ``[k, P]`` per node, ``[k, P, C]`` class counts."""
    feature: torch.Tensor
    threshold: torch.Tensor
    left_child: torch.Tensor
    class_counts: torch.Tensor

    FIELDS = ("feature", "threshold", "left_child", "class_counts")


@dataclasses.dataclass(frozen=True)
class Spec:
    """The forest's hyper-parameters as the configuration states them."""
    n_trees: int
    max_depth: int
    n_bins: int
    n_classes: int
    max_frontier: int
    min_samples_split: int
    min_gain: float
    tree_chunk: int
    n_features: int

    @property
    def frontier(self) -> int:
        f = self.max_frontier if self.max_frontier > 0 else 2 ** self.max_depth
        return min(f, 2 ** self.max_depth)

    @property
    def n_max(self) -> int:
        return max(self.frontier // 2, 1)

    @property
    def n_nodes(self) -> int:
        """Pool rows a tree holds: 1 + 2 * n_max * depth nodes, plus one pad row."""
        return 2 + 2 * self.n_max * self.max_depth

    @property
    def n_selected(self) -> int:
        """Alg. 3.1's m = ceil(sqrt(M))."""
        return min(self.n_features, max(1, math.ceil(math.sqrt(self.n_features))))

    @property
    def n_important(self) -> int:
        """Alg. 3.1's k = ceil(sqrt(m))."""
        return min(self.n_selected, max(1, math.ceil(math.sqrt(self.n_selected))))


def spec_from(forest_cfg: dict, n_classes: int, n_features: int) -> Spec:
    return Spec(
        n_trees=forest_cfg["n_trees"], max_depth=forest_cfg["max_depth"],
        n_bins=forest_cfg["n_bins"], n_classes=n_classes,
        max_frontier=forest_cfg["max_frontier"],
        min_samples_split=forest_cfg["min_samples_split"], min_gain=forest_cfg["min_gain"],
        tree_chunk=forest_cfg["tree_chunk"], n_features=n_features,
    )


# ---------------------------------------------------------------------------
# Binning: quantile edges on the host, digitised in float32
# ---------------------------------------------------------------------------


def fit_edges(x: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature quantile edges [F, B-1] (numpy's linear quantiles), made ascending."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(np.asarray(x), qs, axis=0).T
    return np.maximum.accumulate(edges, axis=1)


def digitize(x: torch.Tensor, edges: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """Bin ids [N, F] uint8: a value equal to edge j lands in bin j + 1; both sides in ``dtype``."""
    e = torch.from_numpy(np.ascontiguousarray(edges)).to(x.device, dtype)
    bins = torch.searchsorted(e.contiguous(), x.to(dtype).t().contiguous(), right=True)
    return bins.t().to(torch.uint8).contiguous()


# ---------------------------------------------------------------------------
# Eq. 2-7 in float32
# ---------------------------------------------------------------------------


def _csum(x: torch.Tensor, reordered: bool = False) -> torch.Tensor:
    """Sum over the last axis, left to right (right to left if ``reordered``)."""
    order = range(x.shape[-1])
    order = list(reversed(order)) if reordered else list(order)
    s = x[..., order[0]]
    for c in order[1:]:
        s = s + x[..., c]
    return s


def _bsum(x: torch.Tensor, reordered: bool) -> torch.Tensor:
    """Sum over the last axis as a plain torch reduction on the rows'
    device does it (right to left, one term at a time, if ``reordered``)."""
    return _csum(x, reordered=True) if reordered else torch.sum(x, dim=-1)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the sum formed in float64 (the
    product of two float32s is exact there), and the one case where
    rounding that to float32 differs from rounding the exact value (a
    float32 midpoint) settled by the sum's exact error term."""
    a, b, c = torch.broadcast_tensors(
        torch.as_tensor(a, dtype=torch.float32),
        torch.as_tensor(b, dtype=torch.float32, device=a.device if torch.is_tensor(a) else None),
        torch.as_tensor(c, dtype=torch.float32, device=a.device if torch.is_tensor(a) else None),
    )
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, torch.full_like(r, torch.inf), torch.full_like(r, -torch.inf))
    nxt = torch.nextafter(r, toward)
    tie = (d != 0) & (d == (nxt.double() - r.double()) / 2)
    return torch.where(tie & (err * d > 0), nxt, r)


def _log_poly(x: torch.Tensor) -> torch.Tensor:
    """Cephes' logf: mantissa in [sqrt(1/2), sqrt(2)), a degree-9 polynomial in fused multiply-adds."""
    i = x.view(torch.int32)
    m = ((i & ~0x7F800000) | 0x3F000000).view(torch.float32)
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


def _log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 values (clamped to the smallest normal),
    evaluated once per distinct value."""
    bits = torch.clamp_min(x.to(torch.float32), _MIN_NORMAL).contiguous().view(torch.int32)
    vals, inverse = torch.unique(bits, return_inverse=True)
    return _log_poly(vals.view(torch.float32))[inverse]


def _xlogx(p: torch.Tensor) -> torch.Tensor:
    return torch.where(p > 0, p * _log(torch.clamp_min(p, _TINY)), torch.zeros_like(p))


def entropy(counts: torch.Tensor, reordered: bool = False) -> torch.Tensor:
    """Eq. 2 over the last axis of unnormalised counts."""
    total = _csum(counts, reordered)[..., None]
    return -_csum(_xlogx(counts / torch.clamp_min(total, _TINY)), reordered)


def split_gain_ratios(cum: torch.Tensor, total: torch.Tensor,
                      reordered: bool = False) -> torch.Tensor:
    """Eq. 2-6 of every binary split ``bin <= b`` from bin prefix sums.
    cum [..., F, B, C], total [..., F, C] -> [..., F, B-1]; a split with an empty side is -inf."""
    n = _csum(total, reordered)
    h_node = entropy(total, reordered)
    left = cum[..., :-1, :]
    right = total[..., None, :] - left
    n_l = _csum(left, reordered)
    n_r = _csum(right, reordered)
    n_tot = torch.clamp_min(n[..., None], _TINY)
    # Eq. 3, with the right-hand product and the sum rounded once (a fused multiply-add)
    h_cond = _fma(n_r / n_tot, entropy(right, reordered),
                  (n_l / n_tot) * entropy(left, reordered))
    gain = h_node[..., None] - h_cond
    p_l = n_l / n_tot
    p_r = n_r / n_tot
    split_info = -(_xlogx(p_l) + _xlogx(p_r))
    gr = gain / torch.clamp_min(split_info, _SPLIT_INFO_FLOOR)
    return torch.where((n_l > 0) & (n_r > 0), gr, torch.full_like(gr, -torch.inf))


def multiway_gain_ratio(hist: torch.Tensor, reordered: bool = False) -> torch.Tensor:
    """Eq. 2-6 of the multiway split over every bin value. [k, F, B, C] -> [k, F]."""
    total = hist.sum(dim=-2)
    n = _csum(total, reordered)
    h_node = entropy(total, reordered)
    n_b = _csum(hist, reordered)
    p_b = n_b / n[..., None]
    h_cond = _bsum(p_b * entropy(hist, reordered), reordered)
    gain = h_node - h_cond
    split_info = -_bsum(_xlogx(p_b), reordered)
    return gain / torch.clamp_min(split_info, _SPLIT_INFO_FLOOR)


def _rank(v: torch.Tensor) -> torch.Tensor:
    """Rank in descending order of ``v``; ties: the lower index first."""
    return torch.argsort(torch.argsort(-v, dim=-1, stable=True), dim=-1, stable=True)


# ---------------------------------------------------------------------------
# Histograms of integer DSI counts
# ---------------------------------------------------------------------------


def _pair_chunk(n_rows: int, pairs: int = 1 << 26) -> int:
    """Trees a histogram pass takes at once: about ``pairs`` (tree, sample) pairs."""
    return max(1, pairs // max(n_rows, 1))


def _hist_pairs(xb_flat, n_feat_all, y, t_idx, i_idx, s_idx, wv, feats, n_groups, n_slots,
                n_bins, n_classes) -> torch.Tensor:
    """Σ w over (tree, slot, feature, bin, class) of the given live pairs.
    ``feats`` [G, m] holds each group's features (a group is a tree, or
    one row for all trees); the result is [G, n_slots, m, B, C] float32."""
    m = feats.shape[1]
    out = torch.zeros(n_groups * n_slots * m * n_bins * n_classes, dtype=torch.float32,
                      device=wv.device)
    g_idx = t_idx if feats.shape[0] > 1 else torch.zeros_like(t_idx)
    base = (g_idx * n_slots + s_idx) * m
    row = i_idx * n_feat_all
    for f in range(m):
        b = xb_flat[row + feats[g_idx, f]].long()
        out.index_add_(0, ((base + f) * n_bins + b) * n_classes + y[i_idx], wv)
    return out.view(n_groups, n_slots, m, n_bins, n_classes)


def root_histograms(xb: torch.Tensor, y: torch.Tensor, w: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Every tree's root histogram over every feature, [k, F, B, C] float32."""
    N, F = xb.shape
    k = w.shape[0]
    xb_flat = xb.reshape(-1)
    feats = torch.arange(F, device=xb.device)[None, :]
    parts = []
    tc = _pair_chunk(N)
    for t0 in range(0, k, tc):
        wc = w[t0:t0 + tc]
        t_idx, i_idx = (wc > 0).nonzero(as_tuple=True)
        # one feature row for every tree; the slot axis stands for the chunk's trees
        h = _hist_pairs(xb_flat, F, y, t_idx, i_idx, t_idx, wc[t_idx, i_idx],
                        feats, 1, wc.shape[0], spec.n_bins, spec.n_classes)
        parts.append(h[0])
    return torch.cat(parts)


def dimension_reduction(xb, y, w, spec: Spec, u, reordered: bool = False) -> torch.Tensor:
    """Alg. 3.1: per tree, the k most important features by Eq. 7 and
    m - k more drawn by ``u`` from the rest. Returns the mask [k, F] bool.
    Eq. 7's sums run over [k, W, B] feature slabs on the rows' device."""
    hist = root_histograms(xb, y, w, spec)
    k, F, B, C = hist.shape
    W = max(1, min(F, SLAB_BYTES_PER_TREE // (B * C * 4)))
    gr = torch.cat([multiway_gain_ratio(hist[:, f0:f0 + W].contiguous(), reordered)
                    for f0 in range(0, F, W)], dim=1)
    g = torch.clamp_min(gr, 0.0)
    vi = g / _bsum(g, reordered)[..., None]
    top = _rank(vi) < spec.n_important
    u = torch.where(top, torch.full_like(u, -torch.inf), u)
    return top | (_rank(u) < (spec.n_selected - spec.n_important))


# ---------------------------------------------------------------------------
# Level-synchronous growth (Alg. 4.2)
# ---------------------------------------------------------------------------


def _selected(mask: torch.Tensor) -> torch.Tensor:
    """Each tree's selected features in ascending order, [k, m] (m the
    largest count); a tree with fewer is padded with unselected features,
    which its scoring masks."""
    m = int(mask.sum(1).max())
    return torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :m]


def _grow_chunk(xb, y, w, mask, spec: Spec, hist_dtype, reordered: bool) -> dict:
    """Grow the trees of one chunk through every level; trees are independent."""
    N, F = xb.shape
    tc = w.shape[0]
    S, B, C, n_max, P = spec.frontier, spec.n_bins, spec.n_classes, spec.n_max, spec.n_nodes
    dev = xb.device
    xb_flat = xb.reshape(-1)
    sel = _selected(mask)
    m = sel.shape[1]
    valid_feat = torch.gather(mask, 1, sel)                      # [tc, m]
    t_ar = torch.arange(tc, device=dev)[:, None]
    feature = torch.full((tc, P), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros((tc, P), dtype=torch.int32, device=dev)
    left_child = torch.full((tc, P), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((tc, P, C), dtype=torch.float32, device=dev)
    counts[:, 0] = torch.stack([(w * (y == c).to(torch.float32)).sum(dim=1) for c in range(C)], 1)
    slot_node = torch.full((tc, S), -1, dtype=torch.int32, device=dev)
    slot_node[:, 0] = 0
    sample_slot = torch.zeros((tc, N), dtype=torch.int32, device=dev)
    pad = P - 1
    for level in range(spec.max_depth):
        if not bool((slot_node >= 0).any()):
            break
        live = (sample_slot >= 0) & (w > 0)
        t_idx, i_idx = live.nonzero(as_tuple=True)
        hist = _hist_pairs(xb_flat, F, y, t_idx, i_idx, sample_slot[t_idx, i_idx].long(),
                           w[t_idx, i_idx], sel, tc, S, B, C)
        if hist_dtype is not None:
            hist = hist.to(hist_dtype).to(torch.float32)
        cum = torch.cumsum(hist, dim=-2)
        total = cum[..., -1, :]
        gr = split_gain_ratios(cum, total, reordered)               # [tc, S, m, B-1]
        gr = torch.where(valid_feat[:, None, :, None], gr, torch.full_like(gr, -torch.inf))
        flat = gr.reshape(tc, S, m * (B - 1))
        best = torch.argmax(flat, dim=-1)
        best_gr = torch.gather(flat, -1, best[..., None])[..., 0]
        f_loc = torch.div(best, B - 1, rounding_mode="floor")
        thr = (best - f_loc * (B - 1)).to(torch.int32)
        feat = torch.gather(sel, 1, f_loc).to(torch.int32)
        cum_f = torch.gather(cum, 2, f_loc[..., None, None, None].expand(tc, S, 1, B, C))[:, :, 0]
        left = torch.gather(cum_f, 2, thr.long()[..., None, None].expand(tc, S, 1, C))[:, :, 0]
        tot_f = torch.gather(total, 2, f_loc[..., None, None].expand(tc, S, 1, C))[:, :, 0]
        right = tot_f - left
        n_node = _csum(left, reordered) + _csum(right, reordered)
        ok = (slot_node >= 0) & (best_gr > spec.min_gain) & (n_node >= spec.min_samples_split)
        score = torch.where(ok, best_gr, torch.full_like(best_gr, -torch.inf))
        pos = torch.argsort(torch.argsort(-score, dim=-1, stable=True), dim=-1, stable=True)
        rank = torch.where(ok & (pos < n_max), pos, torch.full_like(pos, -1)).to(torch.int32)
        is_split = rank >= 0
        child_base = 1 + 2 * n_max * level
        left_id = (child_base + 2 * rank).to(torch.int32)
        node_or_pad = torch.where(is_split, slot_node, pad).long()
        feature[t_ar, node_or_pad] = torch.where(is_split, feat, -1)
        threshold[t_ar, node_or_pad] = thr
        left_child[t_ar, node_or_pad] = left_id
        lid = torch.where(is_split, left_id, pad).long()
        rid = torch.where(is_split, left_id + 1, pad).long()
        counts[t_ar, lid] = left
        counts[t_ar, rid] = right
        # route every sample, in-bag or not, to 2 * rank + (bin > threshold), or park it
        on = sample_slot >= 0
        s_safe = torch.where(on, sample_slot, 0).long()
        rank_i = torch.gather(rank, 1, s_safe)
        f_i = torch.gather(feat, 1, s_safe)
        thr_i = torch.gather(thr, 1, s_safe)
        rows = torch.arange(N, device=dev)[None, :] * F
        go_right = (xb_flat[rows + f_i.long()].to(torch.int32) > thr_i).to(torch.int32)
        sample_slot = torch.where(on & (rank_i >= 0), 2 * rank_i + go_right, -1).to(torch.int32)
        j = torch.arange(S, device=dev)[None, :]
        slot_node = torch.where(j < 2 * is_split.sum(-1, keepdim=True), child_base + j,
                                -1).to(torch.int32)
    feature[:, pad] = -1
    threshold[:, pad] = 0
    left_child[:, pad] = -1
    counts[:, pad] = 0.0
    return {"feature": feature, "threshold": threshold, "left_child": left_child,
            "class_counts": counts}


def grow(xb: torch.Tensor, y: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, spec: Spec,
         hist_dtype: Optional[torch.dtype] = None, reordered: bool = False) -> Forest:
    """All trees, a chunk of trees at a time. ``hist_dtype``: the control's
    histograms, rounded to a lower precision before they are scored."""
    N = xb.shape[0]
    tc = _pair_chunk(N)
    parts = [_grow_chunk(xb, y, w[t0:t0 + tc], mask[t0:t0 + tc], spec, hist_dtype, reordered)
             for t0 in range(0, w.shape[0], tc)]
    return Forest(**{f: torch.cat([p[f] for p in parts]) for f in Forest.FIELDS})


# ---------------------------------------------------------------------------
# Leaves, OOB tree weights (Eq. 8) and the weighted vote (Eq. 10)
# ---------------------------------------------------------------------------


def leaves(forest: Forest, xb: torch.Tensor, t0: int, t1: int, depth: int) -> torch.Tensor:
    """Leaf pool id [t1 - t0, N] of every sample under trees [t0, t1)."""
    N, F = xb.shape
    feature, threshold, left = (a[t0:t1] for a in (forest.feature, forest.threshold,
                                                   forest.left_child))
    node = torch.zeros((t1 - t0, N), dtype=torch.long, device=xb.device)
    rows = torch.arange(N, device=xb.device)[None, :] * F
    flat = xb.reshape(-1)
    for _ in range(depth):
        f = torch.gather(feature, 1, node)
        leaf = f < 0
        b = flat[rows + torch.where(leaf, 0, f).long()].to(torch.int32)
        nxt = torch.gather(left, 1, node).long() + (b > torch.gather(threshold, 1, node)).long()
        node = torch.where(leaf, node, nxt)
    return node


def _leaf_class(forest: Forest, t0: int, t1: int):
    """Per node: its class distribution's first argmax, and whether it holds any mass."""
    counts = forest.class_counts[t0:t1]
    total = counts.sum(-1, keepdim=True)
    probs = torch.where(total > 0, counts / torch.clamp_min(total, _TINY), torch.zeros_like(counts))
    return torch.argmax(probs, -1), total[..., 0] > 0


def oob_weights(forest: Forest, xb, y, w, spec: Spec) -> torch.Tensor:
    """Eq. 8: each tree's accuracy over its out-of-bag samples (0.5 if it has none). [k]."""
    k = w.shape[0]
    out = []
    tc = _pair_chunk(xb.shape[0])
    for t0 in range(0, k, tc):
        t1 = min(t0 + tc, k)
        leaf = leaves(forest, xb, t0, t1, spec.max_depth)
        counts = torch.gather(forest.class_counts[t0:t1], 1,
                              leaf[..., None].expand(-1, -1, spec.n_classes))
        pred = torch.argmax(counts / torch.clamp_min(counts.sum(-1, keepdim=True), _TINY), dim=-1)
        oob = (w[t0:t1] == 0.0).to(torch.float32)
        correct = torch.sum(oob * (pred == y.long()[None]).to(torch.float32), dim=1)
        total = torch.sum(oob, dim=1)
        out.append(torch.where(total > 0, correct / torch.clamp_min(total, 1.0),
                               torch.full_like(total, 0.5)))
    return torch.cat(out)


def vote_scores(forest: Forest, tree_weight: torch.Tensor, xb: torch.Tensor, spec: Spec,
                score_dtype: torch.dtype = torch.float32, rows: int = 1 << 17,
                reordered: bool = False) -> torch.Tensor:
    """Eq. 10: scores [N, C] = Σ_i w_i onehot(h_i(x)). The trees are added
    in order, ``tree_chunk`` at a time: each chunk's votes summed from
    zero, then added to the running scores (``reordered``: one tree at a
    time, from the last). ``score_dtype``: the accumulator (the control's
    in a lower precision)."""
    k, C = spec.n_trees, spec.n_classes
    tc = 1 if reordered else min(spec.tree_chunk if spec.tree_chunk > 0 else k, k)
    cls, mass = _leaf_class(forest, 0, k)
    pay = (torch.nn.functional.one_hot(cls, C).to(torch.float32) * mass[..., None]
           * tree_weight[:, None, None]).to(score_dtype)                      # [k, P, C]
    starts = list(range(0, k, tc))
    out = []
    for r0 in range(0, xb.shape[0], rows):
        xr = xb[r0:r0 + rows]
        scores = torch.zeros((xr.shape[0], C), dtype=score_dtype, device=xb.device)
        for c0 in (reversed(starts) if reordered else starts):
            c1 = min(c0 + tc, k)
            leaf = leaves(forest, xr, c0, c1, spec.max_depth)
            acc = torch.zeros_like(scores)
            for t in range(c1 - c0):
                acc = acc + pay[c0 + t][leaf[t]]
            scores = scores + acc
        out.append(scores)
    return torch.cat(out)


def predict(forest: Forest, tree_weight, xb, spec: Spec,
            score_dtype: torch.dtype = torch.float32, reordered: bool = False) -> torch.Tensor:
    """Weighted-vote labels [N] (the first class of the highest score)."""
    return torch.argmax(vote_scores(forest, tree_weight, xb, spec, score_dtype,
                                    reordered=reordered), dim=-1)


def node_counts(forest: dict, xb: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                spec: Spec) -> torch.Tensor:
    """In-bag class counts [k, P, C] of the rows that a forest's own splits
    route to each of its nodes. ``forest`` holds a trained forest's node
    arrays (the answer judged); the counts are sums of integer DSI weights,
    exact in any order, so a sound forest's stored class counts equal them."""
    feature, threshold, left = forest["feature"], forest["threshold"], forest["left_child"]
    k, P = feature.shape
    N, F = xb.shape
    C = spec.n_classes
    out = torch.zeros(k * P * C, dtype=torch.float32, device=xb.device)
    rows = torch.arange(N, device=xb.device)[None, :] * F
    flat = xb.reshape(-1)
    tc = _pair_chunk(N)
    for t0 in range(0, k, tc):
        t1 = min(t0 + tc, k)
        f_c, thr_c, left_c, wc = (a[t0:t1].to(xb.device) for a in (feature, threshold, left, w))
        base = torch.arange(t0, t1, device=xb.device)[:, None] * P
        node = torch.zeros((t1 - t0, N), dtype=torch.long, device=xb.device)
        out.index_add_(0, ((base + node) * C + y[None, :]).reshape(-1), wc.reshape(-1))
        for _ in range(spec.max_depth):
            f = torch.gather(f_c, 1, node).long()
            inner = f >= 0
            b = flat[rows + torch.where(inner, f, 0)].to(torch.int32)
            nxt = torch.gather(left_c, 1, node).long() + (b > torch.gather(thr_c, 1, node)).long()
            node = torch.where(inner, nxt.clamp(0, P - 1), node)
            out.index_add_(0, ((base + node) * C + y[None, :]).reshape(-1),
                           torch.where(inner, wc, 0.0).reshape(-1))
    return out.view(k, P, C)


def train(x: np.ndarray, y: np.ndarray, w: torch.Tensor, u: torch.Tensor, spec: Spec, device,
          hist_dtype: Optional[torch.dtype] = None, reordered: bool = False) -> dict:
    """The whole resident training: edges, bins, mask, forest and OOB weights."""
    edges = fit_edges(x, spec.n_bins)
    xb = digitize(torch.from_numpy(np.ascontiguousarray(x)).to(device), edges)
    yt = torch.from_numpy(np.asarray(y)).to(device).long()
    mask = dimension_reduction(xb, yt, w, spec, u, reordered)
    forest = grow(xb, yt, w, mask, spec, hist_dtype, reordered)
    return {"edges": edges, "bins": xb, "y": yt, "mask": mask, "forest": forest,
            "tree_weight": oob_weights(forest, xb, yt, w, spec)}
