"""The work each layer must do, counted from shapes, draws and the grown forest.

These functions are the numerators of the rooflines and of ``mfu``: the
least time one H100 could take for the work, ``max(bytes / HBM_BYTES_PER_S,
ops / F32_OPS_PER_S)``. They count the algorithm's work, whatever
implements it: each input byte read once and each output byte written
once per level (or per call), and only the (tree, sample) pairs, slots
and features the algorithm needs. A share above 100% means a count here
is too high or a timing leaves work out.

The per-level counts replay the growth's routing on the grown forest: a
sample is live at level L in a tree when its walk from the root has
passed L split nodes, and it adds to that level's histogram when its
in-bag weight is nonzero. The levels run are those the growth loop runs
(it stops when no tree has a frontier slot left).
"""
from __future__ import annotations

import dataclasses

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores (NVIDIA data sheet)
TREES_AT_ONCE = 64          # trees whose walks are replayed together


def scan_ops_per_candidate(n_classes: int) -> int:
    """Float operations to score one candidate split of Eq. 2-6: the
    channel sums, the divisions and six logs of 22 operations each."""
    return 57 * n_classes + 60


@dataclasses.dataclass
class Work:
    """Bytes moved and float operations of some launches of one layer."""
    bytes: float = 0.0
    ops: float = 0.0

    def __iadd__(self, other: "Work") -> "Work":
        self.bytes += other.bytes
        self.ops += other.ops
        return self

    def scaled(self, n: float) -> "Work":
        return Work(self.bytes * n, self.ops * n)

    @property
    def bound_s(self) -> float:
        """The least seconds one H100 could take for it."""
        return max(self.bytes / HBM_BYTES_PER_S, self.ops / F32_OPS_PER_S)


def reuse_resolves_on(forest_cfg: dict, n_features: int, n_classes: int) -> bool:
    """Whether the growth histograms only the smaller child of each split:
    on unless the between-level cache of [k, S, F, B, C] float32 passes its
    budget (the configuration's ``hist_reuse`` and ``hist_reuse_budget_mb``)."""
    mode = forest_cfg["hist_reuse"]
    if mode != "auto":
        return mode == "on"
    S = min(forest_cfg["max_frontier"] or 2 ** forest_cfg["max_depth"], 2 ** forest_cfg["max_depth"])
    cache = 4 * forest_cfg["n_trees"] * S * n_features * forest_cfg["n_bins"] * n_classes
    return cache <= forest_cfg["hist_reuse_budget_mb"] * (1 << 20)


def _step(node, alive, feature, threshold, left, flat, rows):
    """One routing step of every walk: a split node sends its samples on, a leaf keeps them."""
    f = torch.gather(feature, 1, node)
    inner = f >= 0
    b = flat[rows + torch.where(inner, f, 0).long()].to(torch.int32)
    nxt = torch.gather(left, 1, node).long() + (b > torch.gather(threshold, 1, node)).long()
    return torch.where(inner, nxt, node), alive & inner


def level_counts(forest, xb: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, spec,
                 reuse: bool) -> list:
    """Per level the growth runs: live (tree, sample) pairs, rows live in
    any tree, features selected by a live tree, occupied (tree, slot)
    pairs, and the live pairs and occupied segments of the histogram the
    level builds (the smaller children only, when ``reuse``)."""
    N, F = xb.shape
    k = w.shape[0]
    S, n_max = spec.frontier, spec.n_max
    flat = xb.reshape(-1)
    rows = torch.arange(N, device=xb.device)[None, :] * F
    levels = []
    per_chunk = []
    for t0 in range(0, k, TREES_AT_ONCE):
        t1 = min(t0 + TREES_AT_ONCE, k)
        feature, threshold, left = (a[t0:t1] for a in (forest.feature, forest.threshold,
                                                       forest.left_child))
        counts = forest.class_counts[t0:t1].sum(-1)                      # [tc, P]
        node = torch.zeros((t1 - t0, N), dtype=torch.long, device=xb.device)
        alive = torch.ones((t1 - t0, N), dtype=torch.bool, device=xb.device)
        inbag = w[t0:t1] > 0
        rows_l = []
        for level in range(spec.max_depth):
            band = 0 if level == 0 else 1 + 2 * n_max * (level - 1)
            slot = torch.where(alive, node - band, -1)
            live = alive & inbag
            occ = torch.zeros((t1 - t0, S + 1), dtype=torch.bool, device=xb.device)
            occ.scatter_(1, torch.where(live, slot, S), True)
            if reuse and level > 0:
                # the smaller child of the pair (ties: the left one) is histogrammed
                base = 1 + 2 * n_max * (level - 1)
                pair = torch.clamp_min(slot, 0) // 2
                n_l = torch.gather(counts, 1, base + 2 * pair)
                n_r = torch.gather(counts, 1, base + 2 * pair + 1)
                small = live & ((slot % 2) == (n_r < n_l).long())
                seg = torch.zeros((t1 - t0, n_max + 1), dtype=torch.bool, device=xb.device)
                seg.scatter_(1, torch.where(small, pair, n_max), True)
                h_live, h_occ = small, seg[:, :n_max]
            else:
                h_live, h_occ = live, occ[:, :S]
            rows_l.append({
                "live": int(live.sum()), "rows": live.any(0),
                "feats": (mask[t0:t1] & live.any(1)[:, None]).any(0),
                "occupied": int(occ[:, :S].sum()),
                "hist_live": int(h_live.sum()), "hist_rows": h_live.any(0),
                "hist_occupied": int(h_occ.sum()),
            })
            node, alive = _step(node, alive, feature, threshold, left, flat, rows)
        per_chunk.append(rows_l)
    for level in range(spec.max_depth):
        parts = [c[level] for c in per_chunk]
        live = sum(p["live"] for p in parts)
        if level > 0 and live == 0:
            break
        levels.append({
            "live": live,
            "rows": int(torch.stack([p["rows"] for p in parts]).any(0).sum()),
            "feats": int(torch.stack([p["feats"] for p in parts]).any(0).sum()),
            "occupied": sum(p["occupied"] for p in parts),
            "hist_live": sum(p["hist_live"] for p in parts),
            "hist_rows": int(torch.stack([p["hist_rows"] for p in parts]).any(0).sum()),
            "hist_occupied": sum(p["hist_occupied"] for p in parts),
        })
    return levels


def hist_work(rows: int, feats: int, live: int, occupied: int, m: int, spec) -> Work:
    """One histogram pass: the live rows' bins of the features read, their
    class channels, each live pair's weight and slot, and the histogram of
    ``m`` features written for each occupied (tree, slot); a multiply and
    an add per live pair and feature."""
    B, C = spec.n_bins, spec.n_classes
    return Work(bytes=rows * feats + rows * C * 4 + live * 8 + occupied * m * B * C * 4,
                ops=2.0 * live * m)


def dimred_hist_work(w: torch.Tensor, spec) -> Work:
    """Alg. 3.1's root histograms: every in-bag pair over all F features, one slot a tree."""
    inbag = w > 0
    return hist_work(int(inbag.any(0).sum()), spec.n_features, int(inbag.sum()), w.shape[0],
                     spec.n_features, spec)


def growth_hist_work(levels: list, spec) -> Work:
    """T_GR over the levels run, each tree's ``m`` selected features."""
    total = Work()
    for lv in levels:
        total += hist_work(lv["hist_rows"], lv["feats"], lv["hist_live"], lv["hist_occupied"],
                           spec.n_selected, spec)
    return total


def split_scan_work(levels: list, spec) -> Work:
    """T_NS over the levels run: each occupied (tree, slot)'s histogram of
    its ``m`` selected features read, summed over bins (an add a bin and
    class), every candidate scored, the winner (gain, feature, threshold,
    left and right counts) written."""
    B, C, m = spec.n_bins, spec.n_classes, spec.n_selected
    total = Work()
    for lv in levels:
        occ = lv["occupied"]
        total += Work(bytes=occ * m * B * C * 4 + occ * (3 * 4 + 2 * C * 4),
                      ops=occ * m * ((B - 1) * scan_ops_per_candidate(C) + B * C))
    return total


def traverse_counts(forest, xb: torch.Tensor, depth: int) -> tuple:
    """What walks of ``xb`` through every tree touch: the distinct internal
    nodes and leaves they visit, and their steps (internal nodes on every path)."""
    N, F = xb.shape
    k, P = forest.feature.shape
    flat = xb.reshape(-1)
    rows = torch.arange(N, device=xb.device)[None, :] * F
    internal = leaves = steps = 0
    for t0 in range(0, k, TREES_AT_ONCE):
        t1 = min(t0 + TREES_AT_ONCE, k)
        feature, threshold, left = (a[t0:t1] for a in (forest.feature, forest.threshold,
                                                       forest.left_child))
        node = torch.zeros((t1 - t0, N), dtype=torch.long, device=xb.device)
        alive = torch.ones_like(node, dtype=torch.bool)
        seen = torch.zeros((t1 - t0, P), dtype=torch.bool, device=xb.device)
        for _ in range(depth + 1):
            seen.scatter_(1, node, True)
            steps += int((alive & (torch.gather(feature, 1, node) >= 0)).sum())
            node, alive = _step(node, alive, feature, threshold, left, flat, rows)
        inner = int((seen & (feature >= 0)).sum())
        internal += inner
        leaves += int(seen.sum()) - inner
    return internal, leaves, steps


def traverse_work(n_rows: int, n_features: int, counts: tuple, spec) -> Work:
    """One weighted vote of ``n_rows``: their bins read, the three words of
    each internal node visited and the vote of each leaf reached, the
    scores written; a compare and a step a visit, an add per (tree, class)."""
    internal, leaves, steps = counts
    C = spec.n_classes
    return Work(bytes=n_rows * n_features + internal * 3 * 4 + leaves * C * 4 + n_rows * C * 4,
                ops=2.0 * steps + n_rows * spec.n_trees * C)


def oob_work(w: torch.Tensor, counts: tuple, spec) -> Work:
    """Eq. 8 over the training rows: every tree's walks, its weights read
    for the out-of-bag test, an argmax over the classes per (tree, row)."""
    k, N = w.shape
    internal, leaves, steps = counts
    C = spec.n_classes
    return Work(bytes=N * spec.n_features + internal * 3 * 4 + leaves * C * 4 + k * N * 4,
                ops=2.0 * steps + k * N * C)


def bin_fit_work(n_rows: int, n_features: int) -> Work:
    """Fitting the quantile edges: each float read once (the least any exact
    quantile must read; the edges written are negligible)."""
    return Work(bytes=n_rows * n_features * 4)


def binning_work(n_rows: int, n_features: int, n_bins: int) -> Work:
    """Digitising: each float read and each bin id written; a binary search per value."""
    return Work(bytes=n_rows * n_features * 5,
                ops=float(n_rows * n_features * max(1, (n_bins - 1).bit_length())))
