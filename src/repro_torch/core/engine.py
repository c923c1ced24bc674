"""Level-synchronous growth engine (paper §4.2).

Counterpart of ``repro/core/engine.py``. One level step is: T_GR
histograms -> T_NS split scoring (``chunked_level_scores``) ->
``plan_level`` -> ``write_level`` -> ``route_level`` ->
``next_frontier``. ``grow`` runs it in a Python loop with one host sync
per level (the early-exit test). The step asks a ``CollectivePlane``
what it cannot answer alone: ``LocalPlane`` (one device, identities) or
``core/distributed.MeshPlane`` (the vertical-partition mesh over
``torch.distributed``), whose histogram combine (``combine_hist``) makes
the level histogram whole before it is scored.

On CUDA the default backends run the fused path (``fused_level_scores``):
the histogram kernel and the split-scan kernel alternate feature slab by
feature slab, threading the split scan's running-best carry, so the full
``[tc, S, F, B, C]`` histogram never exists. On the CPU (or with
``hist_backend="segment_sum"`` / ``split_backend="xla"``) the plain
PyTorch versions build the full histogram and score it in one shot; both
give the same winners (first-occurrence argmax over the same gains).

With ``hist_reuse`` on (and the cache within ``hist_reuse_budget_mb``)
the level step runs the sibling-subtraction task group
(``reuse_level_task_group``): only the smaller child of every split is
histogrammed, into R = S/2 rank segments, the sibling is ``parent -
small`` from the cache of the level before, and all k trees go in one
task group, as in the reference. On CUDA it runs the same two kernels
per feature slab (``fused_level_scores`` with the cache).

With ``config.sample_block > 0`` every level histogram is accumulated
over row blocks (``blocked_level_histograms``), and the streaming data
plane (``core/api.grow_forest_streamed``) runs one ``stream_block_step``
per (block, level). ``grow_checkpointed`` is the same loop with a
checkpoint after every level and resume from the newest valid one. The
multi-process plane is not ported (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

from typing import Optional

import torch

from .gain import SplitScores, level_scores, node_counts, resolve_split_backend, sibling_plan
from .histograms import (
    FixedPoint, blocked_level_histograms, block_slot_orders, hist_feature_slab, level_histograms,
    sibling_expand, sibling_perm, sibling_segments, slot_order,
)
from .types import Forest, ForestConfig, GrowthState


def init_forest(config: ForestConfig, device) -> Forest:
    k, P = config.n_trees, config.max_nodes + 1  # +1 pad slot
    C = 3 if config.regression else config.n_classes
    return Forest(
        feature=torch.full((k, P), -1, dtype=torch.int32, device=device),
        threshold=torch.zeros((k, P), dtype=torch.int32, device=device),
        left_child=torch.full((k, P), -1, dtype=torch.int32, device=device),
        class_counts=torch.zeros((k, P, C), dtype=torch.float32, device=device),
        value=torch.zeros((k, P), dtype=torch.float32, device=device),
        tree_weight=torch.ones((k,), dtype=torch.float32, device=device),
        config=config,
    )


def _safe_mean(counts: torch.Tensor) -> torch.Tensor:
    """``sum / count`` of [..., C>=2] regression channels, 0 where the count is 0."""
    return torch.where(
        counts[..., 0] > 0,
        counts[..., 1] / torch.clamp_min(counts[..., 0], 1e-38),
        torch.zeros_like(counts[..., 0]),
    )


def _gather_feature_bins(xb: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """bins[t, i] = xb[i, f[t, i]] as one flat gather. [k, N] int32."""
    N, F = xb.shape
    rows = torch.arange(N, device=xb.device) * F
    return xb.reshape(-1)[rows[None, :] + f.long()].to(torch.int32)


def _rank_splits(gain: torch.Tensor, valid: torch.Tensor, n_max: int) -> torch.Tensor:
    """Beam selection: rank valid slots by gain (stable), admit the top n_max.

    Returns split_rank [k, S] int32 in [0, n_max) for admitted slots, -1 else.
    """
    score = torch.where(valid, gain, torch.full_like(gain, -torch.inf))
    order = torch.argsort(-score, dim=-1, stable=True)
    pos = torch.argsort(order, dim=-1, stable=True).to(torch.int32)
    admitted = valid & (pos < n_max)
    return torch.where(admitted, pos, torch.full_like(pos, -1))


class CollectivePlane:
    """The engine's collective protocol — identity ops on a single device
    (reference: ``repro/core/engine.py:CollectivePlane``).

    ``combine_hist`` (None: no combine, which lets the single-device
    growth score feature slab by feature slab) makes a shard's histogram
    whole; ``merge_winners`` merges per-shard split leaders;
    ``broadcast_route`` gives every sample shard the winning feature's
    go-right bit; ``reduce_root`` combines the root counts once;
    ``level_mask`` is the feature mask as the scorer sees it;
    ``hist_width`` the feature width of a combined histogram (what the
    reuse cache allocates). ``hist_fixed`` is the growth's fixed point of
    non-integer histogram channels (``histograms.regression_fixed_point``),
    None for classification."""

    combine_hist = None
    level_mask = None
    hist_fixed: Optional[FixedPoint] = None

    def reduce_root(self, root_counts: torch.Tensor) -> torch.Tensor:
        return root_counts

    def merge_winners(self, scores: SplitScores, n_node: torch.Tensor):
        return scores, n_node

    def broadcast_route(self, x_binned, f_i, thr_i) -> torch.Tensor:
        return (_gather_feature_bins(x_binned, f_i) > thr_i).to(torch.int32)

    def hist_width(self, n_features: int) -> int:
        return n_features


class LocalPlane(CollectivePlane):
    """Single-device plane: the whole ``[N, F]`` block lives on one device."""

    def __init__(self, feature_mask: Optional[torch.Tensor] = None,
                 hist_fixed: Optional[FixedPoint] = None):
        self.level_mask = feature_mask
        self.hist_fixed = hist_fixed


def _level_hists(x_binned, base_channels, w_c, slot_c, config: ForestConfig,
                 order=None, n_slots: Optional[int] = None, fixed: Optional[FixedPoint] = None):
    """One chunk's level histogram, accumulated over sample blocks when
    ``config.sample_block`` asks for it (``order`` is then the list of
    per-block groupings). ``n_slots`` overrides the frontier width (the
    reuse path histograms into R rank segments instead)."""
    kw = dict(n_slots=config.frontier if n_slots is None else n_slots, n_bins=config.n_bins,
              packed=config.packed_hist and not config.regression, backend=config.hist_backend,
              fixed=fixed)
    if config.sample_block > 0:
        return blocked_level_histograms(x_binned, base_channels, w_c, slot_c,
                                        sample_block=config.sample_block, orders=order, **kw)
    return level_histograms(x_binned, base_channels, w_c, slot_c, order=order, **kw)


def fused_level_scores(
    x_binned: torch.Tensor,       # [N, F] uint8
    base_channels: torch.Tensor,  # [N, C]
    weights: torch.Tensor,        # [tc, N]
    sample_slot: torch.Tensor,    # [tc, N] (with ``cache``: rank segments)
    feature_mask: Optional[torch.Tensor],  # [tc, F] bool or None
    config: ForestConfig,
    cache: Optional[dict] = None,
    fixed: Optional[FixedPoint] = None,
):
    """T_GR -> T_NS per feature slab: histogram of one slab, then the
    split scan folds it into the running-best carry. Peak histogram
    footprint is one ``[tc, S, W, B, C]`` slab. The histogram kernel's
    grouping of samples by slot is made once here, for the level, and
    shared by every slab (one grouping per sample block with
    ``config.sample_block > 0``). Returns (SplitScores, n_node [tc, S]).

    With the reuse ``cache`` (the reference's ``fused_reuse_level_scores``)
    ``sample_slot`` holds rank segments: each slab is the small-child
    histogram in R segments, expanded against the cached slab (``parent -
    small``) before the scan and written into the next cache; the slab
    width stays the one sized for S rows. Then returns (row-order
    SplitScores, row-order n_node, hist2 [tc, S, F, B, C] in paired-row
    order)."""
    from ..kernels.split_scan.ops import split_scan_block
    from ..kernels.split_scan.ref import init_carry

    tc = weights.shape[0]
    N, F = x_binned.shape
    S, B = config.frontier, config.n_bins
    C = base_channels.shape[-1]
    W = hist_feature_slab(N, F, S, B, C)
    n_slots = S if cache is None else config.max_splits_per_level
    mask = (
        feature_mask if feature_mask is not None
        else torch.ones((tc, F), dtype=torch.bool, device=x_binned.device)
    )
    if config.sample_block > 0:
        order = block_slot_orders(sample_slot, weights, n_slots, config.sample_block)
    else:
        order = slot_order(sample_slot, weights, n_slots)
    carry = init_carry(tc, S, C, x_binned.device)
    if cache is not None:
        hist2 = torch.empty((tc, S, F, B, C), dtype=torch.float32, device=x_binned.device)
    for f0 in range(0, F, W):
        f1 = min(f0 + W, F)
        hist = _level_hists(x_binned[:, f0:f1], base_channels, weights, sample_slot, config, order,
                            n_slots=n_slots, fixed=fixed)
        if cache is not None:
            hist = sibling_expand(hist, cache["hist"][:, :, f0:f1], cache["perm"], cache["parent"], S)
            hist2[:, :, f0:f1] = hist
        carry = split_scan_block(
            hist, mask[:, f0:f1], carry, f0, regression=config.regression
        )
        del hist
    scores = SplitScores(*carry)
    n_node = node_counts(scores, regression=config.regression)
    return (scores, n_node) if cache is None else (scores, n_node, hist2)


def chunked_level_scores(
    x_binned: torch.Tensor,       # [N, F] uint8
    base_channels: torch.Tensor,  # [N, C]
    weights: torch.Tensor,        # [k, N]
    sample_slot: torch.Tensor,    # [k, N]
    feature_mask: Optional[torch.Tensor],  # [k, F] bool or None
    config: ForestConfig,
    *,
    hist_reduce=None,             # fn(hist) -> hist, e.g. the mesh's psum over samples
    fixed: Optional[FixedPoint] = None,
):
    """T_GR + T_NS stage 1 for all k trees, ``tree_chunk`` trees at a time.

    Without ``hist_reduce`` on CUDA the chunk runs ``fused_level_scores``
    (the histogram never exists beyond one feature slab); with it (the
    mesh plane) the chunk's histogram is built whole, combined, then
    scored. A remainder chunk is padded with zero-weight, all-parked
    dummy trees whose rows are dropped from the result. The mask's
    feature width may be narrower than the bins' (a reduce-scatter
    combine scores a slice). Returns (SplitScores [k, S, ...], n_node
    [k, S]).
    """
    k = config.n_trees
    tc = min(config.tree_chunk if config.tree_chunk > 0 else k, k)
    split_be = resolve_split_backend(config.split_backend, x_binned.device)

    def score_chunk(w_c, slot_c, mask_c):
        if hist_reduce is None and split_be == "pallas":
            return fused_level_scores(x_binned, base_channels, w_c, slot_c, mask_c, config,
                                      fixed=fixed)
        hist = _level_hists(x_binned, base_channels, w_c, slot_c, config, fixed=fixed)
        if hist_reduce is not None:
            hist = hist_reduce(hist)          # the T_GR combine over the sample shards
        return level_scores(hist, mask_c, regression=config.regression, backend=split_be)

    if tc >= k:
        return score_chunk(weights, sample_slot, feature_mask)

    mask = (
        feature_mask if feature_mask is not None
        else torch.ones((k, x_binned.shape[1]), dtype=torch.bool, device=x_binned.device)
    )
    kp = -(-k // tc) * tc
    if kp != k:                  # pad the remainder chunk with dummy trees
        weights = torch.nn.functional.pad(weights, (0, 0, 0, kp - k))
        sample_slot = torch.nn.functional.pad(sample_slot, (0, 0, 0, kp - k), value=-1)
        mask = torch.nn.functional.pad(mask, (0, 0, 0, kp - k))
    outs = [
        score_chunk(weights[c:c + tc], sample_slot[c:c + tc], mask[c:c + tc])
        for c in range(0, kp, tc)
    ]
    scores = SplitScores(*(torch.cat(parts)[:k] for parts in zip(*(o[0] for o in outs))))
    n_node = torch.cat([o[1] for o in outs])[:k]
    return scores, n_node


def resolve_hist_reuse(config: ForestConfig, n_features: int) -> bool:
    """Whether growth carries the between-level histogram cache: the
    policy ``resolved_hist_reuse()`` plus the capacity gate — the cache
    is one ``[k, S, F, B, C]`` float32 tensor held across the growth, so
    above ``hist_reuse_budget_mb`` growth falls back to reuse off."""
    if config.resolved_hist_reuse() == "off":
        return False
    C = 3 if config.regression else config.n_classes
    cache_bytes = 4 * config.n_trees * config.frontier * n_features * config.n_bins * C
    return cache_bytes <= config.hist_reuse_budget_mb * (1 << 20)


def init_hist_cache(config: ForestConfig, n_features: int, device) -> dict:
    """Level-0 reuse cache. ``small_right = 0`` makes slot 0 the "small"
    child of rank 0, so the root histogram comes out of the same path:
    every sample lands in rank segment 0, and the all-(-1) ``parent``
    table zeroes every subtraction row against the zero ``hist``."""
    k, S, R = config.n_trees, config.frontier, config.max_splits_per_level
    C = 3 if config.regression else config.n_classes
    return {
        "hist": torch.zeros((k, S, n_features, config.n_bins, C), dtype=torch.float32,
                            device=device),
        "perm": torch.arange(S, dtype=torch.int32, device=device).repeat(k, 1),
        "parent": torch.full((k, R), -1, dtype=torch.int32, device=device),
        "small_right": torch.zeros((k, R), dtype=torch.int32, device=device),
    }


def _permute_rows(perm: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Gather the [k, S, ...] per-row descriptors ``a`` into slot order."""
    idx = perm.long().reshape(perm.shape + (1,) * (a.dim() - 2)).expand_as(a)
    return torch.gather(a, 1, idx)


def reuse_expand_scores(packed_h, cache, feature_mask, config: ForestConfig):
    """Expand the packed histogram against the cache, score the paired
    rows in one shot and permute the descriptors to slot order. Returns
    (slot-order SplitScores, n_node, hist2, perm)."""
    S = config.frontier
    hist2 = sibling_expand(packed_h, cache["hist"], cache["perm"], cache["parent"], S)
    perm = sibling_perm(cache["small_right"], S)
    scores_r, n_r = level_scores(
        hist2, feature_mask, regression=config.regression, backend=config.split_backend
    )
    scores = SplitScores(*(_permute_rows(perm, a) for a in scores_r))
    return scores, _permute_rows(perm, n_r), hist2, perm


def reuse_level_task_group(x_binned, base_channels, weights, sample_slot, slot_node, cache,
                           config: ForestConfig, plane: CollectivePlane):
    """Reuse-mode T_GR + T_NS task group over all k trees: histogram only
    the samples routed to small children (R rank segments, everything
    else parked in the dump segment), rebuild the large children as
    ``parent - small``, score the paired rows and permute the O(k*S)
    descriptors back to slot order.

    Returns (slot-order SplitScores, n_node, next cache without its
    ``parent`` / ``small_right``, which ``level_step`` plans after routing)."""
    S, R = config.frontier, config.max_splits_per_level
    tree_live = (slot_node >= 0).any(dim=1)
    w_level = weights * tree_live[:, None].to(weights.dtype)
    seg = sibling_segments(sample_slot, cache["small_right"])
    split_be = resolve_split_backend(config.split_backend, x_binned.device)
    if plane.combine_hist is None and split_be == "pallas":
        perm = sibling_perm(cache["small_right"], S)
        scores_r, n_r, hist2 = fused_level_scores(
            x_binned, base_channels, w_level, seg, plane.level_mask, config, cache,
            fixed=plane.hist_fixed,
        )
        scores = SplitScores(*(_permute_rows(perm, a) for a in scores_r))
        n_node = _permute_rows(perm, n_r)
    else:
        packed_h = _level_hists(x_binned, base_channels, w_level, seg, config, n_slots=R,
                                fixed=plane.hist_fixed)
        if plane.combine_hist is not None:
            packed_h = plane.combine_hist(packed_h)   # half the bytes of the off path
        scores, n_node, hist2, perm = reuse_expand_scores(
            packed_h, cache, plane.level_mask, config
        )
    scores, n_node = plane.merge_winners(scores, n_node)
    return scores, n_node, {"hist": hist2, "perm": perm}


def init_growth_state(
    base_channels: torch.Tensor,  # [N, C]
    weights: torch.Tensor,        # [k, N]
    config: ForestConfig,
    plane: CollectivePlane,
    *,
    n_features: Optional[int] = None,   # F of the bins; enables hist_reuse
) -> GrowthState:
    """Forest with the root node populated + the level-0 frontier, and the
    reuse cache when ``n_features`` is given and the config and budget
    allow it."""
    k, S = config.n_trees, config.frontier
    dev = weights.device
    forest = init_forest(config, dev)
    # Per-channel sums rather than a matmul, so the root counts never
    # depend on the TF32 matmul setting.
    root_counts = plane.reduce_root(torch.stack(
        [(weights * base_channels[:, c]).sum(dim=1) for c in range(base_channels.shape[1])],
        dim=1,
    ))                                                            # [k, C]
    forest.class_counts[:, 0] = root_counts
    if config.regression:
        forest.value[:, 0] = _safe_mean(root_counts)
    slot_node = torch.full((k, S), -1, dtype=torch.int32, device=dev)
    slot_node[:, 0] = 0
    hist_cache = None
    if n_features is not None and resolve_hist_reuse(config, n_features):
        hist_cache = init_hist_cache(config, plane.hist_width(n_features), dev)
    return GrowthState(
        forest=forest,
        slot_node=slot_node,
        sample_slot=torch.zeros((k, weights.shape[1]), dtype=torch.int32, device=dev),
        level=0,
        hist_cache=hist_cache,
    )


def level_task_group(
    x_binned, base_channels, weights, sample_slot, slot_node,
    config: ForestConfig, plane: CollectivePlane,
):
    """One level's T_GR + T_NS task group; trees whose frontier died get
    zero weight (no work inside their tree chunk)."""
    tree_live = (slot_node >= 0).any(dim=1)
    w_level = weights * tree_live[:, None].to(weights.dtype)
    scores, n_node = chunked_level_scores(
        x_binned, base_channels, w_level, sample_slot, plane.level_mask, config,
        hist_reduce=plane.combine_hist, fixed=plane.hist_fixed,
    )
    return plane.merge_winners(scores, n_node)


def plan_level(scores: SplitScores, n_node, slot_node, config: ForestConfig, level: int):
    """T_NS stage 2: admit splits (gain + support gates, beam rank) and
    fix this level's child band. Returns (split_rank, is_split, child_base)."""
    n_max = config.max_splits_per_level
    valid = (
        (slot_node >= 0)
        & (scores.gain_ratio > config.min_gain)
        & (n_node >= config.min_samples_split)
    )
    split_rank = _rank_splits(scores.gain_ratio, valid, n_max)
    return split_rank, split_rank >= 0, 1 + 2 * n_max * level


def write_level(
    forest: Forest, slot_node, split_rank, is_split, child_base,
    scores: SplitScores, config: ForestConfig,
) -> Forest:
    """Write this level's split descriptors + child nodes into the pool, in
    place (non-split slots dump into the pad node, sanitized at the end)."""
    pad = config.max_nodes
    t_idx = torch.arange(config.n_trees, device=slot_node.device)[:, None]
    left_id = (child_base + 2 * split_rank).to(torch.int32)
    node_or_pad = torch.where(is_split, slot_node, pad).long()

    forest.feature[t_idx, node_or_pad] = torch.where(is_split, scores.feature, -1).to(torch.int32)
    forest.threshold[t_idx, node_or_pad] = scores.threshold.to(torch.int32)
    forest.left_child[t_idx, node_or_pad] = left_id

    lid = torch.where(is_split, left_id, pad).long()
    rid = torch.where(is_split, left_id + 1, pad).long()
    forest.class_counts[t_idx, lid] = scores.left_counts
    forest.class_counts[t_idx, rid] = scores.right_counts
    if config.regression:
        forest.value[t_idx, lid] = _safe_mean(scores.left_counts)
        forest.value[t_idx, rid] = _safe_mean(scores.right_counts)
    return forest


def route_level(x_binned, sample_slot, split_rank, scores: SplitScores,
                plane: CollectivePlane) -> torch.Tensor:
    """Route samples to child slots: ``2 * rank + go_right``, or -1 (parked)."""
    live = sample_slot >= 0
    s_safe = torch.where(live, sample_slot, 0).long()
    rank_i = torch.gather(split_rank, 1, s_safe)
    f_i = torch.gather(scores.feature, 1, s_safe)
    thr_i = torch.gather(scores.threshold, 1, s_safe)
    go_right = plane.broadcast_route(x_binned, f_i, thr_i)
    routed = 2 * rank_i + go_right
    return torch.where(live & (rank_i >= 0), routed, -1).to(torch.int32)


def stream_block_step(hist_acc, xb_b, base_b, w_b, slot_b, slot_node, split_rank,
                      scores: Optional[SplitScores], config: ForestConfig,
                      plane: CollectivePlane, *, route: bool, small_right=None):
    """One (block, level) step of the streaming data plane (reference:
    ``repro/core/engine.py:stream_block_step``): route the block's samples
    from the previous level's plan (``route``: from level 1 on), then add
    the block's histogram into this level's carry ``hist_acc`` in place
    (``out=``; the kernel's atomics flush straight into it). The slot
    table ``slot_b`` stays on the device across levels. With
    ``small_right`` (histogram reuse) the block goes into the packed R
    rank segments and ``hist_acc`` is ``[k, R, F, B, C]``. Returns
    ``(hist_acc, routed slot_b)``."""
    if route:
        slot_b = route_level(xb_b, slot_b, split_rank, scores, plane)
    tree_live = (slot_node >= 0).any(dim=1)
    w_lvl = w_b * tree_live[:, None].to(w_b.dtype)
    if small_right is None:
        slots, n_slots = slot_b, config.frontier
    else:
        slots, n_slots = sibling_segments(slot_b, small_right), config.max_splits_per_level
    level_histograms(
        xb_b, base_b, w_lvl, slots, n_slots=n_slots, n_bins=config.n_bins,
        packed=config.packed_hist and not config.regression, backend=config.hist_backend,
        out=hist_acc, fixed=plane.hist_fixed,
    )
    return hist_acc, slot_b


def next_frontier(is_split, child_base: int, n_slots: int) -> torch.Tensor:
    """Next level's frontier: this level's children, densely packed."""
    j = torch.arange(n_slots, device=is_split.device)[None, :]
    n_children = 2 * is_split.sum(-1, keepdim=True)
    return torch.where(j < n_children, child_base + j, -1).to(torch.int32)


def finalize_forest(forest: Forest) -> Forest:
    """Reset the pad slot to leaf defaults (its content depends on how many
    levels ran), so early-exit and fixed-depth forests are identical."""
    pad = forest.config.max_nodes
    forest.feature[:, pad] = -1
    forest.threshold[:, pad] = 0
    forest.left_child[:, pad] = -1
    forest.class_counts[:, pad] = 0.0
    forest.value[:, pad] = 0.0
    return forest


def level_step(x_binned, base_channels, weights, state: GrowthState,
               config: ForestConfig, plane: CollectivePlane) -> GrowthState:
    """One level of growth: task group -> plan -> write -> route -> frontier.
    With ``state.hist_cache`` the task group runs the reuse path, and the
    cache is refreshed with this level's paired histograms and the next
    level's small-side plan."""
    if state.hist_cache is None:
        scores, n_node = level_task_group(
            x_binned, base_channels, weights, state.sample_slot, state.slot_node, config, plane
        )
        new_cache = None
    else:
        scores, n_node, new_cache = reuse_level_task_group(
            x_binned, base_channels, weights, state.sample_slot, state.slot_node,
            state.hist_cache, config, plane,
        )
    split_rank, is_split, child_base = plan_level(
        scores, n_node, state.slot_node, config, state.level
    )
    forest = write_level(
        state.forest, state.slot_node, split_rank, is_split, child_base, scores, config
    )
    sample_slot = route_level(x_binned, state.sample_slot, split_rank, scores, plane)
    if new_cache is not None:
        parent, small_right = sibling_plan(
            scores, split_rank, is_split,
            n_ranks=config.max_splits_per_level, regression=config.regression,
        )
        new_cache = dict(new_cache, parent=parent, small_right=small_right)
    return GrowthState(
        forest=forest,
        slot_node=next_frontier(is_split, child_base, config.frontier),
        sample_slot=sample_slot,
        level=state.level + 1,
        hist_cache=new_cache,
    )


def grow(
    x_binned: torch.Tensor,       # [N, F] uint8
    base_channels: torch.Tensor,  # [N, C]
    weights: torch.Tensor,        # [k, N] DSI in-bag multiplicities
    config: ForestConfig,
    plane: CollectivePlane,
) -> Forest:
    """Level-synchronous growth. With ``config.early_exit`` the loop stops as
    soon as every frontier is empty (one host sync per level)."""
    state = init_growth_state(base_channels, weights, config, plane,
                              n_features=x_binned.shape[1])
    while state.level < config.max_depth:
        if config.early_exit and not bool((state.slot_node >= 0).any()):
            break
        state = level_step(x_binned, base_channels, weights, state, config, plane)
    return finalize_forest(state.forest)


def grow_checkpointed(
    x_binned: torch.Tensor,
    base_channels: torch.Tensor,
    weights: torch.Tensor,
    config: ForestConfig,
    plane: CollectivePlane,
    *,
    manager=None,
    resume_from: Optional[str] = None,
    on_level=None,
) -> Forest:
    """``grow`` with per-level ``GrowthState`` checkpointing (reference:
    ``repro/core/engine.py:grow_checkpointed``).

    The same host loop over ``level_step``, so the forest equals
    ``grow``'s. It runs while ``level < max_depth`` and any frontier slot
    is live, whatever ``config.early_exit`` says (the levels it skips
    change nothing). After each level the full carry goes to
    ``manager.maybe_save(state, state.level)`` (``checkpoint.CheckpointManager``),
    then ``on_level(level, state)`` fires, so a raise there is a crash at
    the level boundary with the level's checkpoint durable.
    ``resume_from`` names a checkpoint directory whose newest
    CRC-verified step restores the carry (``restore_latest_valid``: a
    corrupt or torn step is skipped) on the weights' device, and growth
    continues from the level after it; an empty, missing or all-corrupt
    directory is a fresh start.
    """
    state = None
    if resume_from is not None:
        from ..checkpoint.checkpoint import restore_latest_valid

        like = init_growth_state(base_channels, weights, config, plane,
                                 n_features=x_binned.shape[1])
        restored = restore_latest_valid(like, resume_from, device=weights.device)
        if restored is not None:
            state, _ = restored
    if state is None:
        state = init_growth_state(base_channels, weights, config, plane,
                                  n_features=x_binned.shape[1])
    while state.level < config.max_depth and bool((state.slot_node >= 0).any()):
        state = level_step(x_binned, base_channels, weights, state, config, plane)
        if manager is not None:
            manager.maybe_save(state, state.level)
        if on_level is not None:
            on_level(state.level, state)
    return finalize_forest(state.forest)


def levels_run(forest: Forest) -> int:
    """Levels the growth loop ran, read off the pool: one past the deepest
    level that split, plus the level that found no split (if depth allowed)."""
    cfg = forest.config
    band = 2 * cfg.max_splits_per_level
    lc = forest.left_child[:, : cfg.max_nodes]
    if not bool((lc >= 0).any()):
        return 1
    deepest = int((lc[lc >= 0].max().item() - 1) // band)   # level that allocated it
    return min(deepest + 2, cfg.max_depth)
