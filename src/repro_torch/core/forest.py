"""Single-device PRF training & prediction entry points (paper Alg. 4.2).

Counterpart of ``repro/core/forest.py``. ``grow_forest`` runs the growth
engine on a ``LocalPlane`` (``grow_forest_checkpointed``: with a
checkpoint after every level); prediction walks the node pool either with
plain gathers (``route_to_leaves``) or with the fused traversal kernel
(``fused_vote_scores``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import as_tensor, resolve_device
from .engine import LocalPlane, _gather_feature_bins, grow, grow_checkpointed
from .histograms import class_channels, regression_channels
from .types import Forest, ForestConfig


def _growth_inputs(x_binned, y, weights, config: ForestConfig, feature_mask, device):
    dev = resolve_device(device)
    xb = as_tensor(x_binned, dev, torch.uint8).contiguous()
    y_t = as_tensor(y, dev)
    w = as_tensor(weights, dev, torch.float32).contiguous()
    mask = None if feature_mask is None else as_tensor(feature_mask, dev, torch.bool)
    base = regression_channels(y_t) if config.regression else class_channels(y_t, config.n_classes)
    return xb, base, w, LocalPlane(mask)


def grow_forest(
    x_binned,                       # [N, F] uint8
    y,                              # [N] int labels (float for regression)
    weights,                        # [k, N] in-bag multiplicities (DSI counts)
    config: ForestConfig,
    feature_mask=None,              # [k, F] bool (dimension reduction)
    *,
    device=None,
) -> Forest:
    """Train k trees level-synchronously. Accepts numpy arrays or tensors;
    runs on ``cuda`` unless ``device="cpu"``."""
    xb, base, w, plane = _growth_inputs(x_binned, y, weights, config, feature_mask, device)
    return grow(xb, base, w, config, plane)


def grow_forest_checkpointed(
    x_binned,
    y,
    weights,
    config: ForestConfig,
    feature_mask=None,
    *,
    manager=None,
    resume_from: Optional[str] = None,
    on_level=None,
    device=None,
) -> Forest:
    """``grow_forest`` with per-level checkpointing and crash resume
    (``engine.grow_checkpointed``): the forest equals ``grow_forest``'s,
    and a run resumed from any level's checkpoint finishes with the
    trees an uninterrupted run grows."""
    xb, base, w, plane = _growth_inputs(x_binned, y, weights, config, feature_mask, device)
    return grow_checkpointed(xb, base, w, config, plane, manager=manager,
                             resume_from=resume_from, on_level=on_level)


def route_to_leaves(forest: Forest, x_binned: torch.Tensor) -> torch.Tensor:
    """Leaf pool id of every sample under every tree. [k, N] int64."""
    k = forest.feature.shape[0]
    N = x_binned.shape[0]
    node = torch.zeros((k, N), dtype=torch.long, device=x_binned.device)
    for _ in range(forest.config.max_depth):
        f = torch.gather(forest.feature, 1, node)
        leaf = f < 0
        b = _gather_feature_bins(x_binned, torch.where(leaf, 0, f))
        thr = torch.gather(forest.threshold, 1, node)
        lc = torch.gather(forest.left_child, 1, node)
        nxt = (lc + (b > thr).to(torch.int32)).long()
        node = torch.where(leaf, node, nxt)
    return node


def predict_proba_trees(forest: Forest, x_binned: torch.Tensor) -> torch.Tensor:
    """Per-tree class distributions h_i(x). [k, N, C]."""
    leaves = route_to_leaves(forest, x_binned)
    C = forest.class_counts.shape[-1]
    counts = torch.gather(forest.class_counts, 1, leaves[..., None].expand(-1, -1, C))
    return counts / torch.clamp_min(counts.sum(-1, keepdim=True), 1e-38)


def predict_value_trees(forest: Forest, x_binned: torch.Tensor) -> torch.Tensor:
    """Per-tree regression outputs h_i(x). [k, N]."""
    return torch.gather(forest.value, 1, route_to_leaves(forest, x_binned))


def fused_vote_scores(
    forest: Forest,
    x_binned: torch.Tensor,      # [N, F] uint8
    payload: torch.Tensor,       # [k, P, C] weighted per-node vote vectors
) -> torch.Tensor:
    """Weighted-vote scores [N, C] through the traversal kernel, ``tree_chunk``
    trees per launch, the ``[N, C]`` carry threaded across chunks; the
    ``[k, N, C]`` per-tree tensor never exists."""
    from ..kernels.tree_traverse.ops import traverse_block

    k = forest.feature.shape[0]
    cfg = forest.config
    tc = min(cfg.tree_chunk if cfg.tree_chunk > 0 else k, k)
    carry: Optional[torch.Tensor] = None
    for c0 in range(0, k, tc):
        c1 = min(c0 + tc, k)
        carry = traverse_block(
            x_binned, forest.feature[c0:c1], forest.threshold[c0:c1],
            forest.left_child[c0:c1], payload[c0:c1], carry,
            depth=cfg.max_depth,
        )
    return carry
