"""Plain PyTorch version of the traversal kernel (``csrc/tree_traverse.cu``).

For every sample and every tree of the chunk, walk ``depth`` steps of
``node = left_child + (bin[feature] > threshold)`` (a leaf, feature < 0,
stays put), then sum the trees' leaf payloads in tree order and add the
sum to the carry: ``carry + (payload_0 + payload_1 + ...)`` — the
kernel's order, so the two agree bitwise.
"""
from __future__ import annotations

import torch


def walk_tree(x_binned, feature_t, threshold_t, left_t, depth: int) -> torch.Tensor:
    """Leaf pool id [N] of every sample under one tree."""
    N = x_binned.shape[0]
    rows = torch.arange(N, device=x_binned.device)
    node = torch.zeros(N, dtype=torch.long, device=x_binned.device)
    for _ in range(depth):
        f = feature_t[node].long()
        leaf = f < 0
        b = x_binned[rows, torch.where(leaf, 0, f)].to(torch.int32)
        nxt = left_t[node].long() + (b > threshold_t[node]).long()
        node = torch.where(leaf, node, nxt)
    return node


def traverse_block_ref(
    x_binned: torch.Tensor,      # [N, F] uint8
    feature: torch.Tensor,       # [tc, P] int32, -1 = leaf
    threshold: torch.Tensor,     # [tc, P] int32
    left_child: torch.Tensor,    # [tc, P] int32
    payload: torch.Tensor,       # [tc, P, C] float32 weighted vote vectors
    carry: torch.Tensor,         # [N, C] float32
    *,
    depth: int,
) -> torch.Tensor:
    acc = torch.zeros_like(carry)
    for t in range(feature.shape[0]):
        leaf = walk_tree(x_binned, feature[t], threshold[t], left_child[t], depth)
        acc = acc + payload[t][leaf]
    return carry + acc
