"""OOB-weighted voting (paper §3.3, Eq. 8-10).

Counterpart of ``repro/core/voting.py`` (resident path). Prediction
backends, by ``ForestConfig.predict_backend``:

* ``"pallas"`` — the fused traversal kernel (``csrc/tree_traverse.cu``)
  through ``forest.fused_vote_scores``: only ``[N, C]`` scores exist;
* ``"xla"``    — plain PyTorch: ``route_to_leaves`` + ``weighted_vote``
  over the ``[k, N, C]`` per-tree tensor;
* ``"auto"``   — the kernel for CUDA tensors, the plain path on the CPU.

Both vote with the same per-node payloads (tree weight folded in), so the
labels agree.
"""
from __future__ import annotations

import torch

from .forest import fused_vote_scores, predict_proba_trees, predict_value_trees
from .types import Forest

PREDICT_BACKENDS = ("auto", "pallas", "xla")


def resolve_predict_backend(backend: str, device: torch.device) -> str:
    """'auto' -> 'pallas' (CUDA kernel) for CUDA tensors, 'xla' (plain) on the CPU."""
    if backend not in PREDICT_BACKENDS:
        raise ValueError(f"predict_backend={backend!r} not in {PREDICT_BACKENDS}")
    if backend == "auto":
        return "pallas" if device.type == "cuda" else "xla"
    if backend == "pallas" and device.type != "cuda":
        raise ValueError("predict_backend='pallas' is the CUDA kernel; tensors are on the CPU")
    return backend


def oob_accuracy(forest: Forest, x_binned, y, weights) -> torch.Tensor:
    """Eq. (8): CA_i = #correct / #OOB over OOB_i; 0.5 for an empty OOB set. [k]."""
    pred = torch.argmax(predict_proba_trees(forest, x_binned), dim=-1)   # [k, N]
    oob = (weights == 0.0).to(torch.float32)
    correct = torch.sum(oob * (pred == y.long()[None]).to(torch.float32), dim=1)
    total = torch.sum(oob, dim=1)
    return torch.where(
        total > 0, correct / torch.clamp_min(total, 1.0), torch.full_like(total, 0.5)
    )


def weighted_vote(probs: torch.Tensor, tree_weight: torch.Tensor, *, soft: bool = False) -> torch.Tensor:
    """Eq. (10): scores [N, C] = sum_i w_i * h_i(x) (hard: one-hot of argmax)."""
    w = tree_weight[:, None, None]
    if soft:
        return torch.sum(w * probs, dim=0)
    votes = torch.nn.functional.one_hot(
        torch.argmax(probs, -1), probs.shape[-1]
    ).to(probs.dtype)
    return torch.sum(w * votes, dim=0)


def weighted_regression(values: torch.Tensor, tree_weight: torch.Tensor, *,
                        faithful_eq9: bool = False) -> torch.Tensor:
    """Eq. (9): weighted mean of h_i(x) (``faithful_eq9``: divide by k)."""
    w = tree_weight[:, None]
    if faithful_eq9:
        return torch.mean(w * values, dim=0)
    return torch.sum(w * values, dim=0) / torch.clamp_min(tree_weight.sum(), 1e-38)


def leaf_vote_payload(forest: Forest, tree_weight: torch.Tensor, *, soft: bool = False) -> torch.Tensor:
    """Per-(tree, node) vote vectors with the tree weight folded in, [k, P, C].

    Zero-mass pool rows (the pad, unallocated bands) vote zero, so every
    row is finite.
    """
    counts = forest.class_counts
    total = counts.sum(-1, keepdim=True)
    zero = torch.zeros_like(counts)
    probs = torch.where(total > 0, counts / torch.clamp_min(total, 1e-38), zero)
    if soft:
        vote = probs
    else:
        onehot = torch.nn.functional.one_hot(
            torch.argmax(probs, -1), probs.shape[-1]
        ).to(torch.float32)
        vote = torch.where(total > 0, onehot, zero)
    return tree_weight[:, None, None] * vote


def leaf_value_payload(forest: Forest, tree_weight: torch.Tensor) -> torch.Tensor:
    """Per-(tree, node) weighted regression values, [k, P, 1]."""
    mass = forest.class_counts[..., 0]
    value = torch.where(mass > 0, forest.value, torch.zeros_like(forest.value))
    return (tree_weight[:, None] * value)[..., None]


def _vote_weights(forest: Forest) -> torch.Tensor:
    if forest.config.weighted_voting:
        return forest.tree_weight
    return torch.ones_like(forest.tree_weight)


def build_payload(forest: Forest) -> torch.Tensor:
    """The forest's vote payload under its own config."""
    w = _vote_weights(forest)
    if forest.config.regression:
        return leaf_value_payload(forest, w)
    return leaf_vote_payload(forest, w, soft=forest.config.soft_voting)


def predict_scores(forest: Forest, x_binned: torch.Tensor, *, backend=None) -> torch.Tensor:
    """Weighted-vote class scores [N, C] (argmax = predicted label)."""
    backend = resolve_predict_backend(
        backend if backend is not None else forest.config.predict_backend, x_binned.device
    )
    if backend == "pallas":
        return fused_vote_scores(forest, x_binned, build_payload(forest).contiguous())
    probs = predict_proba_trees(forest, x_binned)
    return weighted_vote(probs, _vote_weights(forest), soft=forest.config.soft_voting)


def predict(forest: Forest, x_binned: torch.Tensor, *, backend=None) -> torch.Tensor:
    """Full PRF classification: weighted majority class [N]."""
    return torch.argmax(predict_scores(forest, x_binned, backend=backend), dim=-1)


def predict_regression(forest: Forest, x_binned: torch.Tensor, *, backend=None) -> torch.Tensor:
    """Full PRF regression prediction: weighted mean of h_i(x), [N]."""
    backend = resolve_predict_backend(
        backend if backend is not None else forest.config.predict_backend, x_binned.device
    )
    w = _vote_weights(forest)
    if backend == "pallas":
        num = fused_vote_scores(forest, x_binned, leaf_value_payload(forest, w).contiguous())[:, 0]
    else:
        num = torch.sum(w[:, None] * predict_value_trees(forest, x_binned), dim=0)
    return num / torch.clamp_min(w.sum(), 1e-38)
