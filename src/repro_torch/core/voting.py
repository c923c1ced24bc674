"""OOB-weighted voting (paper §3.3, Eq. 8-10).

Counterpart of ``repro/core/voting.py`` (resident path). Prediction
backends, by ``ForestConfig.predict_backend``:

* ``"pallas"`` — the fused traversal kernel (``csrc/tree_traverse.cu``)
  through ``forest.fused_vote_scores``: only ``[N, C]`` scores exist;
* ``"xla"``    — plain PyTorch: ``route_to_leaves`` + ``weighted_vote``
  over the ``[k, N, C]`` per-tree tensor;
* ``"auto"``   — the kernel for CUDA tensors, the plain path on the CPU.

Both vote with the same per-node payloads (tree weight folded in), so the
labels agree. The ``*_streamed`` functions run OOB weights and
prediction over sample blocks from a ``BlockFeeder`` (the streaming data
plane); both are per sample, so they equal the resident calls bitwise.
Regression's OOB weight (``oob_r2``) reduces per-sample f32 terms on
the host in float64, one-shot or Neumaier-compensated across blocks, so
``oob_r2_streamed`` equals ``oob_r2`` bitwise too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, host_array

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


def _oob_counts(forest: Forest, x_binned, y, weights):
    """(#correct, #OOB) per tree over these samples: Eq. (8)'s two sums."""
    pred = torch.argmax(predict_proba_trees(forest, x_binned), dim=-1)   # [k, N]
    oob = (weights == 0.0).to(torch.float32)
    correct = torch.sum(oob * (pred == y.long()[None]).to(torch.float32), dim=1)
    return correct, torch.sum(oob, dim=1)


def _oob_ratio(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return torch.where(total > 0, correct / torch.clamp_min(total, 1.0), torch.full_like(total, 0.5))


def oob_accuracy(forest: Forest, x_binned, y, weights) -> torch.Tensor:
    """Eq. (8): CA_i = #correct / #OOB over OOB_i; 0.5 for an empty OOB set. [k]."""
    return _oob_ratio(*_oob_counts(forest, x_binned, y, weights))


def _r2_mean_stats(y: torch.Tensor, w: torch.Tensor):
    """The OOB mean's sufficient statistics (per tree: the OOB sum of y
    and the OOB count), from the whole ``[k, N]`` weights: the streamed
    path takes them the same way, without touching a feature block."""
    oob = (w == 0.0).to(torch.float32)
    return torch.sum(oob * y[None], dim=1), oob.sum(1)


def _r2_block_terms(forest: Forest, xb_b, y_b, w_b, mean):
    """Per-sample OOB squared-error and variance terms of one block,
    ``[k, Nb]`` each: elementwise per sample, so each term is the same
    whether the block is the whole data set or a slice of it. Their sum
    over samples is taken on the host in float64 by both ``oob_r2``
    paths."""
    vals = predict_value_trees(forest, xb_b)
    oob = (w_b == 0.0).to(torch.float32)
    err = vals - y_b[None]
    dev = y_b[None] - mean[:, None]
    return oob * (err * err), oob * (dev * dev)


def _neumaier_add(s: np.ndarray, c: np.ndarray, x: np.ndarray) -> None:
    """One Neumaier-compensated step, in place: ``s += x`` with the
    rounding error banked in ``c`` (float64 [k] each); the sum is ``s + c``."""
    t = s + x
    c += np.where(np.abs(s) >= np.abs(x), (s - t) + x, (x - t) + s)
    s[:] = t


def _r2_finalize(err_sum, var_sum, total, device) -> torch.Tensor:
    """R^2 from the float64 moment sums, in float64, then one cast to
    float32 on ``device``. Neutral prior 0.5 for an empty OOB set or one
    with zero target variance."""
    n = np.maximum(total, 1.0)
    r2 = np.clip(1.0 - (err_sum / n) / np.maximum(var_sum / n, 1e-300), 0.0, 1.0)
    out = np.where((total > 0) & (var_sum > 0), r2, 0.5)
    return torch.from_numpy(out.astype(np.float32)).to(device)


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def oob_r2(forest: Forest, x_binned, y, weights) -> torch.Tensor:
    """Regression analogue of Eq. (8): per-tree OOB R^2 clipped to [0, 1],
    0.5 where the OOB set is empty or its target variance is zero. [k].

    The per-sample f32 terms (``_r2_block_terms``) are summed on the host
    in float64, then one cast to float32: ``oob_r2_streamed`` folds the
    same terms block by block and equals this bitwise."""
    y32 = as_tensor(y, forest.device, torch.float32)
    w32 = as_tensor(weights, forest.device, torch.float32)
    sum_y, total = _r2_mean_stats(y32, w32)
    mean = sum_y / torch.clamp_min(total, 1.0)
    err_t, var_t = _r2_block_terms(forest, x_binned, y32, w32, mean)
    return _r2_finalize(_host64(err_t).sum(axis=1), _host64(var_t).sum(axis=1), _host64(total),
                        forest.device)


def weighted_vote(probs: torch.Tensor, tree_weight: torch.Tensor, *, soft: bool = False) -> torch.Tensor:
    """Eq. (10): scores [N, C] = sum_i w_i * h_i(x) (hard: one-hot of argmax).

    The trees are added one by one, in order, as the traversal kernel adds
    them: a sample's scores then do not depend on the batch it came in
    (``torch.sum`` over the tree axis may group the terms by batch shape),
    so a streamed prediction equals the resident one bitwise."""
    w = tree_weight[:, None, None]
    votes = probs if soft else torch.nn.functional.one_hot(
        torch.argmax(probs, -1), probs.shape[-1]
    ).to(probs.dtype)
    terms = w * votes
    out = terms[0].clone()
    for t in range(1, terms.shape[0]):
        out += terms[t]
    return out


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


def predict_regression_scores(forest: Forest, x_binned: torch.Tensor, *,
                              backend=None) -> torch.Tensor:
    """Eq. (9)'s numerator ``sum_i w_i h_i(x)``, [N]: the traversal kernel
    with a one-column value payload, or the plain per-tree values added
    tree by tree in order, as the kernel adds them (a sample's sum then
    does not depend on its batch)."""
    backend = resolve_predict_backend(
        backend if backend is not None else forest.config.predict_backend, x_binned.device
    )
    w = _vote_weights(forest)
    if backend == "pallas":
        return fused_vote_scores(forest, x_binned, leaf_value_payload(forest, w).contiguous())[:, 0]
    terms = w[:, None] * predict_value_trees(forest, x_binned)
    num = terms[0].clone()
    for t in range(1, terms.shape[0]):
        num += terms[t]
    return num


def predict_regression(forest: Forest, x_binned: torch.Tensor, *, backend=None) -> torch.Tensor:
    """Full PRF regression prediction: weighted mean of h_i(x), [N]."""
    num = predict_regression_scores(forest, x_binned, backend=backend)
    return num / torch.clamp_min(_vote_weights(forest).sum(), 1e-38)


# ---------------------------------------------------------------------------
# Streamed OOB and prediction: the sample-block carriers of the data plane
# ---------------------------------------------------------------------------


def _block_feeder(x_binned, sample_block, prefetch, device, *, what, n_y=None, n_w=None):
    """A ``BlockFeeder`` on ``device`` over a validated block list
    (``pipeline.stream_blocks``: explicit sequences pass through, array
    sources need ``sample_block > 0``, blocks must cover the caller's
    label and weight lengths when given)."""
    from ..data.pipeline import BlockFeeder, stream_blocks

    return BlockFeeder(stream_blocks(x_binned, sample_block, what=what, n_y=n_y, n_w=n_w),
                       placement=device, prefetch=prefetch)


def oob_accuracy_streamed(forest: Forest, x_binned, y, weights, *,
                          sample_block=None, prefetch: int = 2) -> torch.Tensor:
    """Eq. (8) accumulated over sample blocks, on the forest's device:
    ``#correct`` and ``#OOB`` are sums of 0/1 floats (exact integers), so
    the result equals ``oob_accuracy`` bitwise."""
    y_np = host_array(y)
    w_np = host_array(weights).astype(np.float32, copy=False)
    feeder = _block_feeder(x_binned, sample_block, prefetch, forest.device,
                           what="oob_accuracy_streamed", n_y=y_np.shape[0], n_w=w_np.shape[1])
    k = w_np.shape[0]
    correct = torch.zeros((k,), dtype=torch.float32, device=forest.device)
    total = torch.zeros_like(correct)
    o = 0
    with feeder:
        for xb_b in feeder.sweep():
            n = xb_b.shape[0]
            c, t = _oob_counts(forest, xb_b, feeder.pin(y_np[o:o + n]),
                               feeder.pin(w_np[:, o:o + n]))
            correct, total = correct + c, total + t
            o += n
    return _oob_ratio(correct, total)


def oob_r2_streamed(forest: Forest, x_binned, y, weights, *, sample_block=None,
                    prefetch: int = 2) -> torch.Tensor:
    """``oob_r2`` in one sweep over sample blocks: the OOB mean needs only
    ``y`` and the weights (the resident one-shot sums), so only the
    moment terms stream. Each block's float64 term sums are folded with
    Neumaier compensation: the result equals ``oob_r2`` bitwise."""
    y_np = host_array(y).astype(np.float32, copy=False)
    w_np = host_array(weights).astype(np.float32, copy=False)
    feeder = _block_feeder(x_binned, sample_block, prefetch, forest.device,
                           what="oob_r2_streamed", n_y=y_np.shape[0], n_w=w_np.shape[1])
    sum_y, total = _r2_mean_stats(as_tensor(y_np, forest.device), as_tensor(w_np, forest.device))
    mean = sum_y / torch.clamp_min(total, 1.0)
    k = w_np.shape[0]
    err_sum, err_c, var_sum, var_c = (np.zeros(k, np.float64) for _ in range(4))
    o = 0
    with feeder:
        for xb_b in feeder.sweep():
            n = xb_b.shape[0]
            err_t, var_t = _r2_block_terms(forest, xb_b, feeder.pin(y_np[o:o + n]),
                                           feeder.pin(w_np[:, o:o + n]), mean)
            _neumaier_add(err_sum, err_c, _host64(err_t).sum(1))
            _neumaier_add(var_sum, var_c, _host64(var_t).sum(1))
            o += n
    return _r2_finalize(err_sum + err_c, var_sum + var_c, _host64(total), forest.device)


def predict_scores_streamed(forest: Forest, x_binned, *, sample_block=None, backend=None,
                            prefetch: int = 2) -> torch.Tensor:
    """``predict_scores`` over sample blocks: per sample, so bitwise the
    resident call; only the ``[N, C]`` scores (never ``[N, F]``) exist."""
    feeder = _block_feeder(x_binned, sample_block, prefetch, forest.device,
                           what="predict_scores_streamed")
    with feeder:
        return torch.cat([predict_scores(forest, xb_b, backend=backend) for xb_b in feeder.sweep()])


def predict_streamed(forest: Forest, x_binned, *, sample_block=None, backend=None,
                     prefetch: int = 2) -> torch.Tensor:
    """Streamed classification labels [N] (bitwise ``predict``)."""
    return torch.argmax(predict_scores_streamed(forest, x_binned, sample_block=sample_block,
                                                backend=backend, prefetch=prefetch), dim=-1)


def predict_regression_streamed(forest: Forest, x_binned, *, sample_block=None, backend=None,
                                prefetch: int = 2) -> torch.Tensor:
    """Streamed regression predictions [N]: per sample, so bitwise
    ``predict_regression``."""
    feeder = _block_feeder(x_binned, sample_block, prefetch, forest.device,
                           what="predict_regression_streamed")
    with feeder:
        num = torch.cat([predict_regression_scores(forest, xb_b, backend=backend)
                         for xb_b in feeder.sweep()])
    return num / torch.clamp_min(_vote_weights(forest).sum(), 1e-38)
