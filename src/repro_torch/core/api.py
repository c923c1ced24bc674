"""Public PRF API — train / predict, resident and streamed.

    bin -> DSI bootstrap -> dimension reduction (Alg. 3.1)
        -> level-synchronous growth (Alg. 4.2) -> OOB weights (Eq. 8)

Counterpart of ``repro/core/api.py`` (``train_prf``, ``PRFModel`` and
the streaming data plane's ``grow_forest_streamed``). ``train_prf``
draws its randomness with a ``torch.Generator`` on the device — the DSI
counts ``[k, N]`` and the uniform draws ``u [k, F]`` of feature
selection — and hands them to ``fit_prf_from_draws``, which does
everything else. That split is where tests feed in the reference's JAX
draws. With ``config.sample_block > 0`` it runs the streamed trainer:
``x`` may be an ``np.memmap``, and the ``[N, F]`` matrix never sits on
the device whole. Both trainers checkpoint growth after every level
(``checkpoint_dir``) and resume from the newest valid checkpoint
(``resume_from``); ``config.regression`` trains on float targets with
OOB R^2 tree weights.

Entry points run on ``cuda`` unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..device import as_tensor, host_array, resolve_device
from ..launch.multiproc import is_multiprocess
from .binning import apply_bins, bin_dataset, fit_bins, fit_bins_blocked
from .dimred import dimension_reduction, dimension_reduction_streamed, random_feature_mask
from .dsi import bootstrap_counts
from .engine import (
    LocalPlane, _safe_mean, finalize_forest, init_forest, init_hist_cache, next_frontier,
    plan_level, resolve_hist_reuse, reuse_expand_scores, stream_block_step, write_level,
)
from .forest import grow_forest, grow_forest_checkpointed
from .gain import SplitScores, level_scores, sibling_plan
from .histograms import class_channels, regression_channels, regression_fixed_point
from .types import Forest, ForestConfig
from .voting import (
    oob_accuracy, oob_accuracy_streamed, oob_r2, oob_r2_streamed, predict, predict_regression,
    predict_scores,
)


@dataclasses.dataclass
class PRFModel:
    """Trained model + the binning transform needed at inference.

    Prediction runs on the forest's device and honours
    ``forest.config.predict_backend``. ``quarantine`` is the validator's
    report when ``train_prf`` ran with a ``bad_block_policy``.
    """

    forest: Forest
    bin_edges: np.ndarray
    quarantine: Optional[object] = None

    def _binned(self, x) -> torch.Tensor:
        dev = self.forest.device
        with tracing.span("binning.copy"):
            xt = as_tensor(x, dev)
            edges = torch.from_numpy(np.asarray(self.bin_edges)).to(dev)
        with tracing.span("binning.digitize"):
            return apply_bins(xt, edges)

    def _streams(self, x) -> bool:
        """Out-of-core models (``config.sample_block > 0``) also predict
        per sample block: prediction is per sample, so the blocked sweep
        is bitwise the resident call."""
        nb = self.forest.config.sample_block
        return nb > 0 and np.shape(x)[0] > nb

    def _predict_blocks(self, x, fn) -> np.ndarray:
        """Bin and evaluate one ``sample_block`` at a time: each binned
        block is consumed by ``fn`` before the next is built, so only the
        per-sample outputs outlive the sweep."""
        nb = self.forest.config.sample_block
        return np.concatenate([fn(self._binned(x[i:i + nb])).cpu().numpy()
                               for i in range(0, np.shape(x)[0], nb)])

    def predict(self, x) -> np.ndarray:
        """Labels (or regression values) of host rows ``x``. Spans: ``predict``,
        its children ``predict.to_bins``, ``predict.vote``, ``predict.to_host``."""
        with tracing.span("predict"):
            fn = predict_regression if self.forest.config.regression else predict
            if self._streams(x):
                return self._predict_blocks(x, lambda xb: fn(self.forest, xb))
            with tracing.span("predict.to_bins"):
                xb = self._binned(x)
            with tracing.span("predict.vote"):
                out = fn(self.forest, xb)
            with tracing.span("predict.to_host"):
                return out.cpu().numpy()

    def predict_scores(self, x) -> np.ndarray:
        """Weighted-vote class scores [N, C] (classification only)."""
        if self.forest.config.regression:
            raise ValueError(
                "predict_scores is classification-only; use predict() for regression models"
            )
        if self._streams(x):
            return self._predict_blocks(x, lambda xb: predict_scores(self.forest, xb))
        return predict_scores(self.forest, self._binned(x)).cpu().numpy()

    def accuracy(self, x, y) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))

    def with_predict_backend(self, backend: str) -> "PRFModel":
        """Same model, different prediction backend."""
        cfg = dataclasses.replace(self.forest.config, predict_backend=backend)
        return PRFModel(
            forest=dataclasses.replace(self.forest, config=cfg),
            bin_edges=self.bin_edges,
            quarantine=self.quarantine,
        )


def _checkpoint_manager(checkpoint_dir: Optional[str], checkpoint_every: int,
                        checkpoint_keep: int):
    if checkpoint_dir is None:
        return None
    from ..checkpoint.checkpoint import CheckpointManager

    return CheckpointManager(checkpoint_dir, keep=checkpoint_keep, save_interval=checkpoint_every)


def train_prf(
    x: np.ndarray,
    y: np.ndarray,
    config: ForestConfig,
    seed: int = 0,
    *,
    device=None,
    feeder_opts: Optional[dict] = None,
    bad_block_policy: Optional[str] = "raise",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 3,
    resume_from: Optional[str] = None,
    on_level=None,
) -> PRFModel:
    """End-to-end PRF training on host data (paper §3 + §4 semantics).

    Draws the DSI bootstrap counts and the feature-selection uniforms with
    a ``torch.Generator(device).manual_seed(seed)`` — different numbers
    from the reference's JAX draws for the same seed — and calls
    ``fit_prf_from_draws``. With ``config.sample_block > 0`` that runs the
    streamed trainer (``x`` may be an ``np.memmap``); ``feeder_opts``
    goes to its ``BlockFeeder`` (retry, backoff, ``fault_hook``).

    **Crash resume.** ``checkpoint_dir`` checkpoints the growth carry
    every ``checkpoint_every`` levels (``checkpoint_keep`` rotated
    atomic-rename checkpoints); ``resume_from`` restores the newest
    CRC-verified carry from that directory and continues. Everything
    before growth is a deterministic function of ``(x, y, config, seed,
    device)`` and is recomputed, so the resumed model equals an
    uninterrupted one bitwise. An empty or all-corrupt ``resume_from``
    is a fresh start. ``on_level(level, _)`` fires after each completed
    (checkpointed) level.

    **Several processes.** In an initialised world of more than one
    process every process makes the same call, and it runs
    ``distributed.train_prf_multiproc``: the same draws, then each
    process screens, bins and feeds only its rows of every sample block;
    the model equals this single-process one bitwise while the per-shard
    quantile sketches stay uncompressed (``fit_prf_from_draws`` likewise
    runs ``fit_prf_multiproc_from_draws``).
    """
    dev = resolve_device(device)
    N, F = np.shape(x)
    config = config.resolved(F)
    if is_multiprocess():
        from .distributed import train_prf_multiproc

        return train_prf_multiproc(
            x, y, config, seed, device=dev, feeder_opts=feeder_opts,
            bad_block_policy=bad_block_policy, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, checkpoint_keep=checkpoint_keep,
            resume_from=resume_from, on_level=on_level,
        )
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    weights = bootstrap_counts(gen, config.n_trees, N, dev)          # DSI §4.1.2
    u = torch.rand((config.n_trees, F), generator=gen, device=dev)
    return fit_prf_from_draws(
        x, y, config, weights, u, device=dev, feeder_opts=feeder_opts,
        bad_block_policy=bad_block_policy, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, checkpoint_keep=checkpoint_keep,
        resume_from=resume_from, on_level=on_level,
    )


def fit_prf_from_draws(
    x: np.ndarray,
    y: np.ndarray,
    config: ForestConfig,
    weights,                      # [k, N] DSI in-bag counts
    u,                            # [k, F] uniform draws of feature selection
    *,
    device=None,
    feeder_opts: Optional[dict] = None,
    bad_block_policy: Optional[str] = "raise",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 3,
    resume_from: Optional[str] = None,
    on_level=None,
) -> PRFModel:
    """Everything of ``train_prf`` after the random draws: validation,
    binning, dimension reduction (classification only), growth
    (checkpointed with ``checkpoint_dir`` / ``resume_from``) and OOB tree
    weights (accuracy, or R^2 for regression); streamed
    (``_fit_streamed``) when ``config.sample_block > 0``. ``x`` is not
    copied as a whole (an ``np.memmap`` stays on disk)."""
    dev = resolve_device(device)
    with tracing.span("fit"):
        y = np.asarray(y)
        config = config.resolved(np.shape(x)[1])
        if is_multiprocess():
            from ..launch.multiproc import MultiHostMesh
            from .distributed import fit_prf_multiproc_from_draws

            return fit_prf_multiproc_from_draws(
                x, y, config, weights, u, runtime=MultiHostMesh(device=dev),
                feeder_opts=feeder_opts, bad_block_policy=bad_block_policy,
                checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                checkpoint_keep=checkpoint_keep, resume_from=resume_from, on_level=on_level,
            )
        weights = as_tensor(weights, dev, torch.float32)
        u = as_tensor(u, dev, torch.float32)
        k, (N, F) = config.n_trees, np.shape(x)
        if tuple(weights.shape) != (k, N) or tuple(u.shape) != (k, F) or y.shape != (N,):
            raise ValueError(
                f"need weights [{k}, {N}], u [{k}, {F}] and y [{N}]; got weights "
                f"{tuple(weights.shape)}, u {tuple(u.shape)}, y {y.shape}"
            )
        manager = _checkpoint_manager(checkpoint_dir, checkpoint_every, checkpoint_keep)
        if config.sample_block > 0:
            return _fit_streamed(x, y, config, weights, u, dev, feeder_opts, bad_block_policy,
                                 manager, resume_from, on_level)
        return _fit_resident(np.asarray(x), y, config, weights, u, dev, bad_block_policy,
                             manager, resume_from, on_level)


def _fit_resident(x: np.ndarray, y: np.ndarray, config: ForestConfig, weights: torch.Tensor,
                  u: torch.Tensor, dev: torch.device, bad_block_policy: Optional[str], manager,
                  resume_from: Optional[str], on_level) -> PRFModel:
    """``fit_prf_from_draws`` on the device-resident path, each stage a
    span under ``fit``: ``fit.validation``, ``fit.binning``, ``fit.dimred``,
    ``fit.growth`` and ``fit.oob``."""
    n_classes = None if config.regression else config.n_classes
    report, cell_mask, label_mask = None, None, None
    if bad_block_policy not in (None, "off"):
        from ..data.pipeline import DataIntegrityError, screen_blocks

        with tracing.span("fit.validation"):
            blocks1, y_clean, cmasks, lmasks, report = screen_blocks(
                [x], y, policy=bad_block_policy, n_features=x.shape[1],
                n_classes=n_classes, regression=config.regression,
            )
        if not report.clean:
            if bad_block_policy == "quarantine":
                raise DataIntegrityError(
                    "bad_block_policy='quarantine' on the resident path "
                    "would drop the entire dataset (it is a single block) "
                    "— stream it with config.sample_block > 0, or use 'sanitize'",
                    block_index=0, reason="quarantine",
                )
            x, y = blocks1[0], y_clean
            cell_mask, label_mask = cmasks.get(0), lmasks.get(0)

    with tracing.span("fit.binning"):
        if config.resolved_bin_fit() == "blocked":
            # The streamed trainer's sketch, fed with views of x; imputed
            # cells are left out of it rather than counted as their zeros.
            from ..data.pipeline import sample_blocks

            nb_fit = 65536
            with tracing.span("binning.fit"):
                edges = fit_bins_blocked(
                    sample_blocks(x, nb_fit), config.n_bins,
                    exclude_masks=None if cell_mask is None else sample_blocks(cell_mask, nb_fit),
                )
            with tracing.span("binning.copy"):
                xt, edges_dev = as_tensor(x, dev), torch.from_numpy(edges).to(dev)
            with tracing.span("binning.digitize"):
                xb = apply_bins(xt, edges_dev)
            del xt
        else:
            xb, edges = bin_dataset(x, config.n_bins, device=dev)
        if cell_mask is not None:
            xb[torch.from_numpy(cell_mask).to(dev)] = 0          # imputed cells -> bin 0

    with tracing.span("fit.dimred"):
        y_t = as_tensor(y, dev, torch.float32 if config.regression else None)
        if label_mask is not None:
            weights = torch.where(torch.from_numpy(label_mask).to(dev)[None, :], 0.0, weights)
        feature_mask = None
        if config.feature_mode == "importance" and not config.regression:
            feature_mask = dimension_reduction(xb, y_t, weights, config, u)     # §3.2
        elif config.feature_mode == "random":
            feature_mask = random_feature_mask(u, n_selected=config.n_selected)

    with tracing.span("fit.growth"):                                      # §4.2
        if manager is not None or resume_from is not None:
            forest = grow_forest_checkpointed(xb, y_t, weights, config, feature_mask,
                                              manager=manager, resume_from=resume_from,
                                              on_level=on_level, device=dev)
        else:
            forest = grow_forest(xb, y_t, weights, config, feature_mask, device=dev)

    if config.weighted_voting:                                            # §3.3
        with tracing.span("fit.oob"):
            xb_o, y_o, w_o = xb, y_t, weights
            if label_mask is not None:
                keep = torch.from_numpy(np.flatnonzero(~label_mask)).to(dev)
                xb_o, y_o, w_o = xb_o[keep], y_o[keep], w_o[:, keep]
            oob = oob_r2 if config.regression else oob_accuracy
            forest.tree_weight = oob(forest, xb_o, y_o, w_o)
    return PRFModel(forest=forest, bin_edges=edges, quarantine=report)


# ---------------------------------------------------------------------------
# The streaming data plane: out-of-core training from host sample blocks
# ---------------------------------------------------------------------------


def _fit_streamed(x, y: np.ndarray, config: ForestConfig, weights: torch.Tensor,
                  u: torch.Tensor, dev: torch.device, feeder_opts: Optional[dict],
                  bad_block_policy: Optional[str], manager, resume_from: Optional[str],
                  on_level) -> PRFModel:
    """``fit_prf_from_draws`` over the streaming data plane (reference:
    ``repro/core/api.py:_train_prf_streamed``, after its draws).

    Validation screens every raw block before the edges are fit (one NaN
    would poison every quantile). ``bin_fit="auto"`` resolves to the
    blocked sketch here: O(block) + O(F * sketch) host memory, bitwise
    ``np.quantile`` below the sketch's compression threshold. Each raw
    block is binned on the device and its uint8 bins kept on the host
    (in pinned memory on CUDA); dimension reduction, growth and OOB
    weights then read them one ``sample_block`` at a time through a
    ``BlockFeeder``. Sanitized
    cells go to bin 0, sanitized labels get zero DSI weight and leave
    the OOB sums, and quarantined blocks leave every sweep and the edge
    fit, all decided once. On clean data every input is untouched, so
    the model equals the one with validation off bitwise. ``manager``,
    ``resume_from`` and ``on_level`` go to ``grow_forest_streamed``.
    """
    nb = config.sample_block
    N, F = np.shape(x)
    raw_blocks = [x[i:i + nb] for i in range(0, N, nb)]
    y_host = y
    report, cell_masks, label_masks, quar = None, {}, {}, frozenset()
    if bad_block_policy not in (None, "off"):
        from ..data.pipeline import DataIntegrityError, screen_blocks

        raw_blocks, y_host, cell_masks, label_masks, report = screen_blocks(
            raw_blocks, y_host, policy=bad_block_policy, n_features=F,
            n_classes=None if config.regression else config.n_classes,
            regression=config.regression,
        )
        quar = frozenset(report.quarantined)
        if len(quar) == len(raw_blocks):
            raise DataIntegrityError(
                f"every block quarantined ({len(raw_blocks)} of {len(raw_blocks)}) — "
                "nothing left to train on", reason="quarantine",
            )
    dirty = report is not None and not report.clean
    good = [i for i in range(len(raw_blocks)) if i not in quar]

    if config.resolved_bin_fit() == "blocked":
        edges = fit_bins_blocked(
            (raw_blocks[i] for i in good), config.n_bins,
            exclude_masks={j: cell_masks[i] for j, i in enumerate(good) if i in cell_masks},
        )
    elif dirty:
        edges = fit_bins(np.concatenate([raw_blocks[i] for i in good]), config.n_bins)
    else:
        edges = fit_bins(x, config.n_bins)
    edges_dev = torch.from_numpy(edges).to(dev)
    # uint8 bins, kept on the host: pinned on CUDA, written once here, so
    # every sweep's feed is one non-blocking copy with no staging
    xb_blocks = []
    for i, rb in enumerate(raw_blocks):
        xb = apply_bins(as_tensor(rb, dev), edges_dev)
        if i in cell_masks:
            xb[torch.from_numpy(cell_masks[i]).to(dev)] = 0   # imputed cells -> bin 0
        host = torch.empty(xb.shape, dtype=xb.dtype, pin_memory=dev.type == "cuda")
        xb_blocks.append(host.copy_(xb))
    if label_masks:
        bad_rows = np.zeros(N, dtype=bool)
        for i, m in label_masks.items():
            bad_rows[i * nb:i * nb + m.shape[0]][m] = True
        weights = torch.where(torch.from_numpy(bad_rows).to(dev)[None, :], 0.0, weights)
    w_host = weights.cpu().numpy()

    feature_mask = None
    if config.feature_mode == "importance" and not config.regression:     # §3.2
        rows = [np.arange(i * nb, i * nb + xb_blocks[i].shape[0]) for i in good]
        sel = np.concatenate(rows) if quar else slice(None)
        feature_mask = dimension_reduction_streamed(
            [xb_blocks[i] for i in good], y_host[sel], w_host[:, sel], config, u, device=dev,
        )
    elif config.feature_mode == "random":
        feature_mask = random_feature_mask(u, n_selected=config.n_selected)

    forest = grow_forest_streamed(                                         # §4.2
        xb_blocks, y_host, w_host, config, feature_mask, device=dev,
        feeder_opts=feeder_opts, quarantined=sorted(quar), manager=manager,
        resume_from=resume_from, on_level=on_level,
    )

    if config.weighted_voting:                                             # §3.3
        o_blocks, o_y, o_w = xb_blocks, y_host, w_host
        if dirty:
            # surviving blocks and rows only: imputed-label rows (zero
            # weight, so out of bag everywhere) must not score the trees
            # against a made-up label
            o_blocks, keep_rows = [], []
            for i in good:
                n_i = xb_blocks[i].shape[0]
                keep = ~label_masks[i] if i in label_masks else np.ones(n_i, dtype=bool)
                if keep.any():
                    o_blocks.append(xb_blocks[i][torch.from_numpy(keep)])
                    keep_rows.append(i * nb + np.flatnonzero(keep))
            keep_rows = np.concatenate(keep_rows)
            o_y, o_w = y_host[keep_rows], w_host[:, keep_rows]
        oob = oob_r2_streamed if config.regression else oob_accuracy_streamed
        forest.tree_weight = oob(forest, o_blocks, o_y, o_w)
    return PRFModel(forest=forest, bin_edges=edges, quarantine=report)


def _channels(y: torch.Tensor, config: ForestConfig) -> torch.Tensor:
    return regression_channels(y) if config.regression else class_channels(y, config.n_classes)


def _stream_init(level0_hist: torch.Tensor, config: ForestConfig) -> Forest:
    """Root node from the accumulated level-0 histogram: every sample sits
    in slot 0 there, so one feature's bin marginal is the root's [k, C]
    counts, with no extra pass over the blocks."""
    root_counts = level0_hist[:, 0, 0].sum(dim=1)
    forest = init_forest(config, level0_hist.device)
    forest.class_counts[:, 0] = root_counts
    if config.regression:
        forest.value[:, 0] = _safe_mean(root_counts)
    return forest


def _stream_plan_write(forest, slot_node, hist, feature_mask, level: int, config: ForestConfig):
    """T_NS and the node writes of one level, from the accumulated
    histogram (the split scan once, over all F)."""
    scores, n_node = level_scores(hist, feature_mask, regression=config.regression,
                                  backend=config.split_backend)
    split_rank, is_split, child_base = plan_level(scores, n_node, slot_node, config, level)
    forest = write_level(forest, slot_node, split_rank, is_split, child_base, scores, config)
    return forest, scores, split_rank, next_frontier(is_split, child_base, config.frontier)


def _stream_plan_write_reuse(forest, slot_node, packed_h, cache, feature_mask, level: int,
                             config: ForestConfig):
    """Reuse-mode ``_stream_plan_write``: the level's packed (small-child)
    histogram is expanded against the cache (``parent - small``), scored
    in paired-row order and permuted back to slots; the refreshed cache
    (this level's paired tensor and the next level's small-side plan)
    rides out with the plan."""
    scores, n_node, hist2, perm = reuse_expand_scores(packed_h, cache, feature_mask, config)
    split_rank, is_split, child_base = plan_level(scores, n_node, slot_node, config, level)
    forest = write_level(forest, slot_node, split_rank, is_split, child_base, scores, config)
    parent, small_right = sibling_plan(scores, split_rank, is_split,
                                       n_ranks=config.max_splits_per_level,
                                       regression=config.regression)
    cache = {"hist": hist2, "perm": perm, "parent": parent, "small_right": small_right}
    return (forest, scores, split_rank, next_frontier(is_split, child_base, config.frontier),
            cache)


def _stream_setup(x_binned, y, weights, config: ForestConfig, prefetch: int, dev: torch.device,
                  feeder_opts: Optional[dict] = None, quarantined: Sequence[int] = ()):
    """Host-side setup of the streamed growth: the validated block list
    and a ``BlockFeeder`` on ``dev`` over it. ``feeder_opts`` goes to
    the feeder (retry, backoff, ``fault_hook``, ``validator``);
    ``quarantined`` blocks leave every sweep."""
    from ..data.pipeline import BlockFeeder, stream_blocks

    y_np = host_array(y)
    w_np = host_array(weights).astype(np.float32, copy=False)
    blocks = stream_blocks(x_binned, config.sample_block, what="grow_forest_streamed",
                           n_y=y_np.shape[0], n_w=w_np.shape[1])
    offsets = np.concatenate([[0], np.cumsum([b.shape[0] for b in blocks])])
    if config.regression:
        y_np = y_np.astype(np.float32)
    feeder = BlockFeeder(blocks, placement=dev, prefetch=prefetch, quarantined=quarantined,
                         **(feeder_opts or {}))
    return feeder, y_np, w_np, offsets


def _stream_state_like(sizes: Sequence[int], config: ForestConfig, hist_width: int,
                       dev: torch.device) -> dict:
    """Structure template of the streamed growth checkpoint (reference:
    ``repro/core/api.py:_stream_state_like``): the level loop's whole
    carry. ``scores`` and ``split_rank`` are part of it because each
    level's routing runs in the next level's block sweep, so resuming at
    level L + 1 needs level L's plan. One slot table per block,
    quarantined ones too (zeros), so the structure does not depend on
    which blocks were quarantined. ``hist_width > 0`` adds the reuse
    cache; with reuse off the entry is ``None`` (no leaf)."""
    k, S = config.n_trees, config.frontier
    C = 3 if config.regression else config.n_classes

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "forest": init_forest(config, dev),
        "slot_node": zeros(k, S),
        "scores": SplitScores(zeros(k, S, dtype=torch.float32), zeros(k, S), zeros(k, S),
                              zeros(k, S, C, dtype=torch.float32),
                              zeros(k, S, C, dtype=torch.float32)),
        "split_rank": zeros(k, S),
        "slots": [zeros(k, n) for n in sizes],
        "level": 0,
        "hist_cache": init_hist_cache(config, hist_width, dev) if hist_width > 0 else None,
    }


def grow_forest_streamed(
    x_binned,
    y,
    weights,
    config: ForestConfig,
    feature_mask=None,
    *,
    prefetch: int = 2,
    device=None,
    manager=None,
    resume_from: Optional[str] = None,
    on_level=None,
    feeder_opts: Optional[dict] = None,
    quarantined: Sequence[int] = (),
    stats: Optional[dict] = None,
) -> Forest:
    """Out-of-core ``grow_forest`` over the streaming data plane (reference:
    ``repro/core/api.py:grow_forest_streamed``).

    ``x_binned`` is a host array / ``np.memmap`` of uint8 bins ``[N, F]``
    (sliced into ``config.sample_block``-row views, no copy) or a list
    of ``[Nb, F]`` blocks; ``y`` and ``weights`` may be arrays or
    tensors. Per level, each live block is fed once (a ``BlockFeeder``
    keeps ``prefetch`` copies in flight) and one ``stream_block_step``
    routes it from the previous level's plan and adds its histogram
    into the level's ``[k, S, F, B, C]`` carry; then the split scan runs
    once over the carry, and ``plan_level`` / ``write_level`` /
    ``next_frontier`` write the level. Labels, weights and the per-block
    slot tables stay on the device across levels. Root counts come from
    the level-0 histogram. Early exit is on the host, once a level.

    DSI counts are integers, so the forest equals the resident
    ``grow_forest``'s array for array; regression agrees to rounding.
    ``quarantined`` blocks (plus any a ``validator`` in ``feeder_opts``
    flags) are never transferred, routed or histogrammed.

    **Checkpointing.** ``manager`` saves the loop's whole carry
    (``_stream_state_like``) after each level, as step ``level + 1``;
    ``resume_from`` restores the newest CRC-verified carry
    (``restore_latest_valid``: a corrupt or torn step is skipped) and the
    loop continues at the restored level with the restored plan, giving
    the uninterrupted forest bitwise. An empty or all-corrupt directory
    is a fresh start. ``on_level(level + 1, forest)`` fires after each
    level's checkpoint.

    ``stats``, a dict, receives ``levels_s`` (the seconds of each level
    this call ran: its ``growth.level`` span, from the start of the
    level's sweep to the return of the early-exit check that reads its
    frontier; the last one, at ``max_depth``, ends in a synchronise
    outside ``growth.sync``, so its span stays unsynced),
    ``feed_wait_s`` (the growth sweeps' summed wait for the feed,
    ``BlockFeeder.wait_s``) and ``retries``.
    """
    dev = resolve_device(device)
    feeder, y_np, w_np, offsets = _stream_setup(
        x_binned, y, weights, config, prefetch, dev, feeder_opts, quarantined
    )
    k, S, B = config.n_trees, config.frontier, config.n_bins
    F = feeder.blocks[feeder.live_blocks[0]].shape[1]
    C = 3 if config.regression else config.n_classes
    mask = None if feature_mask is None else as_tensor(feature_mask, dev, torch.bool)
    # Reuse: blocks go into R rank segments (half the carry), and the plan
    # step subtracts the large children from the cache.
    reuse = resolve_hist_reuse(config, F)
    n_rows = config.max_splits_per_level if reuse else S
    sizes = np.diff(offsets).tolist()
    plane = LocalPlane(hist_fixed=regression_fixed_point(y_np, w_np) if config.regression else None)

    try:
        # Per-block constants, on the device once for the whole growth (none
        # for a quarantined block).
        base_dev, w_dev = {}, {}
        for i in feeder.live_blocks:
            o0, o1 = offsets[i], offsets[i + 1]
            base_dev[i] = _channels(feeder.pin(y_np[o0:o1]), config)
            w_dev[i] = feeder.pin(w_np[:, o0:o1])
        state = None
        if resume_from is not None:
            from ..checkpoint.checkpoint import restore_latest_valid

            restored = restore_latest_valid(
                _stream_state_like(sizes, config, F if reuse else 0, dev), resume_from, device=dev)
            if restored is not None:
                state = restored[0]
        if state is not None:
            forest, slot_node, scores = state["forest"], state["slot_node"], state["scores"]
            split_rank, slot_dev, start = state["split_rank"], state["slots"], state["level"]
            cache = state["hist_cache"]
        else:
            slot_dev = [torch.zeros((k, n), dtype=torch.int32, device=dev) for n in sizes]
            slot_node = torch.full((k, S), -1, dtype=torch.int32, device=dev)
            slot_node[:, 0] = 0
            forest = scores = split_rank = None
            cache = init_hist_cache(config, F, dev) if reuse else None
            start = 0

        def level_sweep(route: bool) -> torch.Tensor:
            hist = torch.zeros((k, n_rows, F, B, C), dtype=torch.float32, device=dev)
            for i, xb_b in zip(feeder.live_blocks, feeder.sweep()):
                _, slot_dev[i] = stream_block_step(
                    hist, xb_b, base_dev[i], w_dev[i], slot_dev[i], slot_node,
                    split_rank, scores, config, plane, route=route,
                    small_right=cache["small_right"] if reuse else None,
                )
            return hist

        level = start
        live = level < config.max_depth and bool((slot_node >= 0).any())
        while live:
            with tracing.level(timed=stats is not None) as lv:
                hist = level_sweep(route=level > 0)
                if forest is None:
                    forest = _stream_init(hist, config)     # root node, free at level 0
                if reuse:
                    forest, scores, split_rank, slot_node, cache = _stream_plan_write_reuse(
                        forest, slot_node, hist, cache, mask, level, config)
                else:
                    forest, scores, split_rank, slot_node = _stream_plan_write(
                        forest, slot_node, hist, mask, level, config)
                del hist
                level += 1
                if manager is not None:
                    manager.maybe_save({
                        "forest": forest, "slot_node": slot_node, "scores": scores,
                        "split_rank": split_rank, "slots": slot_dev, "level": level,
                        "hist_cache": cache,
                    }, level)
                if on_level is not None:
                    on_level(level, forest)
                live = level < config.max_depth
                if live:
                    with lv.sync():
                        live = bool((slot_node >= 0).any())
                elif stats is not None and dev.type == "cuda":
                    torch.cuda.synchronize(dev)             # the last level's seconds
            if stats is not None:
                stats.setdefault("levels_s", []).append(lv.seconds)
        if forest is None:                              # max_depth == 0: the root only
            forest = _stream_init(level_sweep(route=False), config)
        if stats is not None:
            stats.update(feed_wait_s=feeder.wait_s, retries=feeder.retries)
    finally:
        feeder.close()
    return finalize_forest(forest)
