"""Public PRF API — train / predict (resident path).

    bin -> DSI bootstrap -> dimension reduction (Alg. 3.1)
        -> level-synchronous growth (Alg. 4.2) -> OOB weights (Eq. 8)

Counterpart of ``repro/core/api.py`` (``train_prf`` with
``sample_block=0`` and ``PRFModel``). ``train_prf`` draws its randomness
with a ``torch.Generator`` on the device — the DSI counts ``[k, N]`` and
the uniform draws ``u [k, F]`` of feature selection — and hands them to
``fit_prf_from_draws``, which does everything else. That split is where
tests feed in the reference's JAX draws.

Entry points run on ``cuda`` unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from .binning import apply_bins, bin_dataset
from .dimred import dimension_reduction, random_feature_mask
from .dsi import bootstrap_counts
from .engine import check_ported
from .forest import grow_forest
from .types import Forest, ForestConfig
from .voting import oob_accuracy, predict, predict_regression, predict_scores


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
        return apply_bins(as_tensor(x, dev), torch.from_numpy(np.asarray(self.bin_edges)).to(dev))

    def predict(self, x) -> np.ndarray:
        xb = self._binned(x)
        if self.forest.config.regression:
            return predict_regression(self.forest, xb).cpu().numpy()
        return predict(self.forest, xb).cpu().numpy()

    def predict_scores(self, x) -> np.ndarray:
        """Weighted-vote class scores [N, C] (classification only)."""
        if self.forest.config.regression:
            raise ValueError(
                "predict_scores is classification-only; use predict() for regression models"
            )
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


def _check_resident(config: ForestConfig) -> None:
    if config.regression:
        raise NotImplementedError(
            "regression=True in train_prf is not ported yet (end-to-end regression: "
            "ROADMAP.md Queue 1 item 5, remainder)"
        )
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process training is not ported yet: ROADMAP.md Queue 1 item 10"
        )
    check_ported(config)


def train_prf(
    x: np.ndarray,
    y: np.ndarray,
    config: ForestConfig,
    seed: int = 0,
    *,
    device=None,
    bad_block_policy: Optional[str] = "raise",
    checkpoint_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
) -> PRFModel:
    """End-to-end PRF training on host data (paper §3 + §4 semantics).

    Draws the DSI bootstrap counts and the feature-selection uniforms with
    a ``torch.Generator(device).manual_seed(seed)`` — different numbers
    from the reference's JAX draws for the same seed — and calls
    ``fit_prf_from_draws``. Checkpointed growth (``checkpoint_dir`` /
    ``resume_from``) is not ported yet and raises.
    """
    if checkpoint_dir is not None or resume_from is not None:
        raise NotImplementedError(
            "checkpointed growth (checkpoint_dir / resume_from) is not ported yet: "
            "ROADMAP.md Queue 1 item 8"
        )
    dev = resolve_device(device)
    N, F = np.shape(x)
    config = config.resolved(F)
    _check_resident(config)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    weights = bootstrap_counts(gen, config.n_trees, N, dev)          # DSI §4.1.2
    u = torch.rand((config.n_trees, F), generator=gen, device=dev)
    return fit_prf_from_draws(
        x, y, config, weights, u, device=dev, bad_block_policy=bad_block_policy
    )


def fit_prf_from_draws(
    x: np.ndarray,
    y: np.ndarray,
    config: ForestConfig,
    weights,                      # [k, N] DSI in-bag counts
    u,                            # [k, F] uniform draws of feature selection
    *,
    device=None,
    bad_block_policy: Optional[str] = "raise",
) -> PRFModel:
    """Everything of ``train_prf`` after the random draws: validation,
    binning, dimension reduction, growth and OOB tree weights."""
    dev = resolve_device(device)
    x = np.asarray(x)
    y = np.asarray(y)
    config = config.resolved(x.shape[1])
    _check_resident(config)
    weights = as_tensor(weights, dev, torch.float32)
    u = as_tensor(u, dev, torch.float32)
    k, (N, F) = config.n_trees, x.shape
    if tuple(weights.shape) != (k, N) or tuple(u.shape) != (k, F) or y.shape != (N,):
        raise ValueError(
            f"need weights [{k}, {N}], u [{k}, {F}] and y [{N}]; got weights "
            f"{tuple(weights.shape)}, u {tuple(u.shape)}, y {y.shape}"
        )

    report, cell_mask, label_mask = None, None, None
    if bad_block_policy not in (None, "off"):
        from ..data.pipeline import DataIntegrityError, screen_blocks

        blocks1, y_clean, cmasks, lmasks, report = screen_blocks(
            [x], y, policy=bad_block_policy, n_features=x.shape[1],
            n_classes=config.n_classes, regression=False,
        )
        if not report.clean:
            if bad_block_policy == "quarantine":
                raise DataIntegrityError(
                    "bad_block_policy='quarantine' on the resident path "
                    "would drop the entire dataset (it is a single block) "
                    "— use 'sanitize'",
                    block_index=0, reason="quarantine",
                )
            x, y = blocks1[0], y_clean
            cell_mask, label_mask = cmasks.get(0), lmasks.get(0)

    xb, edges = bin_dataset(x, config.n_bins, device=dev)
    if cell_mask is not None:
        xb[torch.from_numpy(cell_mask).to(dev)] = 0          # imputed cells -> bin 0
    y_t = as_tensor(y, dev)
    if label_mask is not None:
        weights = torch.where(torch.from_numpy(label_mask).to(dev)[None, :], 0.0, weights)

    feature_mask = None
    if config.feature_mode == "importance":
        feature_mask = dimension_reduction(xb, y_t, weights, config, u)     # §3.2
    elif config.feature_mode == "random":
        feature_mask = random_feature_mask(u, n_selected=config.n_selected)

    forest = grow_forest(xb, y_t, weights, config, feature_mask, device=dev)  # §4.2

    if config.weighted_voting:                                            # §3.3
        xb_o, y_o, w_o = xb, y_t, weights
        if label_mask is not None:
            keep = torch.from_numpy(np.flatnonzero(~label_mask)).to(dev)
            xb_o, y_o, w_o = xb_o[keep], y_o[keep], w_o[:, keep]
        forest.tree_weight = oob_accuracy(forest, xb_o, y_o, w_o)
    return PRFModel(forest=forest, bin_edges=edges, quarantine=report)
