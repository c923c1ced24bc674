"""The one module of the benchmark that calls the program under test, ``repro_torch``.

What the benchmark takes from the program: its entry points
(``fit_prf_from_draws``, ``PRFModel.predict``), the stage functions that
``fit_prf_from_draws`` and ``PRFModel.predict`` run on the resident path
(replayed in their order by a traced run, each stage a span), and the
kernels' launch counters. Nothing here is imported before a run has
started, so the CPU tests import the benchmark without the program's
kernels.
"""
from __future__ import annotations

import numpy as np


def forest_config(cfg: dict):
    """The program's ``ForestConfig`` of a configuration file."""
    from repro_torch.core.types import ForestConfig

    return ForestConfig(**cfg["forest"], n_classes=cfg["n_classes"])


def counters() -> dict:
    """Kernel launches so far in this process, by layer (the program's own counters)."""
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.kernels.tree_traverse import ops as trav_ops

    return {"hist": hist_ops.launches, "split_scan": scan_ops.launches,
            "traverse": trav_ops.launches}


def fit(x, y, fcfg, w, u, dev):
    """One training on host rows: ``fit_prf_from_draws``, resident."""
    from repro_torch.core.api import fit_prf_from_draws

    return fit_prf_from_draws(x, y, fcfg, w, u, device=dev)


def outputs(model) -> dict:
    """What a training answers: the forest's arrays, its tree weights and the bin edges."""
    f = model.forest
    return {"feature": f.feature, "threshold": f.threshold, "left_child": f.left_child,
            "class_counts": f.class_counts, "tree_weight": f.tree_weight,
            "edges": np.asarray(model.bin_edges)}


def replay_fit(x, y, fcfg, w, u, dev, spans):
    """``fit_prf_from_draws``'s resident classification path, stage by
    stage, each a span: validation, binning, dimension reduction, growth
    and OOB tree weights. Returns (model, feature mask)."""
    from repro_torch.core.api import PRFModel
    from repro_torch.core.binning import bin_dataset
    from repro_torch.core.dimred import dimension_reduction
    from repro_torch.core.forest import grow_forest
    from repro_torch.core.voting import oob_accuracy
    from repro_torch.data.pipeline import screen_blocks
    from repro_torch.device import as_tensor

    y = np.asarray(y)
    cfg = fcfg.resolved(np.shape(x)[1])
    with spans.stage("validation"):
        screen_blocks([x], y, policy="raise", n_features=x.shape[1], n_classes=cfg.n_classes,
                      regression=False)
    with spans.stage("binning"):
        xb, edges = bin_dataset(x, cfg.n_bins, device=dev)
    with spans.stage("dimred"):
        y_t = as_tensor(y, dev)
        mask = dimension_reduction(xb, y_t, w, cfg, u)
    with spans.stage("growth"):
        forest = grow_forest(xb, y_t, w, cfg, mask, device=dev)
    with spans.stage("oob"):
        forest.tree_weight = oob_accuracy(forest, xb, y_t, w)
    return PRFModel(forest=forest, bin_edges=edges), mask


def predict(model, x) -> np.ndarray:
    """One scoring call on host rows: ``PRFModel.predict``."""
    return model.predict(x)


def replay_predict(model, x, spans) -> np.ndarray:
    """``PRFModel.predict``'s resident classification path, each stage a
    span: the rows' copy and binning on the device, the traversal and
    weighted vote, the labels' copy to the host."""
    from repro_torch.core.voting import predict as vote

    with spans.stage("to_bins"):
        xb = model._binned(x)
    with spans.stage("vote"):
        labels = vote(model.forest, xb)
    with spans.stage("to_host"):
        return labels.cpu().numpy()
