"""Port parity: ``repro_torch`` growth against ``repro.core.forest.grow_forest``
on a LocalPlane, same DSI weights and feature mask: every Forest array
bitwise, for early exit on and off, a ``tree_chunk`` that does not divide
k, and masks from importance, random and all feature modes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.binning import bin_dataset
from repro.core.dimred import dimension_reduction, random_feature_mask
from repro.core.dsi import bootstrap_counts
from repro.core.forest import grow_forest as jgrow
from repro.core.types import ForestConfig as JConfig
from repro.data.tabular import make_classification
from repro_torch.core import engine as E
from repro_torch.core.forest import grow_forest as tgrow
from repro_torch.core.histograms import class_channels
from repro_torch.core.types import Forest, ForestConfig as TConfig

FIELDS = Forest.FIELDS[:-1]      # tree_weight is set by train_prf, not growth


@pytest.fixture(scope="module")
def case():
    x, y = make_classification(n_samples=600, n_features=13, n_classes=3, seed=3)
    xb, _ = bin_dataset(x, 16)
    w = np.array(bootstrap_counts(jax.random.PRNGKey(0), 8, xb.shape[0]))
    return np.array(xb), y, w


def _mask(mode, cfg, xb, y, w):
    if mode == "all":
        return None
    key = jax.random.PRNGKey(1)
    if mode == "random":
        return np.asarray(random_feature_mask(key, n_trees=cfg.n_trees, n_features=xb.shape[1],
                                              n_selected=cfg.n_selected))
    return np.asarray(dimension_reduction(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w), cfg, key))


def _assert_forest_equal(fj, ft):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(fj, name)), getattr(ft, name).numpy(), err_msg=name)


@pytest.mark.parametrize("mode", ["importance", "random", "all"])
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("tree_chunk", [0, 3])
def test_grow_forest_bitwise(case, mode, early_exit, tree_chunk):
    xb, y, w = case
    cfg = JConfig(n_trees=8, max_depth=4, n_bins=16, n_classes=3, feature_mode=mode,
                  early_exit=early_exit, tree_chunk=tree_chunk, hist_reuse="off").resolved(xb.shape[1])
    mask = _mask(mode, cfg, xb, y, w)
    fj = jgrow(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w), cfg,
               None if mask is None else jnp.asarray(mask))
    ft = tgrow(xb, y, w, TConfig(**dataclasses.asdict(cfg)), mask, device="cpu")
    _assert_forest_equal(fj, ft)


def test_depth_starved_frontier_and_packed(case):
    """A narrow beam (max_frontier=4) with packed histograms."""
    xb, y, w = case
    cfg = JConfig(n_trees=8, max_depth=5, max_frontier=4, n_bins=16, n_classes=3,
                  feature_mode="all", packed_hist=True, hist_reuse="off")
    fj = jgrow(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w), cfg, None)
    ft = tgrow(xb, y, w, TConfig(**dataclasses.asdict(cfg)), None, device="cpu")
    _assert_forest_equal(fj, ft)


def test_fused_slab_path_equals_full_histogram_path(case):
    """The slab-by-slab path the card runs (histogram slab -> split-scan
    carry), driven here through the plain versions, gives the one-shot
    winners bitwise."""
    xb, y, w = case
    cfg = TConfig(n_trees=8, max_depth=4, n_bins=16, n_classes=3, hist_reuse="off")
    xt, wt = torch.from_numpy(xb), torch.from_numpy(w)
    base = class_channels(torch.from_numpy(y), 3)
    slot = torch.from_numpy(np.random.default_rng(0).integers(-1, 16, w.shape).astype(np.int32))
    mask = torch.from_numpy(np.random.default_rng(1).random((8, 13)) > 0.3)
    one_shot = E.chunked_level_scores(xt, base, wt, slot, mask, cfg)
    orig = E.hist_feature_slab
    try:
        E.hist_feature_slab = lambda *a, **k: 4      # force 4 slabs of <= 4 features
        fused = E.fused_level_scores(xt, base, wt, slot, mask, cfg)
    finally:
        E.hist_feature_slab = orig
    for a, b in zip(one_shot[0], fused[0]):
        assert torch.equal(a, b)
    assert torch.equal(one_shot[1], fused[1])


def test_rank_splits_is_stable_on_ties():
    gain = torch.tensor([[0.5, 0.7, 0.5, 0.7, 0.1]])
    valid = torch.tensor([[True, True, True, True, False]])
    np.testing.assert_array_equal(E._rank_splits(gain, valid, 3).numpy(), [[2, 0, -1, 1, -1]])


def test_unported_paths_raise(case):
    """The two configurations growth refused before the streaming plane was
    ported (``sample_block > 0``, ``bin_fit="blocked"``) now grow, and
    give the resident forest bitwise (histograms summed over 64-row
    blocks are exact for integer counts; ``bin_fit`` does not reach
    growth)."""
    xb, y, w = case
    want = tgrow(xb, y, w, TConfig(n_trees=8, max_depth=3, n_bins=16, n_classes=3,
                                   hist_reuse="off"), None, device="cpu")
    for kw in (dict(sample_block=64, hist_reuse="off"), dict(bin_fit="blocked", hist_reuse="off")):
        cfg = TConfig(n_trees=8, max_depth=3, n_bins=16, n_classes=3, **kw)
        got = tgrow(xb, y, w, cfg, None, device="cpu")
        for name in FIELDS:
            assert torch.equal(getattr(want, name), getattr(got, name)), (kw, name)


def test_levels_run_from_pool(case):
    xb, y, w = case
    cfg = TConfig(n_trees=8, max_depth=4, n_bins=16, n_classes=3, feature_mode="all", hist_reuse="off")
    ft = tgrow(xb, y, w, cfg, None, device="cpu")
    assert E.levels_run(ft) == 4


def test_grow_forest_regression_close(case):
    """Regression channels [1, y, y^2] are not integer sums, so histograms
    agree to rounding only; on this case the structure comes out equal."""
    xb, _, w = case
    yr = np.random.default_rng(4).normal(size=xb.shape[0]).astype(np.float32)
    cfg = JConfig(n_trees=8, max_depth=3, n_bins=16, regression=True, feature_mode="all",
                  hist_reuse="off")
    fj = jgrow(jnp.asarray(xb), jnp.asarray(yr), jnp.asarray(w), cfg, None)
    ft = tgrow(xb, yr, w, TConfig(**dataclasses.asdict(cfg)), None, device="cpu")
    for name in ("feature", "threshold", "left_child"):
        np.testing.assert_array_equal(np.asarray(getattr(fj, name)), getattr(ft, name).numpy())
    np.testing.assert_allclose(np.asarray(fj.value), ft.value.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_dimension_reduction_mask_bitwise_over_seeds(seed):
    """Root gain ratios match the reference to rounding only (the bin-axis
    sum order differs), yet given the reference's draws the selected
    feature mask is bitwise the reference's on every seed."""
    from repro_torch.core.dimred import dimension_reduction as tdimred

    x, y = make_classification(n_samples=500 + 37 * seed, n_features=24, n_classes=3,
                               n_informative=6, seed=seed)
    xb = np.array(bin_dataset(x, 16)[0])
    w = np.array(bootstrap_counts(jax.random.PRNGKey(seed), 8, xb.shape[0]))
    cfg = JConfig(n_trees=8, max_depth=4, n_bins=16, n_classes=3,
                  feature_mode="importance").resolved(xb.shape[1])
    key = jax.random.PRNGKey(1000 + seed)
    want = np.asarray(dimension_reduction(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w), cfg, key))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (8, xb.shape[1]))))
    got = tdimred(torch.from_numpy(xb), torch.from_numpy(y), torch.from_numpy(w),
                  TConfig(**dataclasses.asdict(cfg)), u)
    np.testing.assert_array_equal(want, got.numpy())
