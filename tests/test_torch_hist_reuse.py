"""Port parity: sibling-subtraction histogram reuse (``hist_reuse``) in
``repro_torch`` against ``repro``.

* ``sibling_plan``, ``sibling_segments``, ``sibling_perm`` and
  ``sibling_expand`` are bitwise the reference's on random inputs with
  parked samples and unused ranks.
* Classification: the port's reuse-on forests equal its reuse-off
  forests bitwise (early exit on and off, a ``tree_chunk`` that does not
  divide k), and equal ``repro``'s reuse forests given the same weights
  and mask. Integer DSI counts keep every ``parent - small`` exact.
* Regression: same structure, values within 1e-5 (the reference's own bar).
* The budget gate falls back to reuse off; ``auto`` resolves on for
  classification only; the small default configuration trains.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gain as jgain
from repro.core import histograms as jhist
from repro.core.binning import bin_dataset
from repro.core.dimred import dimension_reduction
from repro.core.dsi import bootstrap_counts
from repro.core.forest import grow_forest as jgrow
from repro.core.types import ForestConfig as JConfig
from repro.data.tabular import make_classification, make_regression
from repro_torch import ForestConfig as TConfig
from repro_torch import train_prf
from repro_torch.core import engine as E
from repro_torch.core import gain as tgain
from repro_torch.core import histograms as thist
from repro_torch.core.forest import grow_forest as tgrow
from repro_torch.core.histograms import class_channels
from repro_torch.core.types import Forest

FIELDS = Forest.FIELDS[:-1]      # tree_weight is set by train_prf, not growth


@pytest.fixture(scope="module")
def reuse_case():
    """The reference's reuse fixture (tests/test_hist_reuse.py)."""
    x, y = make_classification(n_samples=600, n_features=13, n_classes=3, seed=3)
    cfg = JConfig(n_trees=6, max_depth=4, n_bins=16, n_classes=3, feature_mode="all")
    xb, _ = bin_dataset(x, cfg.n_bins)
    w = np.asarray(bootstrap_counts(jax.random.PRNGKey(0), cfg.n_trees, xb.shape[0])).astype(np.float32)
    return np.array(xb), y, w, cfg


def _tcfg(jcfg, **kw):
    return TConfig(**dict(dataclasses.asdict(jcfg), **kw))


def _grow_t(xb, y, w, cfg, mask=None):
    return tgrow(xb, y, w, cfg, mask, device="cpu")


def _assert_equal(a, b, msg=""):
    for name in FIELDS:
        ga, gb = getattr(a, name), getattr(b, name)
        ga = ga.numpy() if torch.is_tensor(ga) else np.asarray(ga)
        gb = gb.numpy() if torch.is_tensor(gb) else np.asarray(gb)
        np.testing.assert_array_equal(ga, gb, err_msg=f"{name} {msg}")


def _random_plan_inputs(rng, k, S, C):
    """Winners with integer child counts (ties included) and a dense beam rank."""
    R = max(S // 2, 1)
    left = rng.integers(0, 4, (k, S, C)).astype(np.float32)
    right = rng.integers(0, 4, (k, S, C)).astype(np.float32)
    valid = rng.random((k, S)) < 0.6
    n_max = max(1, R - 1)                      # leave at least one rank unused
    rank = np.full((k, S), -1, np.int32)
    for t in range(k):
        cand = rng.permutation(np.flatnonzero(valid[t]))[:n_max]
        rank[t, cand] = np.arange(len(cand))
    rank[-1] = -1                              # a tree whose frontier admitted no split
    gain = rng.random((k, S)).astype(np.float32)
    feat = rng.integers(0, 5, (k, S)).astype(np.int32)
    thr = rng.integers(0, 7, (k, S)).astype(np.int32)
    return (gain, feat, thr, left, right), rank, R


@pytest.mark.parametrize("k,S,C,regression", [(3, 8, 3, False), (4, 16, 2, False), (2, 8, 3, True),
                                              (2, 2, 4, False)])
def test_sibling_plan_bitwise(k, S, C, regression):
    rng = np.random.default_rng(10 + S + C)
    fields, rank, R = _random_plan_inputs(rng, k, S, C)
    is_split = rank >= 0
    pj, sj = jgain.sibling_plan(jgain.SplitScores(*map(jnp.asarray, fields)), jnp.asarray(rank),
                                jnp.asarray(is_split), n_ranks=R, regression=regression)
    pt, st = tgain.sibling_plan(tgain.SplitScores(*map(torch.from_numpy, fields)),
                                torch.from_numpy(rank), torch.from_numpy(is_split),
                                n_ranks=R, regression=regression)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert (pt.numpy() == -1).any()            # an unused rank is in the case


@pytest.mark.parametrize("k,N,S", [(3, 200, 8), (2, 57, 16), (4, 31, 2)])
def test_sibling_segments_and_perm_bitwise(k, N, S):
    rng = np.random.default_rng(N)
    R = max(S // 2, 1)
    slot = rng.integers(-1, S, (k, N)).astype(np.int32)          # -1 = parked
    small_right = rng.integers(0, 2, (k, R)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jhist.sibling_segments(jnp.asarray(slot), jnp.asarray(small_right))),
        thist.sibling_segments(torch.from_numpy(slot), torch.from_numpy(small_right)).numpy())
    for n_slots in (S, S + 3):
        np.testing.assert_array_equal(
            np.asarray(jhist.sibling_perm(jnp.asarray(small_right), n_slots)),
            thist.sibling_perm(torch.from_numpy(small_right), n_slots).numpy())


@pytest.mark.parametrize("k,S,F,B,C,n_slots", [(3, 8, 5, 4, 3, 8), (2, 4, 3, 6, 2, 6), (2, 2, 2, 3, 4, 2)])
def test_sibling_expand_bitwise(k, S, F, B, C, n_slots):
    rng = np.random.default_rng(S * F)
    R = max(S // 2, 1)
    packed = rng.integers(0, 5, (k, R, F, B, C)).astype(np.float32)
    cache = rng.integers(0, 50, (k, S, F, B, C)).astype(np.float32)
    perm = np.stack([rng.permutation(S) for _ in range(k)]).astype(np.int32)
    parent = rng.integers(-1, S, (k, R)).astype(np.int32)       # -1 = unused rank
    parent[:, -1] = -1
    got = thist.sibling_expand(*(torch.from_numpy(a) for a in (packed, cache, perm, parent)), n_slots)
    want = jhist.sibling_expand(*(jnp.asarray(a) for a in (packed, cache, perm, parent)), n_slots)
    assert tuple(got.shape) == (k, n_slots, F, B, C)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("tree_chunk", [0, 4])
def test_port_reuse_on_equals_off(reuse_case, early_exit, tree_chunk):
    xb, y, w, cfg = reuse_case
    base = _tcfg(cfg, early_exit=early_exit, tree_chunk=tree_chunk)
    on = _grow_t(xb, y, w, dataclasses.replace(base, hist_reuse="on"))
    off = _grow_t(xb, y, w, dataclasses.replace(base, hist_reuse="off"))
    _assert_equal(on, off, f"early_exit={early_exit} tree_chunk={tree_chunk}")


@pytest.mark.parametrize("mode,packed", [("all", False), ("importance", False), ("all", True)])
def test_port_reuse_equals_reference_reuse(reuse_case, mode, packed):
    xb, y, w, cfg = reuse_case
    jcfg = dataclasses.replace(cfg, feature_mode=mode, packed_hist=packed,
                               hist_reuse="on").resolved(xb.shape[1])
    mask = None
    if mode == "importance":
        mask = np.asarray(dimension_reduction(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w), jcfg,
                                              jax.random.PRNGKey(1)))
    fj = jgrow(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w), jcfg,
               None if mask is None else jnp.asarray(mask))
    ft = _grow_t(xb, y, w, _tcfg(jcfg), mask)
    _assert_equal(fj, ft, f"{mode} packed={packed}")


def test_fused_reuse_slab_path_equals_one_shot(reuse_case):
    """The slab-by-slab reuse path the card runs, driven through the plain
    versions, gives the one-shot path's winners, node counts and next
    cache bitwise, at a level with a real cache."""
    xb, y, w, cfg = reuse_case
    tcfg = _tcfg(cfg, hist_reuse="on")
    xt, wt = torch.from_numpy(xb), torch.from_numpy(w)
    base = class_channels(torch.from_numpy(y), 3)
    plane = E.LocalPlane(None)
    state = E.init_growth_state(base, wt, tcfg, plane, n_features=xb.shape[1])
    state = E.level_step(xt, base, wt, state, tcfg, plane)   # level 1 has a parent cache
    cache = state.hist_cache
    seg = thist.sibling_segments(state.sample_slot, cache["small_right"])
    packed = E._level_hists(xt, base, wt, seg, tcfg, n_slots=tcfg.max_splits_per_level)
    one = E.reuse_expand_scores(packed, cache, None, tcfg)
    orig = E.hist_feature_slab
    try:
        E.hist_feature_slab = lambda *a, **k: 4              # 4 slabs of <= 4 features
        fused = E.fused_level_scores(xt, base, wt, seg, None, tcfg, cache)
    finally:
        E.hist_feature_slab = orig
    perm = one[3]
    for a, b in zip(one[0], fused[0]):
        assert torch.equal(a, E._permute_rows(perm, b))
    assert torch.equal(one[1], E._permute_rows(perm, fused[1]))
    assert torch.equal(one[2], fused[2])


def test_regression_reuse_within_tolerance():
    x, y = make_regression(n_samples=500, n_features=10, seed=5)
    cfg = TConfig(n_trees=4, max_depth=4, n_bins=16, regression=True, n_classes=0, feature_mode="all")
    xb, _ = bin_dataset(x, cfg.n_bins)
    w = np.asarray(bootstrap_counts(jax.random.PRNGKey(2), cfg.n_trees, xb.shape[0])).astype(np.float32)
    xb = np.asarray(xb)
    on = _grow_t(xb, y, w, dataclasses.replace(cfg, hist_reuse="on"))
    off = _grow_t(xb, y, w, dataclasses.replace(cfg, hist_reuse="off"))
    for n in ("feature", "threshold", "left_child"):
        np.testing.assert_array_equal(getattr(on, n).numpy(), getattr(off, n).numpy(), err_msg=n)
    np.testing.assert_allclose(on.value.numpy(), off.value.numpy(), rtol=1e-5, atol=1e-5)


def test_budget_gate_and_auto_resolution(reuse_case):
    xb, y, w, cfg = reuse_case
    F = xb.shape[1]
    tcfg = _tcfg(cfg)
    assert tcfg.resolved_hist_reuse() == "on"
    assert dataclasses.replace(tcfg, regression=True).resolved_hist_reuse() == "off"
    assert E.resolve_hist_reuse(tcfg, F)
    tiny = dataclasses.replace(tcfg, hist_reuse_budget_mb=0)
    assert not E.resolve_hist_reuse(tiny, F)
    base = class_channels(torch.from_numpy(y), 3)
    wt = torch.from_numpy(w)
    assert E.init_growth_state(base, wt, tiny, E.LocalPlane(), n_features=F).hist_cache is None
    cache = E.init_growth_state(base, wt, tcfg, E.LocalPlane(), n_features=F).hist_cache
    assert tuple(cache["hist"].shape) == (6, tcfg.frontier, F, 16, 3)
    _assert_equal(_grow_t(xb, y, w, tiny), _grow_t(xb, y, w, dataclasses.replace(tcfg, hist_reuse="off")),
                  "budget fallback")


def test_small_default_configuration_trains():
    """``hist_reuse='auto'`` resolves on here (a 2 MiB cache): it trains,
    and gives the forest of reuse off, same seed."""
    x, y = make_classification(n_samples=2000, n_features=16, n_classes=2, seed=11)
    cfg = TConfig(n_trees=8, max_depth=6, n_bins=32, n_classes=2)
    assert E.resolve_hist_reuse(cfg.resolved(16), 16)
    model = train_prf(x, y, cfg, 0, device="cpu")
    off = train_prf(x, y, dataclasses.replace(cfg, hist_reuse="off"), 0, device="cpu")
    for name in Forest.FIELDS:
        assert torch.equal(getattr(model.forest, name), getattr(off.forest, name)), name
    assert model.accuracy(x, y) > 0.8
