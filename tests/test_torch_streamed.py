"""Port parity of the streaming data plane: ``repro_torch``'s streamed
growth, dimension reduction, OOB weights, prediction and trainer against
``repro``'s (same DSI weights, masks and draws) and against the port's
own resident path, on the CPU.

* ``grow_forest_streamed``: every Forest array bitwise, 4 blocks plus a
  remainder, ``prefetch`` 0 and 2, histogram reuse off and ``"auto"``
  (which resolves on at this size); regression within float rounding.
* The resident ``grow_forest`` with ``sample_block`` 150 and 256 (a
  remainder) equals the one-shot histogram path bitwise.
* ``fit_prf_from_draws`` on an ``np.memmap`` with ``sample_block > 0``,
  given the reference's draws, against ``repro.core.api.train_prf``:
  Forest arrays, ``bin_edges`` (sketch and exact), ``tree_weight``,
  labels and the ``quarantine`` report under "sanitize" and "quarantine".
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import dimred as jdimred
from repro.core import voting as jvoting
from repro.core.binning import bin_dataset
from repro.core.dsi import bootstrap_counts
from repro.core.forest import grow_forest as jgrow
from repro.core.types import ForestConfig as JConfig
from repro.data.tabular import make_classification
from repro_torch import fit_prf_from_draws, train_prf
from repro_torch.core import api as tapi
from repro_torch.core import engine as E
from repro_torch.core.dimred import dimension_reduction, dimension_reduction_streamed
from repro_torch.core.forest import grow_forest as tgrow
from repro_torch.core.types import Forest, ForestConfig as TConfig
from repro_torch.core.voting import (
    oob_accuracy, oob_accuracy_streamed, predict, predict_scores_streamed, predict_streamed,
)

FIELDS = Forest.FIELDS[:-1]      # tree_weight is set by train_prf, not growth
BLOCK = 140                      # 600 rows: 4 blocks and a remainder of 40


def _tc(jcfg, **over):
    return TConfig(**dict(dataclasses.asdict(jcfg), **over))


def _equal(fj, ft, fields=FIELDS):
    for name in fields:
        np.testing.assert_array_equal(np.asarray(getattr(fj, name)), getattr(ft, name).numpy(),
                                      err_msg=name)


@pytest.fixture(scope="module")
def case():
    x, y = make_classification(n_samples=600, n_features=13, n_classes=3, seed=3)
    xb = np.array(bin_dataset(x, 16)[0])
    w = np.array(bootstrap_counts(jax.random.PRNGKey(0), 6, xb.shape[0]))
    mask = np.random.default_rng(5).random((6, 13)) > 0.35
    return xb, y, w, mask


def _jcfg(hist_reuse, **over):
    kw = dict(n_trees=6, max_depth=5, n_bins=16, n_classes=3, sample_block=BLOCK,
              hist_reuse=hist_reuse)
    return JConfig(**dict(kw, **over))


@pytest.fixture(scope="module")
def reference_streamed(case):
    """The reference's streamed forests, one per reuse mode."""
    xb, y, w, mask = case
    return {reuse: japi.grow_forest_streamed(xb, y, w, _jcfg(reuse), mask)
            for reuse in ("off", "auto")}


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("reuse", ["off", "auto"])
def test_grow_forest_streamed_bitwise(case, reference_streamed, prefetch, reuse):
    xb, y, w, mask = case
    cfg = _tc(_jcfg(reuse))
    assert E.resolve_hist_reuse(cfg, xb.shape[1]) == (reuse == "auto")
    stats = {}
    ft = tapi.grow_forest_streamed(xb, y, w, cfg, mask, prefetch=prefetch, device="cpu",
                                   stats=stats)
    _equal(reference_streamed[reuse], ft)
    assert len(stats["levels_s"]) == E.levels_run(ft) and stats["retries"] == 0
    assert stats["feed_wait_s"] >= 0.0
    if prefetch == 0:           # a block list instead of an array source: the same forest
        blocks = [xb[i:i + BLOCK] for i in range(0, xb.shape[0], BLOCK)]
        fl = tapi.grow_forest_streamed(blocks, y, w, dataclasses.replace(cfg, sample_block=0),
                                       mask, device="cpu")
        _equal(reference_streamed[reuse], fl)


def test_grow_forest_streamed_equals_resident(case, reference_streamed):
    """Streamed growth is the resident forest, bitwise (the reference's
    resident ``grow_forest`` on the same inputs)."""
    xb, y, w, mask = case
    fj = jgrow(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w),
               _jcfg("off", sample_block=0), jnp.asarray(mask))
    _equal(fj, tapi.grow_forest_streamed(xb, y, w, _tc(_jcfg("off")), mask, device="cpu"))


def test_grow_forest_streamed_regression_close(case):
    xb, _, w, _ = case
    yr = np.random.default_rng(4).normal(size=xb.shape[0]).astype(np.float32)
    jcfg = JConfig(n_trees=6, max_depth=3, n_bins=16, regression=True, feature_mode="all",
                   sample_block=BLOCK, hist_reuse="off")
    fj = japi.grow_forest_streamed(xb, yr, w, jcfg, None)
    ft = tapi.grow_forest_streamed(xb, yr, w, _tc(jcfg), None, device="cpu")
    _equal(fj, ft, ("feature", "threshold", "left_child"))
    np.testing.assert_allclose(np.asarray(fj.value), ft.value.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(fj.class_counts), ft.class_counts.numpy(),
                               rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def resident_one_shot(case):
    """The port's resident forests without sample blocks, per reuse mode."""
    xb, y, w, mask = case
    return {reuse: tgrow(xb, y, w, TConfig(n_trees=6, max_depth=5, n_bins=16, n_classes=3,
                                           hist_reuse=reuse), mask, device="cpu")
            for reuse in ("off", "on")}


@pytest.mark.parametrize("sample_block", [150, 256])
@pytest.mark.parametrize("reuse", ["off", "on"])
def test_resident_sample_block_is_exact(case, resident_one_shot, sample_block, reuse):
    """The resident trainer's ``sample_block`` knob (histograms
    accumulated over row blocks, 256 leaving a remainder) gives the
    one-shot forest bitwise, with the reuse path too."""
    xb, y, w, mask = case
    cfg = TConfig(n_trees=6, max_depth=5, n_bins=16, n_classes=3, hist_reuse=reuse,
                  sample_block=sample_block)
    got = tgrow(xb, y, w, cfg, mask, device="cpu")
    for name in FIELDS:
        assert torch.equal(getattr(resident_one_shot[reuse], name), getattr(got, name)), name


def test_fused_slab_path_with_sample_blocks(case):
    """The card's slab-by-slab path (one slot grouping per block, shared
    by the slabs), driven through the plain versions, with blocks."""
    xb, y, w, _ = case
    from repro_torch.core.histograms import class_channels

    cfg = TConfig(n_trees=6, max_depth=4, n_bins=16, n_classes=3, hist_reuse="off",
                  sample_block=256)
    xt, wt = torch.from_numpy(xb), torch.from_numpy(w)
    base = class_channels(torch.from_numpy(y), 3)
    slot = torch.from_numpy(np.random.default_rng(0).integers(-1, 16, w.shape).astype(np.int32))
    one_shot = E.chunked_level_scores(xt, base, wt, slot, None,
                                      dataclasses.replace(cfg, sample_block=0))
    fused = E.fused_level_scores(xt, base, wt, slot, None, cfg)
    for a, b in zip(one_shot[0], fused[0]):
        assert torch.equal(a, b)
    assert torch.equal(one_shot[1], fused[1])


def test_dimension_reduction_streamed_bitwise(case):
    xb, y, w, _ = case
    jcfg = _jcfg("off").resolved(xb.shape[1])
    key = jax.random.PRNGKey(11)
    want = np.asarray(jdimred.dimension_reduction_streamed(xb, y, w, jcfg, key))
    u = np.array(jax.random.uniform(key, (6, xb.shape[1])))
    got = dimension_reduction_streamed(xb, y, w, _tc(jcfg), u, device="cpu")
    np.testing.assert_array_equal(want, got.numpy())
    resident = dimension_reduction(torch.from_numpy(xb), torch.from_numpy(y), torch.from_numpy(w),
                                   _tc(jcfg), torch.from_numpy(u))
    assert torch.equal(resident, got)


def test_oob_and_predict_streamed_bitwise(case, reference_streamed):
    xb, y, w, mask = case
    fj = reference_streamed["off"]
    ft = tapi.grow_forest_streamed(xb, y, w, _tc(_jcfg("off")), mask, device="cpu")
    xt, yt, wt = (torch.from_numpy(a) for a in (xb, y, w))
    for prefetch in (0, 2):
        oob = oob_accuracy_streamed(ft, xb, y, w, sample_block=BLOCK, prefetch=prefetch)
        np.testing.assert_array_equal(
            np.asarray(jvoting.oob_accuracy_streamed(fj, xb, y, w, sample_block=BLOCK)), oob.numpy())
        assert torch.equal(oob, oob_accuracy(ft, xt, yt, wt))
        labels = predict_streamed(ft, xb, sample_block=BLOCK, prefetch=prefetch)
        np.testing.assert_array_equal(
            np.asarray(jvoting.predict_streamed(fj, xb, sample_block=BLOCK)), labels.numpy())
        assert torch.equal(labels, predict(ft, xt))
    scores = predict_scores_streamed(ft, xb, sample_block=BLOCK)
    np.testing.assert_allclose(
        np.asarray(jvoting.predict_scores_streamed(fj, xb, sample_block=BLOCK)), scores.numpy(),
        rtol=1e-6, atol=1e-6)


def test_streamed_refusals(case, tmp_path):
    """Bad block sources still raise; the checkpoint arguments, which
    raised before checkpoints were ported, now run (and give the same
    forest)."""
    from repro_torch.checkpoint import CheckpointManager, list_steps

    xb, y, w, _ = case
    cfg = _tc(_jcfg("off"))
    with pytest.raises(ValueError, match="empty block sequence"):
        tapi.grow_forest_streamed([], y, w, cfg, device="cpu")
    with pytest.raises(ValueError, match="sample_block"):
        tapi.grow_forest_streamed(xb, y, w, dataclasses.replace(cfg, sample_block=0), device="cpu")
    with pytest.raises(ValueError, match="cover"):
        tapi.grow_forest_streamed([xb[:100]], y, w, cfg, device="cpu")
    want = tapi.grow_forest_streamed(xb, y, w, cfg, device="cpu")
    d, levels = str(tmp_path / "ckpt"), []
    for kw in (dict(manager=CheckpointManager(d, save_interval=1)), dict(resume_from=d),
               dict(on_level=lambda level, forest: levels.append(level))):
        got = tapi.grow_forest_streamed(xb, y, w, cfg, device="cpu", **kw)
        for n in FIELDS:
            assert torch.equal(getattr(want, n), getattr(got, n)), (n, list(kw))
    assert list_steps(d) == [3, 4, 5] and levels == [1, 2, 3, 4, 5]


# ---------------------------------------------------------------------------
# The trainer on an np.memmap, against repro.core.api.train_prf
# ---------------------------------------------------------------------------

TRAIN_BLOCK = 500                # 2250 training rows: 4 blocks and a remainder


@pytest.fixture(scope="module")
def memmap_case(class_data, tmp_path_factory):
    xtr, ytr, xte, yte = class_data
    path = tmp_path_factory.mktemp("streamed") / "x.f32"
    mm = np.memmap(path, np.float32, "w+", shape=xtr.shape)
    mm[:] = xtr
    mm.flush()
    del mm
    return np.memmap(path, np.float32, "r", shape=xtr.shape), ytr, xte


def _draws(jcfg, n, f, seed):
    k_boot, k_dim = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(bootstrap_counts(k_boot, jcfg.n_trees, n)),
            np.asarray(jax.random.uniform(k_dim, (jcfg.n_trees, f))))


def _assert_models_equal(ref, model, xte):
    _equal(ref.forest, model.forest, Forest.FIELDS)
    np.testing.assert_array_equal(ref.bin_edges, model.bin_edges)
    np.testing.assert_array_equal(np.asarray(ref.predict(xte)), model.predict(xte))


def _train_jcfg(**over):
    return JConfig(**dict(dict(n_trees=5, max_depth=5, n_bins=32, n_classes=4,
                               sample_block=TRAIN_BLOCK, hist_reuse="off"), **over))


@pytest.fixture(scope="module")
def reference_memmap(memmap_case):
    """``repro``'s streamed trainer on the memmap, seed 3, per ``bin_fit``."""
    x, y, _ = memmap_case
    return {bin_fit: japi.train_prf(x, y, _train_jcfg(bin_fit=bin_fit), 3)
            for bin_fit in ("auto", "exact")}


@pytest.mark.parametrize("bin_fit", ["auto", "exact"])
def test_fit_from_draws_memmap_matches_reference(memmap_case, reference_memmap, bin_fit):
    x, y, xte = memmap_case
    jcfg = _train_jcfg(bin_fit=bin_fit)
    ref = reference_memmap[bin_fit]
    w, u = _draws(jcfg, *x.shape, 3)
    model = fit_prf_from_draws(x, y, _tc(jcfg), w, u, device="cpu")
    _assert_models_equal(ref, model, xte)
    assert model.quarantine.clean and model.forest.config.sample_block == TRAIN_BLOCK
    # the model predicts per block (600 > 500 rows), bitwise the resident call
    resident = tapi.PRFModel(dataclasses.replace(
        model.forest, config=dataclasses.replace(model.forest.config, sample_block=0)),
        model.bin_edges)
    np.testing.assert_array_equal(resident.predict(xte), model.predict(xte))
    np.testing.assert_array_equal(resident.predict_scores(xte), model.predict_scores(xte))


@pytest.mark.parametrize("policy", ["sanitize", "quarantine"])
def test_fit_from_draws_dirty_memmap_matches_reference(memmap_case, tmp_path, policy):
    x0, y0, xte = memmap_case
    x = np.array(x0)
    x[5, 3] = np.nan                     # block 0: one non-finite cell
    x[1200, 7] = np.inf                  # block 2
    y = y0.copy()
    y[1600] = 9                          # block 3: an out-of-range label
    path = tmp_path / "dirty.f32"
    mm = np.memmap(path, np.float32, "w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    x = np.memmap(path, np.float32, "r", shape=x.shape)
    jcfg = _train_jcfg()
    ref = japi.train_prf(x, y, jcfg, 4, bad_block_policy=policy)
    w, u = _draws(jcfg, *x.shape, 4)
    model = fit_prf_from_draws(x, y, _tc(jcfg), w, u, device="cpu", bad_block_policy=policy)
    _assert_models_equal(ref, model, xte)
    assert dataclasses.asdict(ref.quarantine) == dataclasses.asdict(model.quarantine)
    assert model.quarantine.quarantined == ([0, 2, 3] if policy == "quarantine" else [])


def test_train_prf_memmap_own_draws_and_checkpoint_knobs(memmap_case, reference_memmap,
                                                        class_data, tmp_path):
    """``train_prf`` reaches the streamed trainer with its own draws: the
    same model twice, accuracy near the reference's; the checkpoint
    arguments run (checkpoints written, a resume from them gives the same
    model); ``feeder_opts`` reaches the feeder (a fault hook that fails
    twice changes nothing)."""
    x, y, xte = memmap_case
    yte = class_data[3]
    cfg = _tc(_train_jcfg())
    a = train_prf(x, y, cfg, 1, device="cpu")
    fails = {"n": 0}

    def flaky(site):
        if site.startswith("block") and fails["n"] < 2:
            fails["n"] += 1
            raise OSError(f"page-in failed at {site}")

    b = train_prf(x, y, cfg, 1, device="cpu",
                  feeder_opts=dict(fault_hook=flaky, backoff=1e-4))
    assert fails["n"] == 2
    for name in Forest.FIELDS:
        assert torch.equal(getattr(a.forest, name), getattr(b.forest, name)), name
    ref = reference_memmap["auto"]
    assert abs(a.accuracy(xte, yte) - ref.accuracy(xte, yte)) <= 0.05
    d = str(tmp_path / "ckpt")
    for kw in (dict(checkpoint_dir=d, checkpoint_keep=2), dict(resume_from=d)):
        c = train_prf(x, y, cfg, 1, device="cpu", **kw)
        for name in Forest.FIELDS:
            assert torch.equal(getattr(a.forest, name), getattr(c.forest, name)), (name, kw)
    assert os.listdir(d) and sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
