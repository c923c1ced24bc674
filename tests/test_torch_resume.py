"""Checkpointed growth and crash resume in the port, against ``repro``,
on the CPU, at the reference drills' size (600 x 13, 6 trees, depth 4).

* Leaf for leaf: given ``repro``'s draws, at every level the port's
  resident and streamed checkpoints (reuse off and ``"auto"``, which
  resolves on here) hold the
  reference's keys, without the resident ``3`` (its reserved ``rng``),
  with bitwise-equal arrays. The reference's checkpoints are read with
  ``repro.checkpoint``.
* Kill and resume at every level boundary, resident and streamed, reuse
  off and ``"auto"``, early exit on and off: the resumed model (forest,
  tree weights, predictions) equals the uninterrupted one and
  ``repro``'s forest, and the resumed run starts after the crash level.
* A corrupted newest step, an all-corrupt directory, an empty directory,
  ``checkpoint_every=2`` and a quarantined block.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import ForestConfig as JConfig
from repro.core import train_prf as jtrain
from repro.core.dsi import bootstrap_counts
from repro.data.tabular import make_classification
from repro_torch import fit_prf_from_draws
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.checkpoint import latest_step, list_steps
from repro_torch.core import api as tapi
from repro_torch.core.forest import grow_forest, grow_forest_checkpointed
from repro_torch.core.types import Forest, ForestConfig as TConfig
from repro_torch.launch.fault import CheckpointCorruptor

SEED = 0
BLOCK = 170                    # 600 rows: 3 blocks and a remainder of 90
MODES = [("resident", "off"), ("resident", "auto"), ("streamed", "off"), ("streamed", "auto")]


class _Kill(Exception):
    """Raised from ``on_level`` after the level's checkpoint: a crash at
    the level boundary."""


@pytest.fixture(scope="module")
def case():
    x, y = make_classification(n_samples=600, n_features=13, n_classes=3, seed=3)
    return x, y


def _jcfg(streamed, reuse, **over):
    kw = dict(n_trees=6, max_depth=4, n_bins=16, n_classes=3, feature_mode="all",
              hist_reuse=reuse, sample_block=BLOCK if streamed else 0)
    return JConfig(**dict(kw, **over))


def _tcfg(jcfg, **over):
    return TConfig(**dict(dataclasses.asdict(jcfg), **over))


def _draws(jcfg, n, f):
    """The draws of ``repro.core.api.train_prf`` for ``SEED``."""
    k_boot, k_dim = jax.random.split(jax.random.PRNGKey(SEED))
    return (np.asarray(bootstrap_counts(k_boot, jcfg.n_trees, n)),
            np.asarray(jax.random.uniform(k_dim, (jcfg.n_trees, f))))


def _fit(case, tcfg, **kw):
    x, y = case
    w, u = _draws(tcfg, *x.shape)
    return fit_prf_from_draws(x, y, tcfg, w, u, device="cpu", **kw)


def _assert_models_equal(a, b, x, msg=""):
    for n in Forest.FIELDS:
        assert torch.equal(getattr(a.forest, n), getattr(b.forest, n)), f"{n} {msg}"
    np.testing.assert_array_equal(a.predict(x), b.predict(x), err_msg=msg)


def _assert_forest_is_reference(ref, model, msg=""):
    for n in Forest.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref.forest, n)),
                                      getattr(model.forest, n).numpy(), err_msg=f"{n} {msg}")


@pytest.fixture(scope="module")
def reference(case):
    """``repro``'s model per (plane, reuse), and its checkpoint directory
    (every level kept)."""
    import tempfile

    x, y = case
    out = {}
    for plane, reuse in MODES:
        d = tempfile.mkdtemp(prefix=f"jckpt_{plane}_{reuse}_")
        out[plane, reuse] = (jtrain(x, y, _jcfg(plane == "streamed", reuse), SEED,
                                    checkpoint_dir=d, checkpoint_keep=10), d)
    return out


@pytest.mark.parametrize("plane,reuse", MODES)
def test_checkpoint_leaves_equal_the_reference(tmp_path, case, reference, plane, reuse):
    ref, jdir = reference[plane, reuse]
    tcfg = _tcfg(_jcfg(plane == "streamed", reuse))
    model = _fit(case, tcfg, checkpoint_dir=str(tmp_path), checkpoint_keep=10)
    _assert_forest_is_reference(ref, model)
    steps = list_steps(str(tmp_path))
    assert steps == jckpt.list_steps(jdir) == [1, 2, 3, 4]
    for step in steps:
        jpath, tpath = (os.path.join(d, f"step_{step:08d}") for d in (jdir, str(tmp_path)))
        jleaves = {e["key"]: jckpt._load_leaf(jpath, e) for e in jckpt._load_manifest(jpath)["leaves"]}
        tleaves = {e["key"]: tckpt._load_leaf(tpath, e) for e in tckpt._load_manifest(tpath)["leaves"]}
        if plane == "resident":
            assert jleaves.pop("3").dtype == np.uint32           # the reference's reserved rng
        assert list(tleaves) == list(jleaves), step
        assert any(k.endswith("hist") for k in tleaves) == (reuse == "auto")
        for key, arr in jleaves.items():
            assert tleaves[key].dtype == arr.dtype, (step, key)
            np.testing.assert_array_equal(tleaves[key], arr, err_msg=f"step {step} {key}")


def _levels_of(fit):
    levels = []
    fit(on_level=lambda level, _: levels.append(level))
    return levels


@pytest.mark.parametrize("early_exit", [True, False], ids=["early_exit", "no_early_exit"])
@pytest.mark.parametrize("plane,reuse", MODES)
def test_kill_and_resume_every_boundary(tmp_path, case, reference, plane, reuse, early_exit):
    x, _ = case
    tcfg = _tcfg(_jcfg(plane == "streamed", reuse), early_exit=early_exit)
    baseline = _fit(case, tcfg)
    _assert_forest_is_reference(reference[plane, reuse][0], baseline)
    levels = _levels_of(lambda **kw: _fit(case, tcfg, checkpoint_dir=str(tmp_path / "full"), **kw))
    assert levels == [1, 2, 3, 4]
    for kill_at in levels[:-1]:
        d = str(tmp_path / f"kill{kill_at}")

        def boom(level, _):
            if level == kill_at:
                raise _Kill

        with pytest.raises(_Kill):
            _fit(case, tcfg, checkpoint_dir=d, on_level=boom)
        assert latest_step(d) == kill_at
        resumed = _levels_of(lambda **kw: _fit(case, tcfg, checkpoint_dir=d, resume_from=d, **kw))
        assert resumed == levels[kill_at:], (kill_at, resumed)
        model = _fit(case, tcfg, resume_from=d)               # the final checkpoint: nothing regrows
        _assert_models_equal(model, baseline, x, f"kill@{kill_at}")


def test_shallow_forest_resumes_with_early_exit(tmp_path, case):
    """Trees that stop before ``max_depth``: the loop ends when every
    frontier is empty (with or without ``early_exit``), and a resume from
    any boundary gives the same forest as ``grow_forest``."""
    x, y = case
    from repro.core.binning import bin_dataset

    xb = np.asarray(bin_dataset(x, 16)[0])
    jcfg = _jcfg(False, "off", max_depth=6, min_samples_split=300)
    w, _ = _draws(jcfg, *x.shape)
    for early_exit in (True, False):
        cfg = _tcfg(jcfg, early_exit=early_exit).resolved(13)
        want = grow_forest(xb, y, w, cfg, device="cpu")
        levels = []
        grow_forest_checkpointed(xb, y, w, cfg, device="cpu",
                                 manager=tckpt.CheckpointManager(str(tmp_path / "a"), save_interval=1),
                                 on_level=lambda level, _: levels.append(level))
        assert 1 < len(levels) < cfg.max_depth, levels          # the frontier empties early
        for kill_at in levels[:-1]:
            d = str(tmp_path / f"e{early_exit}{kill_at}")

            def boom(level, _):
                if level == kill_at:
                    raise _Kill

            with pytest.raises(_Kill):
                grow_forest_checkpointed(xb, y, w, cfg, device="cpu", on_level=boom,
                                         manager=tckpt.CheckpointManager(d, save_interval=1))
            got = grow_forest_checkpointed(xb, y, w, cfg, device="cpu", resume_from=d)
            for n in Forest.FIELDS:
                assert torch.equal(getattr(got, n), getattr(want, n)), (early_exit, kill_at, n)


@pytest.mark.parametrize("plane", ["resident", "streamed"])
def test_corrupted_newest_step_resumes_bitwise(tmp_path, case, reference, plane):
    x, _ = case
    tcfg = _tcfg(_jcfg(plane == "streamed", "auto"))
    baseline = _fit(case, tcfg)
    kill_at, d = 2, str(tmp_path / plane)

    def boom(level, _):
        if level == kill_at:
            raise _Kill

    with pytest.raises(_Kill):
        _fit(case, tcfg, checkpoint_dir=d, on_level=boom)
    assert CheckpointCorruptor(seed=0).corrupt(d) == kill_at
    resumed = []
    with pytest.warns(RuntimeWarning, match="skipping corrupt checkpoint"):
        model = _fit(case, tcfg, resume_from=d, on_level=lambda level, _: resumed.append(level))
    assert min(resumed) == kill_at, resumed         # the walk-back regrows the crash level
    _assert_models_equal(model, baseline, x, plane)
    _assert_forest_is_reference(reference[plane, "auto"][0], model)


@pytest.mark.parametrize("plane", ["resident", "streamed"])
def test_all_corrupt_and_empty_directories_are_fresh_starts(tmp_path, case, plane):
    x, _ = case
    tcfg = _tcfg(_jcfg(plane == "streamed", "off"))
    baseline = _fit(case, tcfg)
    d = str(tmp_path / "allbad")

    def boom(level, _):
        if level == 2:
            raise _Kill

    with pytest.raises(_Kill):
        _fit(case, tcfg, checkpoint_dir=d, on_level=boom)
    for s in list_steps(d):
        CheckpointCorruptor(seed=s).corrupt(d, s)
    resumed = []
    with pytest.warns(RuntimeWarning):
        model = _fit(case, tcfg, resume_from=d, on_level=lambda level, _: resumed.append(level))
    assert resumed == [1, 2, 3, 4]
    _assert_models_equal(model, baseline, x, "all-corrupt")
    _assert_models_equal(_fit(case, tcfg, resume_from=str(tmp_path / "nothing")), baseline, x, "empty")


@pytest.mark.parametrize("plane", ["resident", "streamed"])
def test_checkpoint_every_gates_saves(tmp_path, case, plane):
    x, _ = case
    tcfg = _tcfg(_jcfg(plane == "streamed", "auto"))
    d = str(tmp_path / "every2")
    base = _fit(case, tcfg, checkpoint_dir=d, checkpoint_every=2)
    assert list_steps(d) == [2, 4] and latest_step(d) == 4
    _assert_models_equal(_fit(case, tcfg, resume_from=d), base, x, "every 2")
    d3 = str(tmp_path / "keep1")
    _fit(case, tcfg, checkpoint_dir=d3, checkpoint_keep=1)
    assert list_steps(d3) == [4]


def test_quarantined_block_resumes_bitwise(tmp_path, case):
    """Block 1 quarantined: its slot table stays in the carry as zeros
    (the structure does not depend on quarantine), the kill and resume
    gives the uninterrupted model, and both equal ``repro``'s."""
    x0, y = case
    x = x0.copy()
    x[200, 4] = np.nan                          # block 1 (rows 170-339)
    jcfg = _jcfg(True, "off")
    ref = jtrain(x, y, jcfg, SEED, bad_block_policy="quarantine")
    tcfg = _tcfg(jcfg)
    xq = (x, y)
    baseline = _fit(xq, tcfg, bad_block_policy="quarantine")
    assert baseline.quarantine.quarantined == [1]
    _assert_forest_is_reference(ref, baseline, "quarantine")
    d = str(tmp_path / "q")

    def boom(level, _):
        if level == 2:
            raise _Kill

    with pytest.raises(_Kill):
        _fit(xq, tcfg, bad_block_policy="quarantine", checkpoint_dir=d, on_level=boom)
    path = os.path.join(d, "step_00000002")
    entries = {e["key"]: e for e in tckpt._load_manifest(path)["leaves"]}
    assert [k for k in entries if k.startswith("slots/")] == ["slots/0", "slots/1", "slots/2", "slots/3"]
    assert not tckpt._load_leaf(path, entries["slots/1"]).any()
    assert tckpt._load_leaf(path, entries["slots/0"]).any()
    model = _fit(xq, tcfg, bad_block_policy="quarantine", resume_from=d)
    _assert_models_equal(model, baseline, x0, "quarantine resume")


def test_streamed_resume_keeps_level_stats(tmp_path, case):
    """``grow_forest_streamed(stats=)`` counts the levels the resumed call
    ran, and ``manager`` / ``resume_from`` / ``on_level`` work on the
    growth entry itself."""
    x, y = case
    from repro.core.binning import bin_dataset

    xb = np.asarray(bin_dataset(x, 16)[0])
    cfg = _tcfg(_jcfg(True, "off")).resolved(13)
    w, _ = _draws(cfg, *x.shape)
    want = tapi.grow_forest_streamed(xb, y, w, cfg, device="cpu")
    d = str(tmp_path / "s")

    def boom(level, forest):
        assert isinstance(forest, Forest)
        if level == 3:
            raise _Kill

    with pytest.raises(_Kill):
        tapi.grow_forest_streamed(xb, y, w, cfg, device="cpu", on_level=boom,
                                  manager=tckpt.CheckpointManager(d, save_interval=1))
    stats = {}
    got = tapi.grow_forest_streamed(xb, y, w, cfg, device="cpu", resume_from=d, stats=stats)
    assert len(stats["levels_s"]) == 1                   # only level 4 ran
    for n in Forest.FIELDS:
        assert torch.equal(getattr(got, n), getattr(want, n)), n
