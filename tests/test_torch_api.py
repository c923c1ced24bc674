"""The port's slice as a whole: ``repro_torch.train_prf`` / ``PRFModel``
against ``repro.core.api.train_prf`` on ``class_data``.

* Reference draws: the reference's DSI counts and feature-selection
  uniforms fed to ``fit_prf_from_draws`` give every Forest array,
  ``tree_weight`` and predicted label bitwise.
* Own draws (``torch.Generator``): accuracy within 0.03.
* Carried weights, the device rule, the checkpoint and regression knobs
  (which run now; multi-process training still raises), import hygiene
  (no jax, repro or msgpack).
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import ForestConfig as JConfig
from repro.core import train_prf as jtrain
from repro.core.dsi import bootstrap_counts
from repro_torch import PRFModel, fit_prf_from_draws, train_prf
from repro_torch.convert import forest_from_numpy, forest_to_numpy, model_from_numpy
from repro_torch.core.types import Forest, ForestConfig as TConfig
from repro_torch.data.pipeline import DataIntegrityError

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 3
JCFG = JConfig(n_trees=8, max_depth=6, n_bins=32, n_classes=4)


def _tcfg(jcfg):
    return TConfig(**dict(dataclasses.asdict(jcfg), hist_reuse="off"))


def _reference_draws(cfg, n, f, seed):
    """The draws of repro.core.api.train_prf (api.py:252-255, dimred.py:80)."""
    k_boot, k_dim = jax.random.split(jax.random.PRNGKey(seed))
    w = np.asarray(bootstrap_counts(k_boot, cfg.n_trees, n))
    u = np.asarray(jax.random.uniform(k_dim, (cfg.n_trees, f)))
    return w, u


@pytest.fixture(scope="module")
def reference(class_data):
    xtr, ytr, xte, yte = class_data
    return jtrain(xtr, ytr, JCFG, SEED)


def test_reference_draws_bitwise(class_data, reference):
    xtr, ytr, xte, yte = class_data
    w, u = _reference_draws(JCFG, *xtr.shape, SEED)
    model = fit_prf_from_draws(xtr, ytr, _tcfg(JCFG), w, u, device="cpu")
    for name in Forest.FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(reference.forest, name)), getattr(model.forest, name).numpy(),
            err_msg=name,
        )
    np.testing.assert_array_equal(np.asarray(reference.predict(xte)), model.predict(xte))
    np.testing.assert_array_equal(reference.bin_edges, model.bin_edges)
    np.testing.assert_allclose(np.asarray(reference.predict_scores(xte)), model.predict_scores(xte),
                               rtol=1e-6, atol=1e-6)


def test_random_feature_mode_reference_draws_bitwise(class_data):
    xtr, ytr, xte, yte = class_data
    jcfg = JConfig(n_trees=5, max_depth=5, n_bins=16, n_classes=4, feature_mode="random",
                   hist_reuse="off", tree_chunk=2)
    ref = jtrain(xtr, ytr, jcfg, 1)
    w, u = _reference_draws(jcfg, *xtr.shape, 1)
    model = fit_prf_from_draws(xtr, ytr, _tcfg(jcfg), w, u, device="cpu")
    for name in Forest.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref.forest, name)),
                                      getattr(model.forest, name).numpy(), err_msg=name)


def test_sanitize_policy_matches_reference(class_data):
    xtr, ytr, xte, yte = class_data
    x = xtr.copy()
    x[5, 3] = np.nan
    y = ytr.copy()
    y[9] = 7                                             # out-of-range label
    jcfg = JConfig(n_trees=4, max_depth=4, n_bins=16, n_classes=4, hist_reuse="off")
    ref = jtrain(x, y, jcfg, 2, bad_block_policy="sanitize")
    w, u = _reference_draws(jcfg, *x.shape, 2)
    model = fit_prf_from_draws(x, y, _tcfg(jcfg), w, u, device="cpu", bad_block_policy="sanitize")
    for name in Forest.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref.forest, name)),
                                      getattr(model.forest, name).numpy(), err_msg=name)
    assert model.quarantine.sanitized_cells == 1 and model.quarantine.sanitized_labels == 1
    with pytest.raises(DataIntegrityError):
        train_prf(x, y, _tcfg(jcfg), 0, device="cpu")


def test_own_draws_accuracy_close(class_data, reference):
    xtr, ytr, xte, yte = class_data
    model = train_prf(xtr, ytr, _tcfg(JCFG), SEED, device="cpu")
    assert abs(model.accuracy(xte, yte) - reference.accuracy(xte, yte)) <= 0.03
    again = train_prf(xtr, ytr, _tcfg(JCFG), SEED, device="cpu")
    assert torch.equal(model.forest.feature, again.forest.feature)


def test_carried_weights_predict_identically(class_data, reference):
    xtr, ytr, xte, yte = class_data
    arrays = {n: np.asarray(getattr(reference.forest, n)) for n in Forest.FIELDS}
    cfg = TConfig(**dataclasses.asdict(reference.forest.config))
    model = model_from_numpy(arrays, reference.bin_edges, cfg, device="cpu")
    assert isinstance(model, PRFModel)
    np.testing.assert_array_equal(np.asarray(reference.predict(xte)), model.predict(xte))
    back = forest_to_numpy(forest_from_numpy(arrays, cfg, "cpu"))
    for n in Forest.FIELDS:
        np.testing.assert_array_equal(back[n], arrays[n])
    np.testing.assert_array_equal(model.with_predict_backend("xla").predict(xte), model.predict(xte))
    with pytest.raises(ValueError):
        model.with_predict_backend("pallas").predict(xte)   # the kernel needs the card


def test_checkpoint_knobs_and_bad_draw_shapes_raise(class_data, reference, tmp_path):
    """The checkpoint knobs run (given the reference's draws, the model with
    checkpoints and the one resumed from them are the reference's); bad
    draw shapes still raise."""
    xtr, ytr, _, _ = class_data
    w, u = _reference_draws(JCFG, *xtr.shape, SEED)
    d = str(tmp_path / "ckpt")
    for kw in (dict(checkpoint_dir=d), dict(resume_from=d)):
        model = fit_prf_from_draws(xtr, ytr, _tcfg(JCFG), w, u, device="cpu", **kw)
        for name in Forest.FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(reference.forest, name)),
                                          getattr(model.forest, name).numpy(), err_msg=f"{name} {kw}")
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005", "step_00000006"]
    w, u = _reference_draws(JCFG, *xtr.shape, SEED)
    with pytest.raises(ValueError, match="weights"):
        fit_prf_from_draws(xtr, ytr, _tcfg(JCFG), w[:, :-1], u, device="cpu")
    with pytest.raises(ValueError, match="weights"):
        fit_prf_from_draws(xtr, ytr, _tcfg(JCFG), w, u[:-1], device="cpu")


def test_device_rule(class_data, monkeypatch):
    xtr, ytr, _, _ = class_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_prf(xtr, ytr, _tcfg(JCFG), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_prf(xtr, ytr, _tcfg(JCFG), 0, device="cuda")


def test_reuse_on_matches_reference_labels(class_data, reference):
    """``hist_reuse="on"`` (the reference's ``auto`` here) through the
    port's trainer, given the reference's draws: its labels and forest."""
    xtr, ytr, xte, _ = class_data
    w, u = _reference_draws(JCFG, *xtr.shape, SEED)
    cfg = TConfig(**dict(dataclasses.asdict(JCFG), hist_reuse="on"))
    model = fit_prf_from_draws(xtr, ytr, cfg, w, u, device="cpu")
    np.testing.assert_array_equal(np.asarray(reference.predict(xte)), model.predict(xte))
    for name in Forest.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(reference.forest, name)),
                                      getattr(model.forest, name).numpy(), err_msg=name)


@pytest.mark.parametrize("kw", [dict(regression=True, hist_reuse="off"),
                                dict(hist_reuse="off", checkpoint_dir="ckpt"),
                                dict(world_size=2)])
def test_unported_paths_raise(class_data, kw, tmp_path, monkeypatch):
    """Regression and checkpointing, which raised before they were ported,
    now train; multi-process training still raises, naming ROADMAP."""
    xtr, ytr, xte, _ = class_data
    kw = dict(kw)
    call = {"checkpoint_dir": str(tmp_path / kw.pop("checkpoint_dir"))} if "checkpoint_dir" in kw else {}
    if kw.pop("world_size", 1) > 1:
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 10"):
            train_prf(xtr, ytr, TConfig(n_trees=2, max_depth=2, n_bins=8, n_classes=4), 0, device="cpu")
        return
    cfg = TConfig(n_trees=2, max_depth=2, n_bins=8, n_classes=4, **kw)
    model = train_prf(xtr, ytr.astype(np.float32) if cfg.regression else ytr, cfg, 0, device="cpu", **call)
    pred = model.predict(xte)
    assert pred.shape == (xte.shape[0],) and np.isfinite(pred).all()
    assert pred.dtype == (np.float32 if cfg.regression else np.int64)
    if call:
        assert sorted(os.listdir(call["checkpoint_dir"])) == ["step_00000001", "step_00000002"]


def test_import_hygiene_subprocess():
    code = (
        "import sys, repro_torch, repro_torch.convert, repro_torch.core.engine, "
        "repro_torch.kernels.split_scan.ops, repro_torch.kernels.tree_traverse.ops, "
        "repro_torch.kernels.gain_ratio.ops, repro_torch.kernels._build, "
        "repro_torch.checkpoint, repro_torch.launch.fault, repro_torch.launch.mesh, "
        "repro_torch.core.distributed\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.') or m == 'msgpack' or m.startswith('msgpack.')]\n"
        "assert not bad, bad\n"
        # a rank that run_world spawns (this test process has loaded jax and repro)
        "from repro_torch.launch.mesh import run_world\n"
        "out = run_world('torch_mesh_ranks:loaded_modules', 2, timeout_s=120)\n"
        "assert out == [[], []], out\n"
    )
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT, timeout=180)


def test_import_hygiene_text_scan():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|from repro |import repro\s*$"
                     r"|import msgpack|from msgpack)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_voting_functions_match_reference():
    from repro.core import voting as jv
    from repro_torch.core import voting as tv

    rng = np.random.default_rng(9)
    probs = rng.dirichlet(np.ones(4), size=(5, 40)).astype(np.float32)
    w = rng.random(5).astype(np.float32)
    for soft in (False, True):
        np.testing.assert_allclose(
            np.asarray(jv.weighted_vote(probs, w, soft=soft)),
            tv.weighted_vote(torch.from_numpy(probs), torch.from_numpy(w), soft=soft).numpy(),
            rtol=1e-6, atol=1e-6)
    vals = rng.normal(size=(5, 40)).astype(np.float32)
    for faithful in (False, True):
        np.testing.assert_allclose(
            np.asarray(jv.weighted_regression(vals, w, faithful_eq9=faithful)),
            tv.weighted_regression(torch.from_numpy(vals), torch.from_numpy(w),
                                   faithful_eq9=faithful).numpy(), rtol=1e-6, atol=1e-6)


def test_carried_regression_model_predicts_close():
    from repro.data.tabular import make_regression

    x, y = make_regression(n_samples=500, n_features=6, seed=2)
    jcfg = JConfig(n_trees=4, max_depth=4, n_bins=16, regression=True, hist_reuse="off")
    ref = jtrain(x, y, jcfg, 0)
    arrays = {n: np.asarray(getattr(ref.forest, n)) for n in Forest.FIELDS}
    model = model_from_numpy(arrays, ref.bin_edges, TConfig(**dataclasses.asdict(ref.forest.config)), "cpu")
    np.testing.assert_allclose(np.asarray(ref.predict(x)), model.predict(x), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        model.predict_scores(x)
