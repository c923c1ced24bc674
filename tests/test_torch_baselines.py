"""The paper's baselines in the port (``repro_torch.core.baselines``)
against ``repro.core.baselines``, on the CPU.

* ``fit_mlrf_like_from_draws`` given the reference's subsample, DSI
  counts and feature uniforms gives ``train_mlrf_like``'s forest and
  edges bitwise (budgets below, inside and past N).
* ``rf_config`` (``train_rf``'s config transform) through
  ``fit_prf_from_draws`` with the reference's draws gives
  ``train_rf``'s forest bitwise.
* ``data_volume_bytes`` equals the reference's over a grid of algorithms
  and sizes, and refuses the same unknown name.
* The ports of ``tests/test_forest.py``'s baseline cases. The high-dim
  case keeps its data and config but grows to depth 4, not 6: at depth 6
  the port's plain split scoring takes ~55 s on an 8-core CPU for the two
  models (its Cephes log over up to ``[16, 32, 800, 15, 3]`` candidates a
  level), ~13 s at depth 4, where PRF's margin over RF is 0.124 (0.135 at
  depth 6); ``tests/test_torch_cuda.py`` runs the full depth on the card.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import ForestConfig as JConfig
from repro.core import baselines as jb
from repro.core.dsi import bootstrap_counts
from repro_torch import ForestConfig, fit_prf_from_draws, train_prf
from repro_torch.core.baselines import (
    data_volume_bytes, fit_mlrf_like_from_draws, rf_config, train_mlrf_like, train_rf,
)
from repro_torch.core.types import Forest
from repro_torch.data.tabular import make_classification, train_test_split

JCFG = JConfig(n_trees=8, max_depth=5, n_bins=16, n_classes=4)


@pytest.fixture(autouse=True, scope="module")
def _two_cpu_threads():
    """The port's growth on the CPU is many small tensor ops: in a test run
    of several workers on one machine, more intra-op threads a worker only
    contend (this file took 10x its time alone in such a run at 8)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg):
    return ForestConfig(**dataclasses.asdict(jcfg))


def _assert_same_model(ref, model, x):
    for name in Forest.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref.forest, name)),
                                      getattr(model.forest, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(ref.bin_edges, model.bin_edges)
    np.testing.assert_array_equal(np.asarray(ref.predict(x)), model.predict(x))


@pytest.mark.parametrize("budget", [40, 500, 5000])
def test_mlrf_like_from_reference_draws_bitwise(class_data, budget):
    """The reference's draws (``repro/core/baselines.py``: the numpy
    subsample, then ``PRNGKey(seed)`` split into the DSI key and the
    feature key) through ``fit_mlrf_like_from_draws``."""
    xtr, ytr, xte, _ = class_data
    seed = 3
    ref = jb.train_mlrf_like(xtr, ytr, JCFG, seed=seed, sample_budget=budget)
    n, f = xtr.shape
    idx = np.random.default_rng(seed).choice(n, size=min(budget, n), replace=False)
    k_boot, k_feat = jax.random.split(jax.random.PRNGKey(seed))
    w = np.asarray(bootstrap_counts(k_boot, JCFG.n_trees, n))
    u = np.asarray(jax.random.uniform(k_feat, (JCFG.n_trees, f)))
    model = fit_mlrf_like_from_draws(xtr, ytr, _tcfg(JCFG), idx, w, u, device="cpu")
    _assert_same_model(ref, model, xte)
    assert model.forest.config.feature_mode == "random" and not model.forest.config.weighted_voting


def test_rf_config_from_reference_draws_bitwise(class_data):
    """``train_rf``'s transform fed the reference's draws (api.py's
    ``PRNGKey(seed)`` split into DSI and selection keys)."""
    xtr, ytr, xte, _ = class_data
    seed = 1
    ref = jb.train_rf(xtr, ytr, JCFG, seed=seed)
    n, f = xtr.shape
    k_boot, k_dim = jax.random.split(jax.random.PRNGKey(seed))
    w = np.asarray(bootstrap_counts(k_boot, JCFG.n_trees, n))
    u = np.asarray(jax.random.uniform(k_dim, (JCFG.n_trees, f)))
    cfg = rf_config(_tcfg(JCFG))
    assert (cfg.feature_mode, cfg.weighted_voting) == ("random", False)
    model = fit_prf_from_draws(xtr, ytr, cfg, w, u, device="cpu")
    _assert_same_model(ref, model, xte)
    np.testing.assert_array_equal(model.forest.tree_weight.numpy(), np.ones(JCFG.n_trees, np.float32))


def test_own_draws_are_train_prfs(class_data):
    """With the port's own draws: ``train_rf`` is ``train_prf`` under
    ``rf_config``, and ``train_mlrf_like`` takes ``train_prf``'s generator
    draws and the reference's numpy subsample."""
    import torch

    from repro_torch.core.dsi import bootstrap_counts as t_bootstrap

    xtr, ytr, xte, _ = class_data
    cfg = ForestConfig(n_trees=4, max_depth=4, n_bins=16, n_classes=4)
    rf = train_rf(xtr, ytr, cfg, 2, device="cpu")
    want = train_prf(xtr, ytr, rf_config(cfg), 2, device="cpu")
    for name in Forest.FIELDS:
        assert torch.equal(getattr(rf.forest, name), getattr(want.forest, name)), name
    ml = train_mlrf_like(xtr, ytr, cfg, 2, sample_budget=300, device="cpu")
    gen = torch.Generator().manual_seed(2)
    w = t_bootstrap(gen, cfg.n_trees, xtr.shape[0], torch.device("cpu"))
    u = torch.rand((cfg.n_trees, xtr.shape[1]), generator=gen)
    idx = np.random.default_rng(2).choice(xtr.shape[0], 300, replace=False)
    again = fit_mlrf_like_from_draws(xtr, ytr, cfg, idx, w, u, device="cpu")
    for name in Forest.FIELDS:
        assert torch.equal(getattr(ml.forest, name), getattr(again.forest, name)), name
    assert np.array_equal(ml.predict(xte), again.predict(xte))


@pytest.mark.parametrize("algorithm", ["rf", "spark-mlrf", "prf-paper", "prf-tpu"])
def test_data_volume_equals_reference(algorithm):
    for n, m, k in [(1, 1, 1), (1000, 48, 8), (100_000, 1000, 10), (100_000, 1000, 100),
                    (2 ** 20, 128, 32), (10 ** 8, 5000, 500)]:
        for vb in (4, 8):
            got = data_volume_bytes(algorithm, n, m, k, value_bytes=vb)
            assert got == jb.data_volume_bytes(algorithm, n, m, k, value_bytes=vb)
            assert type(got) is int


def test_data_volume_refuses_unknown_algorithm():
    for fn in (data_volume_bytes, jb.data_volume_bytes):
        with pytest.raises(ValueError):
            fn("spark-mllib", 10, 10, 10)


# ---------------------------------------------------------------------------
# tests/test_forest.py's baseline cases, on the port
# ---------------------------------------------------------------------------


def test_prf_beats_rf_in_high_dim_regime():
    """The paper's headline claim (Figs. 8-9): importance-guided dimension
    reduction beats random-subspace RF on high-dimensional noisy data
    (depth 4 here; see the module docstring)."""
    x, y = make_classification(n_samples=3000, n_features=800, n_classes=3, n_informative=8,
                               n_redundant=4, label_noise=0.1, class_sep=1.2, seed=7)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 0)
    cfg = ForestConfig(n_trees=16, max_depth=4, n_bins=16, n_classes=3)
    acc_prf = train_prf(xtr, ytr, cfg, seed=0, device="cpu").accuracy(xte, yte)
    acc_rf = train_rf(xtr, ytr, cfg, seed=0, device="cpu").accuracy(xte, yte)
    assert acc_prf > acc_rf + 0.1, (acc_prf, acc_rf)


def test_mlrf_sampling_degrades_with_small_budget(class_data):
    xtr, ytr, xte, yte = class_data
    cfg = ForestConfig(n_trees=16, max_depth=6, n_bins=32, n_classes=4)
    acc_big = train_mlrf_like(xtr, ytr, cfg, seed=0, sample_budget=2000, device="cpu").accuracy(xte, yte)
    acc_tiny = train_mlrf_like(xtr, ytr, cfg, seed=0, sample_budget=40, device="cpu").accuracy(xte, yte)
    assert acc_big >= acc_tiny - 0.02


def test_data_volume_model_flat_in_k():
    """Fig. 14: PRF volume ~flat in ensemble scale, RF linear."""
    N, M = 100_000, 1000
    v_rf_10 = data_volume_bytes("rf", N, M, 10)
    v_rf_100 = data_volume_bytes("rf", N, M, 100)
    assert v_rf_100 == 10 * v_rf_10
    v_paper_10 = data_volume_bytes("prf-paper", N, M, 10)
    v_paper_100 = data_volume_bytes("prf-paper", N, M, 100)
    assert v_paper_100 == v_paper_10
    v_prf_10 = data_volume_bytes("prf-tpu", N, M, 10)
    v_prf_100 = data_volume_bytes("prf-tpu", N, M, 100)
    assert v_prf_100 < 2 * v_prf_10
    assert v_prf_100 < v_rf_100 / 100
