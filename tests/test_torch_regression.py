"""End-to-end regression in the port, against ``repro``, on the CPU.

* Given ``repro``'s draws, ``fit_prf_from_draws(regression=True)``
  matches ``repro.core.api.train_prf``, resident and streamed, in each
  feature mode: the tree structure (``feature``, ``threshold``,
  ``left_child``) equal, node values and channel sums within float
  rounding, tree weights (OOB R^2) within 1e-6, predictions within 1e-5
  of the prediction scale.
* The bin-axis cumsum of the plain split scoring is the reference's
  (float32, left to right), so variance gains and winners equal
  ``repro``'s bitwise given the same histogram.
* ``oob_r2`` within rtol 1e-6 of ``repro``'s (``_r2_mean_stats`` is one
  float32 sum whose order differs); ``oob_r2_streamed`` equals
  ``oob_r2`` and ``predict_regression_streamed`` equals
  ``predict_regression`` bitwise; degenerate OOB sets get 0.5.
* Kill and resume of regression growth is bitwise on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ForestConfig as JConfig
from repro.core import gain as jgain
from repro.core import train_prf as jtrain
from repro.core import voting as jvoting
from repro.core.dsi import bootstrap_counts
from repro.data.tabular import make_regression
from repro_torch import fit_prf_from_draws, train_prf
from repro_torch.core import gain as tgain
from repro_torch.core import voting as tvoting
from repro_torch.core.types import Forest, ForestConfig as TConfig

SEED = 0
BLOCK = 170
STRUCTURE = ("feature", "threshold", "left_child")


@pytest.fixture(scope="module")
def case():
    x, y = make_regression(n_samples=600, n_features=13, seed=3)
    return x, y


def _jcfg(feature_mode="all", streamed=False, **over):
    kw = dict(n_trees=6, max_depth=4, n_bins=16, regression=True, feature_mode=feature_mode,
              sample_block=BLOCK if streamed else 0)
    return JConfig(**dict(kw, **over))


def _tcfg(jcfg, **over):
    return TConfig(**dict(dataclasses.asdict(jcfg), **over))


def _draws(jcfg, n, f):
    k_boot, k_dim = jax.random.split(jax.random.PRNGKey(SEED))
    return (np.asarray(bootstrap_counts(k_boot, jcfg.n_trees, n)),
            np.asarray(jax.random.uniform(k_dim, (jcfg.n_trees, f))))


def _fit(case, tcfg, **kw):
    x, y = case
    w, u = _draws(tcfg, *x.shape)
    return fit_prf_from_draws(x, y, tcfg, w, u, device="cpu", **kw)


def _assert_close_to_reference(ref, model, x):
    for n in STRUCTURE:
        np.testing.assert_array_equal(np.asarray(getattr(ref.forest, n)),
                                      getattr(model.forest, n).numpy(), err_msg=n)
    np.testing.assert_allclose(np.asarray(ref.forest.value), model.forest.value.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.forest.class_counts), model.forest.class_counts.numpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ref.forest.tree_weight), model.forest.tree_weight.numpy(),
                               rtol=0, atol=1e-6)
    want = np.asarray(ref.predict(x))
    np.testing.assert_allclose(model.predict(x), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("feature_mode", ["importance", "random", "all"])
def test_fit_from_draws_matches_reference(case, feature_mode, streamed):
    x, y = case
    jcfg = _jcfg(feature_mode, streamed)
    ref = jtrain(x, y, jcfg, SEED)
    model = _fit(case, _tcfg(jcfg))
    assert model.forest.config.regression and model.quarantine.clean
    np.testing.assert_array_equal(ref.bin_edges, model.bin_edges)
    _assert_close_to_reference(ref, model, x)
    assert 0.0 <= float(model.forest.tree_weight.min()) and float(model.forest.tree_weight.max()) <= 1.0


def test_bin_cumsum_is_the_reference_cumsum():
    rng = np.random.default_rng(1)
    h = (rng.normal(size=(3, 5, 7, 16, 3)) * 50).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-2))(h))
    got = tgain._bin_cumsum(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(torch.cumsum(torch.from_numpy(h), dim=-2).numpy(), want)


def test_regression_level_scores_bitwise():
    """Variance gains and winners from the same float histogram equal the
    reference's bitwise."""
    rng = np.random.default_rng(2)
    k, S, F, B = 4, 8, 9, 16
    n = rng.integers(0, 5, size=(k, S, F, B)).astype(np.float32)
    yv = rng.normal(size=(k, S, F, B)).astype(np.float32)
    hist = np.stack([n, n * yv, n * yv * yv], -1).astype(np.float32)
    mask = rng.random((k, F)) > 0.3
    js, jn = jgain.level_scores(jnp.asarray(hist), jnp.asarray(mask), regression=True, backend="xla")
    ts, tn = tgain.level_scores(torch.from_numpy(hist), torch.from_numpy(mask), regression=True)
    for name, a, b in zip(js._fields, js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())


@pytest.fixture(scope="module")
def grown(case):
    """A regression forest given the reference's draws, the binned data
    and the reference's forest on the same inputs."""
    x, y = case
    jcfg = _jcfg("random")
    ref = jtrain(x, y, jcfg, SEED)
    model = _fit(case, _tcfg(jcfg))
    xb = model._binned(x)
    w, _ = _draws(jcfg, *x.shape)
    return ref, model, xb, y, w


def test_oob_r2_matches_reference_and_streamed_bitwise(grown):
    ref, model, xb, y, w = grown
    f = model.forest
    got = tvoting.oob_r2(f, xb, torch.tensor(y), torch.tensor(w))
    want = np.asarray(jvoting.oob_r2(ref.forest, jnp.asarray(xb.numpy()), jnp.asarray(y), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    for block, prefetch in ((BLOCK, 0), (BLOCK, 2), (97, 2), (600, 0)):
        s = tvoting.oob_r2_streamed(f, xb.numpy(), y, w, sample_block=block, prefetch=prefetch)
        assert torch.equal(s, got), (block, prefetch)
    blocks = [xb.numpy()[i:i + 250] for i in range(0, 600, 250)]
    assert torch.equal(tvoting.oob_r2_streamed(f, blocks, y, w), got)


def test_oob_r2_neutral_prior():
    """An empty OOB set, and one whose targets have no variance, get the
    neutral 0.5, as in the reference."""
    rng = np.random.default_rng(3)
    cfg = TConfig(n_trees=3, max_depth=2, n_bins=8, regression=True, feature_mode="all")
    xb = rng.integers(0, 8, size=(40, 3)).astype(np.uint8)
    y = rng.normal(size=40).astype(np.float32)
    w = rng.integers(0, 3, size=(3, 40)).astype(np.float32)
    w[0] = 1.0                                   # tree 0: everything in bag
    w[1, :] = 1.0
    w[1, :5] = 0.0
    y[:5] = 2.5                                  # tree 1: its OOB targets are constant
    model = fit_prf_from_draws(xb.astype(np.float32), y, dataclasses.replace(cfg, weighted_voting=False),
                               w, np.zeros((3, 3), np.float32), device="cpu")
    xbt = model._binned(xb.astype(np.float32))
    got = tvoting.oob_r2(model.forest, xbt, torch.from_numpy(y), torch.from_numpy(w))
    assert got[0] == 0.5 and got[1] == 0.5 and 0.0 <= float(got[2]) <= 1.0
    assert torch.equal(tvoting.oob_r2_streamed(model.forest, xbt.numpy(), y, w, sample_block=16), got)


def test_predict_regression_streamed_and_scores(grown):
    ref, model, xb, y, w = grown
    f = model.forest
    resident = tvoting.predict_regression(f, xb)
    for block, prefetch in ((BLOCK, 0), (64, 2), (600, 2)):
        assert torch.equal(tvoting.predict_regression_streamed(
            f, xb.numpy(), sample_block=block, prefetch=prefetch), resident), block
    num = tvoting.predict_regression_scores(f, xb)
    assert torch.equal(num / torch.clamp_min(f.tree_weight.sum(), 1e-38), resident)
    jnum = np.asarray(jvoting.predict_regression_scores(ref.forest, jnp.asarray(xb.numpy())))
    np.testing.assert_allclose(num.numpy(), jnum, rtol=1e-5, atol=1e-5 * np.abs(jnum).max())
    # a batch's rows predict as they do alone (trees added in order)
    for i in (0, 17, 599):
        assert torch.equal(tvoting.predict_regression(f, xb[i:i + 1]), resident[i:i + 1])
    with pytest.raises(ValueError):
        model.predict_scores(xb.numpy().astype(np.float32))


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_regression_kill_and_resume_bitwise(tmp_path, case, streamed):
    """Regression growth resumes bitwise on the CPU (the plain path sums in
    a fixed order), at every level boundary."""
    x, _ = case
    tcfg = _tcfg(_jcfg("all", streamed))
    baseline = _fit(case, tcfg)

    class Kill(Exception):
        pass

    for kill_at in (1, 2, 3):
        d = str(tmp_path / f"k{kill_at}")

        def boom(level, _):
            if level == kill_at:
                raise Kill

        with pytest.raises(Kill):
            _fit(case, tcfg, checkpoint_dir=d, on_level=boom)
        model = _fit(case, tcfg, resume_from=d)
        for n in Forest.FIELDS:
            assert torch.equal(getattr(model.forest, n), getattr(baseline.forest, n)), (kill_at, n)
        np.testing.assert_array_equal(model.predict(x), baseline.predict(x))


def test_train_prf_regression_own_draws(case):
    """``train_prf`` with its own draws trains regression end to end, the
    same model twice, and fits the target better than its mean."""
    x, y = case
    cfg = TConfig(n_trees=8, max_depth=5, n_bins=16, regression=True)
    a = train_prf(x, y, cfg, 1, device="cpu")
    b = train_prf(x, y, cfg, 1, device="cpu")
    for n in Forest.FIELDS:
        assert torch.equal(getattr(a.forest, n), getattr(b.forest, n)), n
    pred = a.predict(x)
    r2 = 1.0 - np.mean((pred - y) ** 2) / np.var(y)
    assert pred.dtype == np.float32 and r2 > 0.5
