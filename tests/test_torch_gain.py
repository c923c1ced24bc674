"""Port parity: ``repro_torch.core.gain`` against ``repro.core.gain``.

Gains match at rtol 1e-6 with the same -inf pattern. Split gain ratios
are also held *bitwise* to the reference as training evaluates them
(inside ``jax.jit``, where the CPU compiler fuses one multiply-add of
Eq. 3): the beam ranking of splits, and so every pool id, depends on it.
Zero-count nodes and all-zero children (the ``maximum(x, 1e-38)``
subnormal guards) are pinned explicitly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gain as jg
from repro_torch.core import gain as tg

RNG = np.random.default_rng(17)


def _hist(shape, zero_rows=True):
    h = RNG.integers(0, 5, shape).astype(np.float32)
    h *= (RNG.random(shape[:-1] + (1,)) < 0.6)
    if zero_rows:
        h[0, 0] = 0.0                       # a slot with no samples at all
        h[0, 1, :, 1:] = 0.0                # a slot whose samples sit in bin 0 only
    return h


def _close(a, b, atol=0.0):
    """Same -inf/NaN pattern, finite values at rtol 1e-6. ``atol`` only where
    the two sides round differently and a cancellation magnifies it."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_array_equal(a[~np.isfinite(a)], b[~np.isfinite(b)])
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=1e-6, atol=atol)


def test_xla_log_is_bitwise():
    p = np.concatenate([
        RNG.random(200_000).astype(np.float32),
        (RNG.random(20_000) * 1e-5).astype(np.float32),
        np.array([1.0, 0.5, 1e-38, 1.17549435e-38, 2.0 ** -20], np.float32),
    ])
    want = np.asarray(jax.jit(jnp.log)(np.maximum(p, np.float32(1.17549435e-38))))
    np.testing.assert_array_equal(tg._log(torch.from_numpy(p)).numpy(), want)


def test_fma_single_rounding():
    a = RNG.random(50_000).astype(np.float32)
    b = RNG.random(50_000).astype(np.float32)
    c = (RNG.random(50_000) - 0.5).astype(np.float32)
    exact = a.astype(np.float64) * b + c             # exact in float64 here
    got = tg._fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    # one rounding of the exact value: |got - exact| <= half an ulp of got
    ulp = np.spacing(np.abs(got)).astype(np.float64)
    assert np.all(np.abs(got.astype(np.float64) - exact) <= ulp / 2)


def test_xlogx_and_entropy():
    p = np.concatenate([RNG.random(1000), [0.0, 1.0]]).astype(np.float32)
    _close(jg._xlogx(jnp.asarray(p)), tg._xlogx(torch.from_numpy(p)))
    counts = RNG.integers(0, 5, (3, 5, 4)).astype(np.float32)
    counts[0, 0] = 0.0                               # zero-count row -> entropy 0
    _close(jg.entropy_from_counts(jnp.asarray(counts)), tg.entropy_from_counts(torch.from_numpy(counts)))


@pytest.mark.parametrize("C", [2, 4])
def test_split_gain_ratios_match(C):
    h = _hist((2, 4, 6, 8, C))
    cum = np.cumsum(h, axis=-2)
    tot = cum[..., -1, :]
    want_eager = jg.split_gain_ratios_from_cumsum(jnp.asarray(cum), jnp.asarray(tot))
    want_jit = jax.jit(jg.split_gain_ratios_from_cumsum)(cum, tot)
    got = tg.split_gain_ratios_from_cumsum(torch.from_numpy(cum), torch.from_numpy(tot)).numpy()
    _close(want_jit, got)
    np.testing.assert_array_equal(np.asarray(want_jit), got)
    _close(want_eager, got, atol=1e-6)
    assert np.all(np.isneginf(got[0, 0]))           # zero-count node: every split invalid
    assert np.all(np.isneginf(got[0, 1]))           # all samples in bin 0: no valid split
    _close(jax.jit(jg.split_gain_ratios)(h), tg.split_gain_ratios(torch.from_numpy(h)))


def test_variance_gains_match():
    y = RNG.normal(size=(2, 3, 5, 8)).astype(np.float32)
    cnt = RNG.integers(0, 3, y.shape).astype(np.float32)
    cnt[0, 0] = 0.0
    h = np.stack([cnt, cnt * y, cnt * y * y], -1)
    cum = np.cumsum(h, axis=-2)
    tot = cum[..., -1, :]
    want = jg.variance_gains_from_cumsum(jnp.asarray(cum), jnp.asarray(tot))
    got = tg.variance_gains_from_cumsum(torch.from_numpy(cum), torch.from_numpy(tot))
    np.testing.assert_array_equal(np.isfinite(np.asarray(want)), np.isfinite(got.numpy()))
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(np.asarray(want)[fin], got.numpy()[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_best_splits_and_level_scores(masked):
    h = _hist((3, 4, 7, 8, 3))
    mask = RNG.random((3, 7)) > 0.4 if masked else None
    want = jax.jit(lambda hh, m: jg.best_splits(hh, m))(h, mask)
    got = tg.best_splits(torch.from_numpy(h), None if mask is None else torch.from_numpy(mask))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    sj, nj = jg.level_scores(jnp.asarray(h), None if mask is None else jnp.asarray(mask), backend="xla")
    st, nt = tg.level_scores(torch.from_numpy(h), None if mask is None else torch.from_numpy(mask), backend="xla")
    np.testing.assert_array_equal(np.asarray(sj.feature), st.feature.numpy())
    np.testing.assert_array_equal(np.asarray(sj.threshold), st.threshold.numpy())
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
    # slot 0 has no samples: feature 0, threshold 0, zero counts (the oracle's all-invalid rule)
    assert int(st.feature[0, 0]) == 0 and int(st.threshold[0, 0]) == 0
    assert float(nt[0, 0]) == 0.0


def test_level_scores_regression():
    y = RNG.normal(size=(2, 3, 5, 8)).astype(np.float32)
    cnt = RNG.integers(0, 3, y.shape).astype(np.float32)
    h = np.stack([cnt, cnt * y, cnt * y * y], -1)
    sj, nj = jg.level_scores(jnp.asarray(h), None, regression=True, backend="xla")
    st, nt = tg.level_scores(torch.from_numpy(h), None, regression=True, backend="xla")
    np.testing.assert_array_equal(np.asarray(sj.feature), st.feature.numpy())
    np.testing.assert_array_equal(np.asarray(sj.threshold), st.threshold.numpy())
    np.testing.assert_allclose(np.asarray(nj), nt.numpy(), rtol=1e-6)


def test_multiway_gain_ratio_and_importance():
    h = _hist((4, 9, 16, 3), zero_rows=False)
    h[..., 0, :] += 1.0                             # every feature has samples
    h[0, 1, 1:] = 0.0                                # a feature whose samples share one bin
    h[0, 1, 0] = (3.0, 1.0, 2.0)
    # The sums over the bin axis run in another order than the reference's
    # vectorised row reduction; small ratios come from a cancellation, so
    # an absolute floor of 1e-7 on top of rtol 1e-6.
    _close(jg.multiway_gain_ratio(jnp.asarray(h)), tg.multiway_gain_ratio(torch.from_numpy(h)), atol=1e-7)
    gr = RNG.normal(size=(4, 9)).astype(np.float32)
    _close(jg.variable_importance(jnp.asarray(gr)), tg.variable_importance(torch.from_numpy(gr)))


def test_resolve_split_backend():
    cpu = torch.device("cpu")
    assert tg.resolve_split_backend("auto", cpu) == "xla"
    assert tg.resolve_split_backend("auto", torch.device("cuda")) == "pallas"
    assert tg.resolve_split_backend("xla", cpu) == "xla"
    with pytest.raises(ValueError):
        tg.resolve_split_backend("pallas", cpu)
    with pytest.raises(ValueError):
        tg.resolve_split_backend("triton", cpu)


def test_zero_mass_rows_match_reference():
    """A feature with no samples at all, and a tree whose gain ratios are
    all <= 0, divide 0 by a zero-mass guard: the reference (whose CPU
    backend flushes its subnormal 1e-38 guard to 0) returns NaN there,
    and so does the port. Equal NaN positions, equal values elsewhere."""
    h = _hist((2, 3, 8, 3), zero_rows=False)
    h[0, 0] = 0.0
    want = np.asarray(jg.multiway_gain_ratio(jnp.asarray(h)))
    got = tg.multiway_gain_ratio(torch.from_numpy(h)).numpy()
    assert np.isnan(want[0, 0])
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    _close(want, got, atol=1e-7)
    gr = RNG.normal(size=(3, 5)).astype(np.float32)
    gr[1] = -1.0
    vj = np.asarray(jg.variable_importance(jnp.asarray(gr)))
    vt = tg.variable_importance(torch.from_numpy(gr)).numpy()
    assert np.isnan(vj[1]).all()
    np.testing.assert_array_equal(np.isnan(vj), np.isnan(vt))
    _close(vj, vt)
