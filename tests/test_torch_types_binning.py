"""Port parity: ForestConfig, binning and DSI counts of ``repro_torch``
against the JAX reference ``repro`` (CPU, numpy inputs from a seed)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binning as jbin
from repro.core import dsi as jdsi
from repro.core.types import ForestConfig as JConfig
from repro_torch.core import binning as tbin
from repro_torch.core import dsi as tdsi
from repro_torch.core.types import ForestConfig as TConfig

RNG = np.random.default_rng(5)


def test_forest_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TConfig)]
    assert jf == tf


@pytest.mark.parametrize("kw", [
    {},
    dict(n_trees=32, max_depth=8, n_bins=64, n_classes=4),
    dict(max_depth=5, max_frontier=12, n_bins=256, regression=True, sample_block=64),
])
def test_forest_config_roundtrip_and_derived(kw):
    j = JConfig(**kw)
    t = TConfig(**dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("frontier", "max_splits_per_level", "max_nodes"):
        assert getattr(t, prop) == getattr(j, prop)
    assert t.resolved_bin_fit() == j.resolved_bin_fit()
    assert t.resolved_hist_reuse() == j.resolved_hist_reuse()
    for F in (1, 7, 48, 128):
        assert dataclasses.asdict(t.resolved(F)) == dataclasses.asdict(j.resolved(F))


@pytest.mark.parametrize("bad", [dict(n_bins=257), dict(n_bins=1), dict(bin_fit="x"), dict(hist_reuse="x")])
def test_forest_config_validation_matches(bad):
    with pytest.raises(ValueError) as je:
        JConfig(**bad)
    with pytest.raises(ValueError) as te:
        TConfig(**bad)
    assert type(je.value).__name__ == type(te.value).__name__


def test_bin_count_error_at_257():
    with pytest.raises(tbin.BinCountError):
        tbin.validate_n_bins(257)
    with pytest.raises(tbin.BinCountError):
        tbin.fit_bins(RNG.random((10, 2)), 257)
    assert tbin.validate_n_bins(256) == 256


@pytest.mark.parametrize("n_bins", [4, 16, 64, 256])
def test_fit_and_apply_bins_bitwise(n_bins):
    x = RNG.normal(size=(500, 9)).astype(np.float32)
    x[:, 3] = 1.5                                   # constant feature
    x[:37, 4] = x[37:74, 4]                         # duplicated values
    ej = jbin.fit_bins(x, n_bins)
    et = tbin.fit_bins(x, n_bins)
    np.testing.assert_array_equal(ej, et)
    bj = np.asarray(jbin.apply_bins(jnp.asarray(x), jnp.asarray(ej)))
    bt = tbin.apply_bins(torch.from_numpy(x), torch.from_numpy(et)).numpy()
    np.testing.assert_array_equal(bj, bt)
    np.testing.assert_array_equal(bt, tbin.host_digitize(x, et))
    np.testing.assert_array_equal(tbin.host_digitize(x, et), jbin.host_digitize(x, ej))
    assert bt.dtype == np.uint8


def test_apply_bins_samples_on_edges():
    x = RNG.normal(size=(300, 5))                   # float64 source
    edges = tbin.fit_bins(x, 32)
    on_edge = edges.astype(np.float32)[:, ::3].T    # samples bit-equal (f32) to edges
    xs = np.concatenate([x.astype(np.float32), on_edge.astype(np.float32)])
    bj = np.asarray(jbin.apply_bins(jnp.asarray(xs), jnp.asarray(edges)))
    bt = tbin.apply_bins(torch.from_numpy(xs), torch.from_numpy(edges)).numpy()
    np.testing.assert_array_equal(bj, bt)
    np.testing.assert_array_equal(bt, tbin.host_digitize(xs, edges))


def test_bin_dataset_matches():
    x = RNG.normal(size=(400, 6)).astype(np.float32)
    bj, ej = jbin.bin_dataset(x, 16)
    bt, et = tbin.bin_dataset(x, 16, device="cpu")
    np.testing.assert_array_equal(ej, et)
    np.testing.assert_array_equal(bj, bt.numpy())


@pytest.mark.parametrize("k,n", [(1, 7), (5, 600)])
def test_dsi_counts_from_one_index_table(k, n):
    dsi = RNG.integers(0, n, (k, n)).astype(np.int32)
    cj = np.asarray(jdsi.dsi_counts(jnp.asarray(dsi), n))
    ct = tdsi.dsi_counts(torch.from_numpy(dsi), n).numpy()
    np.testing.assert_array_equal(cj, ct)
    np.testing.assert_array_equal(tdsi.oob_mask(torch.from_numpy(ct)).numpy(), cj == 0)


def test_bootstrap_counts_generator_is_reproducible():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = tdsi.bootstrap_counts(g1, 4, 100)
    b = tdsi.bootstrap_counts(g2, 4, 100)
    assert torch.equal(a, b)
    assert a.dtype == torch.float32 and float(a.sum()) == 400.0
