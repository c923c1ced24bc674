"""Port parity: the plain T_GR histogram (``repro_torch`` segment_sum
backend, the plain version of ``csrc/gain_ratio_hist.cu``) against the
reference's ``segment_sum`` backend and its Pallas kernel in interpret
mode. Integer DSI weights make every entry an exact float, so the three
agree bitwise; regression channels agree to rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.histograms import level_histograms as jlevel
from repro.kernels.gain_ratio.kernel import multi_tree_hist_pallas
from repro_torch.core import histograms as th
from repro_torch.kernels.gain_ratio.ops import multi_tree_hist
from repro_torch.kernels.gain_ratio.ref import multi_tree_hist_ref

RNG = np.random.default_rng(23)


def _case(tc, N, F, S, B, C, *, regression=False, parked=0.1):
    xb = RNG.integers(0, B, (N, F)).astype(np.uint8)
    if regression:
        y = RNG.normal(size=N).astype(np.float32)
        base = np.stack([np.ones_like(y), y, y * y], -1)
    else:
        base = np.eye(C, dtype=np.float32)[RNG.integers(0, C, N)]
    w = RNG.integers(0, 4, (tc, N)).astype(np.float32)      # DSI multiplicities
    slot = RNG.integers(0, S, (tc, N)).astype(np.int32)
    slot[RNG.random((tc, N)) < parked] = -1                   # parked samples
    return xb, base, w, slot


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("tc,N,F,S,B,C", [(2, 300, 13, 4, 8, 3), (3, 517, 7, 5, 16, 2), (1, 61, 9, 1, 4, 4)])
@pytest.mark.parametrize("packed", [False, True])
def test_plain_hist_bitwise_vs_reference(tc, N, F, S, B, C, packed):
    xb, base, w, slot = _case(tc, N, F, S, B, C)
    got = th.level_histograms(*_t(xb, base, w, slot), n_slots=S, n_bins=B, packed=packed).numpy()
    seg = np.asarray(jlevel(jnp.asarray(xb), jnp.asarray(base), jnp.asarray(w), jnp.asarray(slot),
                            n_slots=S, n_bins=B, packed=packed, backend="segment_sum"))
    pal = np.asarray(multi_tree_hist_pallas(jnp.asarray(xb), jnp.asarray(base), jnp.asarray(w),
                                            jnp.asarray(slot), n_slots=S, n_bins=B, packed=packed,
                                            interpret=True))
    assert got.shape == (tc, S, F, B, C)
    np.testing.assert_array_equal(got, seg)
    np.testing.assert_array_equal(got, pal)


def test_all_parked_contributes_nothing():
    xb, base, w, slot = _case(2, 100, 7, 3, 8, 2)
    slot[:] = -1
    got = th.level_histograms(*_t(xb, base, w, slot), n_slots=3, n_bins=8)
    assert float(got.abs().max()) == 0.0


def test_regression_channels_close():
    xb, base, w, slot = _case(2, 400, 6, 4, 8, 3, regression=True)
    got = th.level_histograms(*_t(xb, base, w, slot), n_slots=4, n_bins=8).numpy()
    want = np.asarray(jlevel(jnp.asarray(xb), jnp.asarray(base), jnp.asarray(w), jnp.asarray(slot),
                             n_slots=4, n_bins=8, backend="segment_sum"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_feature_slab_equals_slice_of_full(packed):
    xb, base, w, slot = _case(2, 333, 11, 4, 8, 3)
    xt, bt, wt, st = _t(xb, base, w, slot)
    full = th.level_histograms(xt, bt, wt, st, n_slots=4, n_bins=8, packed=packed)
    for f0, f1 in [(0, 4), (4, 9), (9, 11)]:
        slab = th.level_histograms(xt[:, f0:f1], bt, wt, st, n_slots=4, n_bins=8, packed=packed)
        assert torch.equal(slab, full[:, :, f0:f1])


def test_wrapper_on_cpu_is_the_plain_version_and_checks_inputs():
    from repro_torch.kernels.gain_ratio import ops

    xb, base, w, slot = _case(2, 50, 5, 2, 4, 2)
    before = ops.launches
    a = multi_tree_hist(*_t(xb, base, w, slot), n_slots=2, n_bins=4)
    b = multi_tree_hist_ref(*_t(xb, base, w, slot), n_slots=2, n_bins=4)
    assert torch.equal(a, b) and ops.launches == before      # the CPU path launches nothing
    with pytest.raises(TypeError):
        multi_tree_hist(*_t(xb.astype(np.int32), base, w, slot), n_slots=2, n_bins=4)
    with pytest.raises(ValueError):
        multi_tree_hist(*_t(xb, base, w[:, :10], slot), n_slots=2, n_bins=4)


def test_resolve_backend_and_channels():
    cpu = torch.device("cpu")
    assert th.resolve_backend("auto", cpu) == "segment_sum"
    assert th.resolve_backend("auto", torch.device("cuda")) == "pallas"
    with pytest.raises(ValueError):
        th.resolve_backend("pallas", cpu)
    with pytest.raises(ValueError):
        th.resolve_backend("cuda", cpu)
    xb, base, w, slot = _case(1, 10, 2, 1, 4, 2)
    with pytest.raises(ValueError):
        th.level_histograms(*_t(xb, base, w, slot), n_slots=1, n_bins=4, backend="pallas")
    from repro.core.histograms import class_channels, regression_channels

    y = RNG.integers(0, 3, 20).astype(np.int32)
    np.testing.assert_array_equal(th.class_channels(torch.from_numpy(y), 3).numpy(),
                                  np.asarray(class_channels(jnp.asarray(y), 3)))
    yf = RNG.normal(size=20).astype(np.float32)
    np.testing.assert_array_equal(th.regression_channels(torch.from_numpy(yf)).numpy(),
                                  np.asarray(regression_channels(jnp.asarray(yf))))


def test_hist_feature_slab_bounds():
    assert th.hist_feature_slab(1 << 20, 128, 256, 64, 4) == 32
    assert th.hist_feature_slab(100, 7, 1, 64, 4) == 7
    assert th.hist_feature_slab(100, 7, 4096, 256, 8) == 1
