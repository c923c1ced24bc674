"""The port's out-of-core edge fit (``repro_torch.core.binning``:
``StreamingQuantileSketch``, ``fit_bins_blocked``) against the
reference's (``repro.core.binning``) and against ``fit_bins``, on the
CPU: edges bitwise below the sketch's compression threshold (where they
equal ``np.quantile``) and above it, exclusion masks, ``merge`` and the
``state`` round trip."""
import numpy as np
import pytest

from repro.core import binning as jb
from repro_torch.core import binning as tb

RNG = np.random.default_rng(17)


def _blocks(x, nb):
    return [x[i:i + nb] for i in range(0, x.shape[0], nb)]


def _source(dtype, n=3000, f=6):
    x = RNG.standard_normal((n, f)) * 5
    x[:, 1] = np.round(x[:, 1])                          # heavy ties
    x[:, 2] = 3.0                                        # a constant feature
    x[::7, 3] = np.inf                                   # infinities stay in
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("nb", [500, 700, 3000])
def test_blocked_edges_below_threshold_equal_fit_bins_and_reference(dtype, nb):
    x = _source(dtype)
    got = tb.fit_bins_blocked(_blocks(x, nb), 32)
    np.testing.assert_array_equal(got, jb.fit_bins_blocked(_blocks(x, nb), 32))
    np.testing.assert_array_equal(got, tb.fit_bins(x, 32))
    assert got.dtype == np.float64 and got.shape == (6, 31)


@pytest.mark.parametrize("max_size", [16, 64, 257])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_edges_above_threshold_equal_reference(max_size, dtype):
    x = _source(dtype, n=5000)
    got = tb.fit_bins_blocked(_blocks(x, 613), 64, max_size=max_size)
    want = jb.fit_bins_blocked(_blocks(x, 613), 64, max_size=max_size)
    np.testing.assert_array_equal(got, want)
    sk = tb.StreamingQuantileSketch(6, max_size=max_size)
    for b in _blocks(x, 613):
        sk.update(b)
    assert not sk.exact and (sk.summary_sizes() <= 2 * max_size).all()


def test_exclusion_masks_and_nan_cells_match_reference():
    x = _source(np.float32)
    x[3, 0] = np.nan
    masks = [RNG.random(b.shape) < 0.05 for b in _blocks(x, 800)]
    as_list = [m if i % 2 == 0 else None for i, m in enumerate(masks)]
    as_dict = {i: m for i, m in enumerate(masks) if i != 1}
    for ex in (as_list, as_dict):
        got = tb.fit_bins_blocked(_blocks(x, 800), 16, exclude_masks=ex)
        np.testing.assert_array_equal(got, jb.fit_bins_blocked(_blocks(x, 800), 16, exclude_masks=ex))
    # every cell of feature 5 excluded: edges of 0.0, as in the reference
    all_out = {i: np.zeros(b.shape, bool) for i, b in enumerate(_blocks(x, 800))}
    for m in all_out.values():
        m[:, 5] = True
    got = tb.fit_bins_blocked(_blocks(x, 800), 16, exclude_masks=all_out)
    assert (got[5] == 0.0).all()
    np.testing.assert_array_equal(got, jb.fit_bins_blocked(_blocks(x, 800), 16, exclude_masks=all_out))


@pytest.mark.parametrize("max_size", [32, 4096])
def test_merge_and_state_round_trip_match_reference(max_size):
    x = _source(np.float32, n=2400)
    shards = [x[:1000], x[1000:1700], x[1700:]]
    sks, jsks = [], []
    for s in shards:
        sk, jsk = tb.StreamingQuantileSketch(6, max_size=max_size), \
            jb.StreamingQuantileSketch(6, max_size=max_size)
        for b in _blocks(s, 333):
            sk.update(b)
            jsk.update(b)
        sks.append(sk)
        jsks.append(jsk)
    merged, jmerged = sks[0], jsks[0]
    for sk, jsk in zip(sks[1:], jsks[1:]):
        merged.merge(sk)
        jmerged.merge(jsk)
    merged.merge(tb.StreamingQuantileSketch(6, max_size=max_size))   # an empty shard: a no-op
    np.testing.assert_array_equal(merged.edges(32), jmerged.edges(32))
    assert merged.value_dtype == np.float32 and (merged.count == 2400).all()
    state = merged.state(pad_to=2 * max_size + 1)
    jstate = jmerged.state(pad_to=2 * max_size + 1)
    for key in ("values", "weights", "count", "compressed"):
        np.testing.assert_array_equal(state[key], jstate[key])
    back = tb.StreamingQuantileSketch.from_state(state)
    np.testing.assert_array_equal(back.edges(32), merged.edges(32))
    assert back.exact == merged.exact == (max_size == 4096)
    if max_size == 4096:
        np.testing.assert_array_equal(merged.edges(32), tb.fit_bins(x, 32))


def test_sketch_refusals():
    with pytest.raises(ValueError):
        tb.StreamingQuantileSketch(0)
    with pytest.raises(ValueError):
        tb.StreamingQuantileSketch(3, max_size=1)
    sk = tb.StreamingQuantileSketch(3)
    with pytest.raises(ValueError, match="block"):
        sk.update(np.zeros((4, 2)))
    with pytest.raises(ValueError, match="exclude"):
        sk.update(np.zeros((4, 3)), exclude=np.zeros((4, 2), bool))
    with pytest.raises(ValueError, match="merge"):
        sk.merge(tb.StreamingQuantileSketch(4))
    with pytest.raises(ValueError, match="no blocks"):
        tb.fit_bins_blocked([], 8)
    with pytest.raises(tb.BinCountError):
        tb.fit_bins_blocked([np.zeros((4, 3))], 300)
