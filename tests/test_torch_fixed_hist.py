"""The regression histogram's fixed-point channels (``FixedPoint``), on the CPU.

On CUDA the histogram kernel sums the non-integer channels ``y`` and
``y^2`` as int64 multiples of ``2^-shift`` and rounds each sum once to
float32, so its result does not depend on the order of its atomics;
``multi_tree_hist_fixed_ref`` is its plain version, which the kernel must
equal bitwise (``tests/test_torch_cuda.py``, ``chip_smoke.py`` 5d). Here:
the determinism property itself (invariance under a permutation of the
samples), the error bound against the float64 exact sum, the scale at
extreme ``y`` and ``N``, a numpy emulation of the kernel's
quantise-and-convert (per-block int64 sums flushed in any order, the
conversion added into an ``out=`` carry), the fixed-point tile plan, and
that the CPU path keeps the float version (the reference's order).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.histograms import level_histograms, regression_fixed_point
from repro_torch.kernels.gain_ratio.ops import MAX_ROW_BYTES, class_tile
from repro_torch.kernels.gain_ratio.ref import (
    FixedPoint, fixed_shift, multi_tree_hist_fixed_ref, multi_tree_hist_ref,
)

RNG = np.random.default_rng(71)


def _case(N=997, F=5, S=4, B=8, tc=3, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, B, (N, F)).astype(np.uint8)
    y = (rng.normal(size=N) * scale).astype(np.float32)
    base = np.stack([np.ones_like(y), y, y * y], -1)
    w = rng.integers(0, 5, (tc, N)).astype(np.float32)
    slot = rng.integers(-1, S, (tc, N)).astype(np.int32)
    return x, y, base, w, slot


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_fixed_ref_is_invariant_under_sample_permutation(scale):
    x, y, base, w, slot = _case(scale=scale)
    fp = regression_fixed_point(y, w)
    want = multi_tree_hist_fixed_ref(*_t(x, base, w, slot), n_slots=4, n_bins=8, fixed=fp)
    for seed in range(3):
        p = np.random.default_rng(seed).permutation(x.shape[0])
        got = multi_tree_hist_fixed_ref(*_t(x[p], base[p], w[:, p], slot[:, p]), n_slots=4,
                                        n_bins=8, fixed=fp)
        assert torch.equal(got, want), f"permutation {seed} changed the fixed-point histogram"
    # the integer channel is the float version's, bitwise
    flt = multi_tree_hist_ref(*_t(x, base, w, slot), n_slots=4, n_bins=8)
    assert torch.equal(want[..., 0], flt[..., 0])


def _exact(x, base, w, slot, S, B):
    """The histogram summed exactly (float64 sums of the float32 products)."""
    tc, N = w.shape
    F, C = x.shape[1], base.shape[1]
    out = np.zeros((tc, S, F, B, C), np.float64)
    for t in range(tc):
        p = (w[t][:, None] * base).astype(np.float64)          # float32 products, exact in f64
        for i in np.flatnonzero((slot[t] >= 0) & (slot[t] < S)):
            out[t, slot[t, i], np.arange(F), x[i]] += p[i]
    return out


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_fixed_ref_within_its_bound_of_the_exact_sum(scale):
    """Each contribution rounds by at most 2^-(s+1), so a sum of m of them
    is within m * 2^-(s+1) of the exact one before its one rounding to
    float32, which adds at most half an ulp of the result."""
    x, y, base, w, slot = _case(scale=scale)
    fp = regression_fixed_point(y, w)
    got = multi_tree_hist_fixed_ref(*_t(x, base, w, slot), n_slots=4, n_bins=8,
                                    fixed=fp).numpy().astype(np.float64)
    exact = _exact(x, base, w, slot, 4, 8)
    m = np.zeros_like(exact[..., 0])
    for t in range(w.shape[0]):
        for i in np.flatnonzero(slot[t] >= 0):
            m[t, slot[t, i], np.arange(x.shape[1]), x[i]] += w[t, i] != 0
    bound = m[..., None] * 2.0 ** -(fp.shift + 1) + np.spacing(np.abs(exact).astype(np.float32)) / 2
    assert np.all(np.abs(got - exact)[..., 1:] <= bound[..., 1:])
    # ...and far inside float32's own rounding of those sums
    rel = np.abs(got - exact)[..., 1:] / np.maximum(np.abs(exact[..., 1:]), 1e-30)
    assert rel.max() <= 2.0 ** -23


@pytest.mark.parametrize("n,wmax,ymax", [
    (1, 1.0, 1.0), (2 ** 31, 64.0, 1.0), (2 ** 20, 16.0, 1e19), (2 ** 31, 2.0 ** 10, 1.8e19),
    (10, 3.0, 1e-30), (7, 1.0, np.float32(1.4e-45)),
])
def test_fixed_shift_never_overflows(n, wmax, ymax):
    vmax = max(float(ymax), float(np.float32(ymax) * np.float32(ymax)))
    s = fixed_shift(n, wmax, vmax)
    bound = float(n) * wmax * vmax
    assert bound * 2.0 ** s <= 2.0 ** 62 < bound * 2.0 ** (s + 1)      # tight and safe
    # the worst case: every contribution at the bound, all in one cell
    q = int(np.rint(np.float64(wmax) * np.float64(vmax) * 2.0 ** s))
    total = q * n                                                       # Python ints: no wrap
    assert total < 2 ** 63
    assert math.isfinite(2.0 ** s) and 2.0 ** -s > 0


def test_fixed_shift_refuses_what_has_no_scale():
    assert fixed_shift(100, 0.0, 5.0) == 0
    with pytest.raises(ValueError):
        fixed_shift(10, 1.0, float("inf"))


def test_regression_fixed_point_same_from_host_and_tensor():
    _, y, _, w, _ = _case(scale=37.0)
    a = regression_fixed_point(y, w)
    b = regression_fixed_point(torch.from_numpy(y), torch.from_numpy(w))
    assert a == b and a.c0 == 1
    assert a.shift == fixed_shift(w.shape[1], float(w.max()), float(np.float32(np.abs(y).max()) ** 2))


def _emulate_kernel(x, base, w, slot, S, B, fp, out, chunk, seed):
    """numpy emulation of ``hist_kernel<false, false, true>`` and
    ``fixed_point_convert``: blocks take ``chunk`` samples of each tree's
    slot-grouped samples; each sums its cells in int64 (the int channel as
    an integer, the fixed channels as ``rint(p * 2^s)``, half to even);
    blocks flush in a shuffled order into the float output (int channel,
    exact integers) and the int64 scratch; the conversion adds
    ``float32(float64(acc) * 2^-s)`` into ``out``."""
    tc, N = w.shape
    F, C = x.shape[1], base.shape[1]
    c0, Cf = fp.c0, base.shape[1] - fp.c0
    scratch = np.zeros((tc, S, F, B, Cf), np.int64)
    flushes = []
    for t in range(tc):
        live = np.flatnonzero((slot[t] >= 0) & (slot[t] < S) & (w[t] != 0))
        order = live[np.argsort(slot[t, live], kind="stable")]
        for p0 in range(0, len(order), chunk):
            cells = {}
            for i in order[p0:p0 + chunk]:
                s = slot[t, i]
                for c in range(C):
                    p = np.float32(w[t, i]) * np.float32(base[i, c])
                    if p == 0:
                        continue
                    v = np.int64(p) if c < c0 else np.int64(np.rint(np.float64(p) * 2.0 ** fp.shift))
                    for f in range(F):
                        key = (t, s, f, x[i, f], c)
                        cells[key] = cells.get(key, np.int64(0)) + v
            flushes.append(cells)
    rng = np.random.default_rng(seed)
    for j in rng.permutation(len(flushes)):
        for (t, s, f, b, c), v in flushes[j].items():
            if c < c0:
                out[t, s, f, b, c] = np.float32(out[t, s, f, b, c] + np.float32(v))
            else:
                scratch[t, s, f, b, c - c0] += v
    conv = (scratch.astype(np.float64) * 2.0 ** -fp.shift).astype(np.float32)
    out[..., c0:] = out[..., c0:] + conv
    return out


@pytest.mark.parametrize("chunk,seed", [(7, 0), (64, 1), (1000, 2)])
def test_kernel_emulation_equals_fixed_ref(chunk, seed):
    x, y, base, w, slot = _case(N=211, F=3, S=3, B=4, tc=2, scale=3.0, seed=seed)
    fp = regression_fixed_point(y, w)
    want = multi_tree_hist_fixed_ref(*_t(x, base, w, slot), n_slots=3, n_bins=4, fixed=fp).numpy()
    got = _emulate_kernel(x, base, w, slot, 3, 4, fp, np.zeros_like(want), chunk, seed)
    np.testing.assert_array_equal(got, want)
    # into a carry (out=), as a streamed level's earlier blocks leave it:
    # integer counts in the integer channel, any floats in the fixed ones
    carry = np.random.default_rng(seed).normal(size=want.shape).astype(np.float32)
    carry[..., 0] = np.rint(carry[..., 0] * 50)
    got = _emulate_kernel(x, base, w, slot, 3, 4, fp, carry.copy(), chunk, seed + 7)
    np.testing.assert_array_equal(got, carry + want)


def test_fixed_point_tile_plan():
    """Fixed point doubles a row's bytes (64-bit cells): regression's C 3
    fits whole at every bin count; the class axis tiles from C 114 at
    B 256 (C 227 without fixed point)."""
    for B in (2, 64, 256):
        assert class_tile(B, 3, fixed=True) == 3
    assert class_tile(256, 113, fixed=True) == 113
    assert (256 * 113 + 1) * 8 <= MAX_ROW_BYTES < (256 * 114 + 1) * 8
    ct = class_tile(256, 114, fixed=True)
    assert ct < 114 and ct % 4 == 0 and (256 * ct + 1) * 8 <= 48 * 1024
    assert class_tile(256, 226) == 226 and class_tile(256, 227) < 227


def test_cpu_path_keeps_the_float_version():
    """On the CPU ``level_histograms`` ignores ``fixed``: the main path
    sums in the reference's order (``test_torch_regression``'s parity)."""
    x, y, base, w, slot = _case(scale=5.0)
    tx, tb, tw, ts = _t(x, base, w, slot)
    fp = regression_fixed_point(y, w)
    got = level_histograms(tx, tb, tw, ts, n_slots=4, n_bins=8, fixed=fp)
    assert torch.equal(got, multi_tree_hist_ref(tx, tb, tw, ts, n_slots=4, n_bins=8))
    fixed = multi_tree_hist_fixed_ref(tx, tb, tw, ts, n_slots=4, n_bins=8, fixed=fp)
    torch.testing.assert_close(fixed, got, rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError):
        multi_tree_hist_fixed_ref(tx, tb, tw, ts, n_slots=4, n_bins=8, fixed=FixedPoint(3, 0))
