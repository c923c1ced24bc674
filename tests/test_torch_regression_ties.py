"""Comparing two regression forests grown from the same draws where float
sums may round differently (numpy only; shared with
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

On the card the regression channels ``y`` and ``y^2`` of the histogram
are summed by float atomics in an order that changes from run to run
(the kernel, and the plain path's CUDA ``index_add_``), so a split whose
best and second-best candidates are tied to float rounding can go either
way. ``compare_regression_forests`` walks both forests from each root
over matched node pairs; where the pair splits alike it descends, where
it does not (a divergence) it checks that the two choices are tied: their
variance gains, recomputed in float64 on the node's ``m`` in-bag rows,
differ by at most ``tol * sqrt(m)`` times the node's weighted sum of
``y^2``. That is the size of the float32 rounding the choice was made
under: a sum of ``m`` terms added in a random order is off by about
``sqrt(m)`` roundings of its magnitude, and the default ``tol``, 16
float32 roundings (16 * 2^-24), covers the bin cumsum and the three
sums of squares a gain subtracts. A split against a leaf is a tie when
the split's gain is that small. Below a
divergence nothing is compared. Matched leaves must agree in value to
float rounding; the caller compares the weights of the trees that did not
diverge, and the predictions when no tree did.
"""
import numpy as np


def _gain64(xb, y, w, rows, feature, threshold):
    """Variance reduction of the split ``x[:, feature] <= threshold`` of
    ``rows`` in float64, in-bag weights ``w``."""
    def sse(m):
        ww, yy = w[m], y[m]
        n = ww.sum()
        return 0.0 if n <= 0 else float((ww * yy * yy).sum() - (ww * yy).sum() ** 2 / n)

    left = xb[rows, feature].astype(np.int64) <= threshold
    return sse(rows) - sse(rows[left]) - sse(rows[~left])


TIE_TOL = 16 * 2.0 ** -24


def compare_regression_forests(fa: dict, fb: dict, xb, y, w, *, tol=TIE_TOL, value_rtol=1e-5,
                               value_atol=1e-5):
    """``fa``, ``fb``: numpy ``feature``, ``threshold``, ``left_child``,
    ``value`` ``[k, P]``; ``xb`` ``[N, F]`` uint8 training bins, ``y``
    ``[N]``, ``w`` ``[k, N]`` in-bag weights. Returns ``{"divergent":
    [k, P] bool (nodes of ``fa`` where the forests diverge), "divergences":
    [(tree, node_a, node_b, gain_a, gain_b, allowed)], "untied": the
    divergences that are not ties, "leaf_value_max_abs": ..., "leaves_off":
    matched leaves whose values differ past the tolerance}``."""
    xb, y, w = np.asarray(xb), np.asarray(y, np.float64), np.asarray(w, np.float64)
    k, P = fa["feature"].shape
    divergent = np.zeros((k, P), dtype=bool)
    divergences, untied, leaves_off, vmax = [], [], [], 0.0
    for t in range(k):
        wt = w[t]
        stack = [(0, 0, np.flatnonzero(wt > 0))]
        while stack:
            a, b, rows = stack.pop()
            fa_, fb_ = int(fa["feature"][t, a]), int(fb["feature"][t, b])
            ta, tb = int(fa["threshold"][t, a]), int(fb["threshold"][t, b])
            if fa_ < 0 and fb_ < 0:
                va, vb = float(fa["value"][t, a]), float(fb["value"][t, b])
                vmax = max(vmax, abs(va - vb))
                if abs(va - vb) > value_atol + value_rtol * abs(vb):
                    leaves_off.append((t, a, b, va, vb))
                continue
            if fa_ == fb_ and ta == tb:
                left = xb[rows, fa_].astype(np.int64) <= ta
                la, lb = int(fa["left_child"][t, a]), int(fb["left_child"][t, b])
                stack += [(la, lb, rows[left]), (la + 1, lb + 1, rows[~left])]
                continue
            ga = _gain64(xb, y, wt, rows, fa_, ta) if fa_ >= 0 else 0.0
            gb = _gain64(xb, y, wt, rows, fb_, tb) if fb_ >= 0 else 0.0
            allowed = tol * np.sqrt(max(rows.size, 1)) * float((wt[rows] * y[rows] ** 2).sum())
            divergent[t, a] = True
            entry = (t, a, b, ga, gb, allowed)
            divergences.append(entry)
            if abs(ga - gb) > allowed:
                untied.append(entry)
    return {"divergent": divergent, "divergences": divergences, "untied": untied,
            "leaf_value_max_abs": vmax, "leaves_off": leaves_off}


# ---------------------------------------------------------------------------
# The comparer itself, on the CPU
# ---------------------------------------------------------------------------


def _forest_and_data():
    from repro_torch.core.forest import grow_forest
    from repro_torch.core.types import ForestConfig

    rng = np.random.default_rng(4)
    xb = rng.integers(0, 16, size=(800, 6)).astype(np.uint8)
    xb[:, 5] = xb[:, 4]                          # feature 5 splits exactly as feature 4: exact ties
    y = (np.sin(xb[:, 0] / 3.0) + 0.3 * xb[:, 4] / 16 + 0.05 * rng.normal(size=800)).astype(np.float32)
    w = rng.integers(0, 3, size=(4, 800)).astype(np.float32)
    cfg = ForestConfig(n_trees=4, max_depth=4, n_bins=16, regression=True, feature_mode="all").resolved(6)
    f = grow_forest(xb, y, w, cfg, device="cpu")
    arrays = {n: getattr(f, n).numpy().copy() for n in ("feature", "threshold", "left_child", "value")}
    return arrays, xb, y, w


def test_identical_forests_have_no_divergence():
    fa, xb, y, w = _forest_and_data()
    out = compare_regression_forests(fa, fa, xb, y, w)
    assert not out["divergences"] and not out["leaves_off"] and out["leaf_value_max_abs"] == 0.0
    assert not out["divergent"].any()


def test_a_tied_flip_passes_and_a_real_difference_does_not():
    fa, xb, y, w = _forest_and_data()
    t, n = np.argwhere(fa["feature"] == 4)[0]        # a split on feature 4 ...
    tied = {k: v.copy() for k, v in fa.items()}
    tied["feature"][t, n] = 5                         # ... taken on its exact copy: a tie
    out = compare_regression_forests(fa, tied, xb, y, w)
    assert [d[:3] for d in out["divergences"]] == [(t, n, n)] and not out["untied"]
    assert out["divergent"][t, n] and out["divergent"].sum() == 1
    worse = {k: v.copy() for k, v in fa.items()}
    t0 = 0
    worse["threshold"][t0, 0] = (worse["threshold"][t0, 0] + 7) % 15   # another root split
    assert compare_regression_forests(fa, worse, xb, y, w)["untied"]
    off = {k: v.copy() for k, v in fa.items()}
    leaf = np.argwhere((fa["feature"][1] < 0) & (np.abs(fa["value"][1]) > 0))[0][0]
    off["value"][1, leaf] += 1e-2
    assert compare_regression_forests(fa, off, xb, y, w)["leaves_off"]
