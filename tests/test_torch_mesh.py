"""The port's vertical-partition mesh plane against ``repro``, on the CPU.

Each mesh runs as a gloo world of one process per rank
(``repro_torch.launch.mesh.run_world``, rank programs in
``tests/torch_mesh_ranks.py``, one thread a rank, a wall-clock limit per
world), given the reference's data and draws. As
``tests/test_engine.py::test_mesh_plane_matches_local_bitwise`` holds the
reference's own mesh: on meshes (2, 2) and (4, 2), growth with
``hist_reduce`` psum and psum_scatter, early exit on and off, and
histogram reuse on, equals ``repro.core.forest.grow_forest`` bitwise;
so do prediction, the OOB tree weights, the sharded dimension
reduction's mask and the draws-taking trainer (``fit_sharded_from_draws``:
growth with the reference's mask, then OOB weights). Every rank returns
the same results. ``make_prf_train_fn`` + ``predict_sharded`` reach the
accuracy of ``tests/test_system.py``'s distributed test on its data.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ForestConfig as JConfig
from repro.core.binning import apply_bins, bin_dataset
from repro.core.dimred import dimension_reduction
from repro.core.dsi import bootstrap_counts
from repro.core.forest import grow_forest
from repro.core.voting import oob_accuracy, predict
from repro.data.tabular import make_classification, train_test_split
from repro_torch.launch.mesh import run_world

ARRS = ("feature", "threshold", "left_child", "class_counts", "value")
CFG = dict(n_trees=6, max_depth=4, n_bins=16, n_classes=3, feature_mode="all")
SYS_CFG = dict(n_trees=16, max_depth=6, n_bins=32, n_classes=4)
SHAPES = [(2, 2), (4, 2)]


@pytest.fixture(scope="module")
def ref():
    """The reference's data, draws and results (test_engine.py's mesh case)."""
    x, y = make_classification(n_samples=640, n_features=16, n_classes=3, seed=2)
    xb, _ = bin_dataset(x, CFG["n_bins"])
    xb, y = np.asarray(xb), np.asarray(y)
    w = np.asarray(bootstrap_counts(jax.random.PRNGKey(1), CFG["n_trees"], xb.shape[0]),
                   np.float32)
    key = jax.random.PRNGKey(5)
    icfg = JConfig(**dict(CFG, feature_mode="importance")).resolved(xb.shape[1])
    args = (jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w))
    mask = np.asarray(dimension_reduction(*args, icfg, key))
    u = np.asarray(jax.random.uniform(key, (CFG["n_trees"], xb.shape[1])), np.float32)
    out = {"xb": xb, "y": y, "w": w, "mask": mask, "u": u}
    for early in (True, False):
        out["forest", early] = grow_forest(*args, JConfig(**CFG, early_exit=early))
    f0 = out["forest", True]
    out["predict"] = np.asarray(predict(f0, args[0]))
    out["oob"] = np.asarray(oob_accuracy(f0, *args))
    fd = grow_forest(*args, icfg, jnp.asarray(mask))
    out["draws"] = fd, np.asarray(oob_accuracy(fd, *args))
    # tests/test_system.py:26: 2048 x 64, 4 classes; 1536 rows to train
    xs, ys = make_classification(n_samples=2048, n_features=64, n_classes=4, seed=1)
    xtr, ytr, xte, yte = train_test_split(xs, ys, 0.25, 0)
    xbs, edges = bin_dataset(xtr, SYS_CFG["n_bins"])
    xbte = np.asarray(apply_bins(jnp.asarray(xte), jnp.asarray(edges)))
    out["sys"] = (np.asarray(xbs)[:1536], np.asarray(ytr)[:1536], xbte[:496],
                  np.asarray(yte)[:496], SYS_CFG)
    return out


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request, ref):
    shape = request.param
    ranks = run_world("torch_mesh_ranks:resident", shape[0] * shape[1], timeout_s=240,
                      args=(shape, ref["xb"], ref["y"], ref["w"], CFG, ref["u"], ref["mask"],
                            ref["sys"]))
    return shape, ranks


def _equal(got, want, what):
    for n in ARRS:
        np.testing.assert_array_equal(got[n], np.asarray(getattr(want, n)), err_msg=f"{what}: {n}")


@pytest.mark.parametrize("hist_reduce", ["psum", "psum_scatter"])
@pytest.mark.parametrize("early", [True, False])
def test_mesh_growth_bitwise(world, ref, hist_reduce, early):
    shape, ranks = world
    _equal(ranks[0]["grow", hist_reduce, early], ref["forest", early],
           f"mesh {shape} {hist_reduce} early={early}")


@pytest.mark.parametrize("hist_reduce", ["psum", "psum_scatter"])
def test_mesh_reuse_on_equals_off(world, ref, hist_reduce):
    """Histogram reuse on the mesh (the packed histogram combined, the
    cache at the combined width) gives the reuse-off forest."""
    shape, ranks = world
    _equal(ranks[0]["reuse", hist_reduce], ref["forest", True], f"mesh {shape} reuse {hist_reduce}")
    for n in ARRS:
        np.testing.assert_array_equal(ranks[0]["reuse", hist_reduce][n],
                                      ranks[0]["grow", hist_reduce, True][n])


def test_mesh_predict_and_oob(world, ref):
    _, ranks = world
    np.testing.assert_array_equal(ranks[0]["predict"], ref["predict"])
    np.testing.assert_array_equal(ranks[0]["oob"], ref["oob"])


def test_mesh_dimension_reduction_mask(world, ref):
    """Root gain ratios of the local features, gathered over the feature
    axis, select the reference's mask from its uniform draws."""
    _, ranks = world
    np.testing.assert_array_equal(ranks[0]["dimred"], ref["mask"])


def test_mesh_fit_from_draws(world, ref):
    """The draws-taking trainer: the reference's forest and OOB weights."""
    _, ranks = world
    forest, w = ref["draws"]
    _equal(ranks[0]["draws"], forest, "fit_sharded_from_draws")
    np.testing.assert_array_equal(ranks[0]["draws"]["tree_weight"], w)


def test_global_best_splits_ties_and_nan_rows(world):
    """The winner merge as the reference computes it
    (``repro/core/distributed.py:_global_best_splits``), emulated in
    numpy over every feature shard's leaders: the largest gain wins, ties
    go to the smallest global ``(feature, threshold)`` key, and a row
    whose gains include NaN keeps NaN with every key int32 max, so shard
    0 wins."""
    from torch_mesh_ranks import merge_inputs

    shape, ranks = world
    M = shape[1]
    shards = [merge_inputs(m) for m in range(M)]
    gr_all = np.stack([sh[0] for sh in shards])
    best = gr_all.max(axis=0)                                   # NaN propagates, as jnp.max
    key_all = np.stack([(sh[1] + 4 * m) * 8 + sh[2] for m, sh in enumerate(shards)])
    key_all = np.where(gr_all == best, key_all, np.iinfo(np.int32).max)
    win = np.argmin(key_all, axis=0)
    assert np.isnan(best[0, 1]) and (win[0, 1] == 0) and np.isnan(best[1, 2])
    pick = np.take_along_axis
    for r, out in enumerate(ranks):
        got = out["merge"]
        np.testing.assert_array_equal(got["gain"], best)
        np.testing.assert_array_equal(got["feature"], pick(
            np.stack([sh[1] + 4 * m for m, sh in enumerate(shards)]), win[None], 0)[0])
        np.testing.assert_array_equal(got["threshold"], pick(np.stack([sh[2] for sh in shards]),
                                                             win[None], 0)[0])
        np.testing.assert_array_equal(got["left"], pick(np.stack([sh[3] for sh in shards]),
                                                        win[None, ..., None], 0)[0])
        np.testing.assert_array_equal(got["n"], pick(np.stack([sh[5] for sh in shards]),
                                                     win[None], 0)[0])
        m = r % M                                               # rank r's feature shard
        np.testing.assert_array_equal(got["mine"], win == m)


def test_mesh_ranks_agree(world):
    """Every rank returns the replicated forest, labels and weights (the
    merge case's ``mine`` is per rank: ``test_global_best_splits_*``)."""
    _, ranks = world
    for r, other in enumerate(ranks[1:], 1):
        assert other.keys() == ranks[0].keys()
        for key, v in ranks[0].items():
            if key == "merge":
                continue
            o = other[key]
            if isinstance(v, dict):
                for n in v:
                    np.testing.assert_array_equal(o[n], v[n], err_msg=f"rank {r} {key} {n}")
            else:
                np.testing.assert_array_equal(o, v, err_msg=f"rank {r} {key}")


def test_make_prf_train_fn_accuracy(world):
    """Stratified per-shard bootstrap: accuracy > 0.75 on the held-out
    rows, as the reference's distributed trainer on its (4, 2) mesh."""
    shape, ranks = world
    assert ranks[0]["accuracy"] > 0.75, (shape, ranks[0]["accuracy"])
