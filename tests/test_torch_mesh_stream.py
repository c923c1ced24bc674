"""The port's mesh plane over the streaming data plane, against ``repro``,
on the CPU (gloo, mesh (2, 2), rank programs in ``tests/torch_mesh_ranks.py``).

Given the reference's draws, ``grow_forest_streamed_sharded`` over
ragged host blocks (each padded with parked samples to the data-axis
multiple) equals ``repro.core.forest.grow_forest`` bitwise, for
``hist_reduce`` psum and psum_scatter, histogram reuse off and on; with a
quarantined block it equals ``repro``'s streamed growth with that block
quarantined. Streamed OOB equals ``repro``'s ``oob_accuracy``, streamed
prediction ``repro``'s ``predict``, and ``fit_bins_sharded`` (per-shard
sketches exchanged as float64 bit patterns) ``repro``'s
``fit_bins_blocked`` over the same blocks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ForestConfig as JConfig
from repro.core.api import grow_forest_streamed
from repro.core.binning import bin_dataset, fit_bins_blocked
from repro.core.dsi import bootstrap_counts
from repro.core.forest import grow_forest
from repro.core.voting import oob_accuracy, predict
from repro.data.pipeline import sample_blocks
from repro.data.tabular import make_classification
from repro_torch.launch.mesh import run_world

ARRS = ("feature", "threshold", "left_child", "class_counts", "value")
CFG = dict(n_trees=6, max_depth=4, n_bins=16, n_classes=3, feature_mode="all")
SPLITS = [150, 290, 500]          # ragged blocks of 150, 140, 210 and 140 rows
QUARANTINED = [1]
EDGE_BLOCK = 96                   # 640 raw rows: 7 blocks, split 4 / 3 over the data axis


@pytest.fixture(scope="module")
def case():
    x, y = make_classification(n_samples=640, n_features=16, n_classes=3, seed=2)
    xb, _ = bin_dataset(x, CFG["n_bins"])
    xb, y = np.asarray(xb), np.asarray(y)
    w = np.asarray(bootstrap_counts(jax.random.PRNGKey(1), CFG["n_trees"], xb.shape[0]),
                   np.float32)
    args = (jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w))
    forest = grow_forest(*args, JConfig(**CFG))
    blocks = np.split(xb, SPLITS)
    quar = grow_forest_streamed(blocks, y, w, JConfig(**CFG, hist_reuse="off"),
                                quarantined=QUARANTINED)
    ref = {"forest": forest, "quarantined": quar, "oob": np.asarray(oob_accuracy(forest, *args)),
           "predict": np.asarray(predict(forest, args[0])),
           "edges": fit_bins_blocked(sample_blocks(np.asarray(x), EDGE_BLOCK), CFG["n_bins"])}
    ranks = run_world("torch_mesh_ranks:streamed", 4, timeout_s=240,
                      args=((2, 2), xb, y, w, CFG, SPLITS, QUARANTINED, np.asarray(x), EDGE_BLOCK))
    return ref, ranks


def _equal(got, want, what):
    for n in ARRS:
        np.testing.assert_array_equal(got[n], np.asarray(getattr(want, n)), err_msg=f"{what}: {n}")


@pytest.mark.parametrize("hist_reduce", ["psum", "psum_scatter"])
@pytest.mark.parametrize("reuse", ["off", "on"])
def test_streamed_sharded_growth_bitwise(case, hist_reduce, reuse):
    ref, ranks = case
    _equal(ranks[0]["stream", hist_reduce, reuse], ref["forest"],
           f"streamed mesh {hist_reduce} reuse {reuse}")


def test_streamed_sharded_quarantine(case):
    ref, ranks = case
    _equal(ranks[0]["quarantined"], ref["quarantined"], "quarantined block")


def test_streamed_sharded_oob_and_predict(case):
    ref, ranks = case
    np.testing.assert_array_equal(ranks[0]["oob_streamed"], ref["oob"])
    np.testing.assert_array_equal(ranks[0]["predict_streamed"], ref["predict"])
    np.testing.assert_array_equal(ranks[0]["predict"], ref["predict"])


def test_fit_bins_sharded_equals_blocked(case):
    ref, ranks = case
    for r in ranks:
        np.testing.assert_array_equal(r["edges"], ref["edges"])


def test_streamed_ranks_agree(case):
    _, ranks = case
    for r, other in enumerate(ranks[1:], 1):
        for key, v in ranks[0].items():
            if isinstance(v, dict):
                for n in v:
                    np.testing.assert_array_equal(other[key][n], v[n], err_msg=f"rank {r} {key}")
            else:
                np.testing.assert_array_equal(other[key], v, err_msg=f"rank {r} {key}")
