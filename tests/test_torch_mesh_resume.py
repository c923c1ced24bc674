"""Kill and resume on the port's mesh plane, against ``repro``, on the CPU
(gloo worlds, rank programs in ``tests/torch_mesh_ranks.py``).

The drills of ``tests/test_fault.py::test_resume_after_crash_bit_identical_mesh``:
on a (2, 2) mesh, resident (``grow_sharded_checkpointed``) and streamed
(``grow_forest_streamed_sharded``, 170-row blocks) growth with a global
checkpoint every level, killed from ``on_level`` after level 1 or 3 on
every rank and resumed from the directory, histogram reuse off and on:
the resumed forest equals ``repro.core.forest.grow_forest`` bitwise and
the resumed run starts after the crash level. Then the elastic resume:
checkpoints a (2, 2) mesh wrote when killed at level 3 resume on a (4, 1)
mesh (another split of the rows and features) to the same forest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ForestConfig as JConfig
from repro.core.binning import bin_dataset
from repro.core.dsi import bootstrap_counts
from repro.core.forest import grow_forest
from repro.data.tabular import make_classification
from repro_torch.launch.mesh import run_world

ARRS = ("feature", "threshold", "left_child", "class_counts", "value")
CFG = dict(n_trees=6, max_depth=4, n_bins=16, n_classes=3, feature_mode="all")
BLOCK = 170


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    x, y = make_classification(n_samples=640, n_features=16, n_classes=3, seed=2)
    xb, _ = bin_dataset(x, CFG["n_bins"])
    xb, y = np.asarray(xb), np.asarray(y)
    w = np.asarray(bootstrap_counts(jax.random.PRNGKey(1), CFG["n_trees"], xb.shape[0]),
                   np.float32)
    forest = grow_forest(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w), JConfig(**CFG))
    root, elastic = tmp_path_factory.mktemp("drills"), tmp_path_factory.mktemp("elastic")
    drills = run_world("torch_mesh_ranks:resume", 4, timeout_s=240,
                       args=((2, 2), xb, y, w, CFG, BLOCK, str(root), str(elastic)))
    moved = run_world("torch_mesh_ranks:resume_elastic", 4, timeout_s=240,
                      args=((4, 1), xb, y, w, CFG, BLOCK, str(elastic)))
    return forest, drills, moved


def _equal(got, want, what):
    for n in ARRS:
        np.testing.assert_array_equal(got[n], np.asarray(getattr(want, n)), err_msg=f"{what}: {n}")


@pytest.mark.parametrize("path", ["resident", "streamed"])
@pytest.mark.parametrize("reuse", ["off", "on"])
@pytest.mark.parametrize("kill_at", [1, 3])
def test_mesh_kill_and_resume_bitwise(case, path, reuse, kill_at):
    forest, drills, _ = case
    for rank, out in enumerate(drills):
        got, first = out[path, reuse, kill_at]
        assert first == kill_at + 1, (rank, first)
        _equal(got, forest, f"rank {rank} {path} reuse {reuse} killed at {kill_at}")


@pytest.mark.parametrize("path", ["resident", "streamed"])
def test_mesh_elastic_resume_onto_another_shape(case, path):
    forest, _, moved = case
    for rank, out in enumerate(moved):
        got, first = out[path]
        assert first == 4, (rank, first)
        _equal(got, forest, f"rank {rank}: (2, 2) checkpoint resumed on (4, 1), {path}")
