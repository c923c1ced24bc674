"""The port's multi-process plane against single-process ``train_prf`` and
against ``repro``, on the CPU (the drills of ``tests/test_multiproc.py``).

Each world is a gloo world of one process per rank
(``repro_torch.launch.mesh.run_world``, a wall-clock limit per world,
spawned once per mesh shape for the module; rank programs in
``tests/torch_multiproc_ranks.py``): 2 processes on mesh (2, 1), 4 on
(4, 1) and 4 on (2, 2). The data is ``tests/test_multiproc.py``'s: 250
rows in blocks of 100 (so the last block's windows are part padding),
13 features, or 14 on (2, 2), whose two feature shards need an even
count; ``n_trees=5, max_depth=4, n_bins=8, n_classes=3``, importance
mode, weighted voting, seed 3.

* ``train_prf`` in a world of (world, 1) dispatches to
  ``train_prf_multiproc`` (an explicit ``MultiHostMesh`` on (2, 2)); the
  model (forest and edges) equals single-process ``train_prf``'s bitwise
  on the same data and seed: clean, ``hist_reuse="on"``, ``"sanitize"``
  and ``"quarantine"`` (with the same validator counters); ``"raise"``
  gives the same typed ``DataIntegrityError`` on every rank.
* ``fit_prf_multiproc_from_draws`` (and ``fit_prf_from_draws``'s
  dispatch), given the reference's draws, equals ``repro.core.api.train_prf``
  bitwise; each rank fed exactly its window of every block in the
  dimension-reduction sweep.
* ``psum_hosts`` adds each sample shard once (every process once over
  every axis), exactly, past 32 bits.
* ``MultiprocCheckpointManager`` rotates its steps and restores each
  process's own shard of the newest.
* A kill after level 2 under ``MultiprocCheckpointManager`` resumes
  bitwise from level 3; with one process's shard of the newest step
  corrupted, every process walks back to the step before together; a
  2-process checkpoint refuses a 1-process resume
  and a 1-process checkpoint a 2-process resume
  (``CheckpointTopologyError``).
* On a 160,000 x 128 float64 memmap (``sketch_max_size=64``) the
  host memory of each process stays below ``raw_bytes / (2 *
  n_data_shards)``: the ``tracemalloc`` peak (numpy's allocations) plus
  the torch host tensors the run keeps (the binned windows, which
  ``tracemalloc`` does not see; the trainer's ``host_tensor_bytes``).
  The device's own tensors, here on the CPU, are not counted, as on a
  card they are device memory.
* ``initialize`` joins processes over a ``tcp://`` rendezvous.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core import ForestConfig as JConfig
from repro.core.api import train_prf as jtrain
from repro.core.dsi import bootstrap_counts
from repro_torch.checkpoint import CheckpointTopologyError
from repro_torch.data.pipeline import DataIntegrityError
from repro_torch.launch.mesh import run_world

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
import torch_multiproc_ranks as ranks  # noqa: E402

SHAPES = [(2, 1), (4, 1), (2, 2)]
FEATURES = {(2, 1): 13, (4, 1): 13, (2, 2): 14}
ARRS = ("feature", "threshold", "left_child", "class_counts", "value", "tree_weight", "edges")


def _ids(shape):
    return f"{shape[0]}x{shape[1]}"


def _error(fn) -> dict:
    try:
        fn()
    except Exception as e:  # the test compares the type
        return ranks.error_np(e)
    raise AssertionError("no error")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Single-process ``train_prf`` of every case, the reference's draws and
    ``repro``'s model on them, a single-process checkpoint killed at level 2,
    and the memory case's memmap."""
    out = {"one_process_dir": str(tmp_path_factory.mktemp("one_process") / "ckpt")}
    for f in sorted(set(FEATURES.values())):
        for case in ranks.PARITY:
            out[f, case] = ranks.model_np(ranks.train(case, f))
        out[f, "raise"] = _error(lambda: ranks.train("raise", f))
        x, y = ranks.make_data(ranks.N_ROWS, f)
        jcfg = JConfig(**ranks.CFG)
        k_boot, k_dim = jax.random.split(jax.random.PRNGKey(ranks.SEED))
        w = np.asarray(bootstrap_counts(k_boot, jcfg.n_trees, x.shape[0]), np.float32)
        u = np.asarray(jax.random.uniform(k_dim, (jcfg.n_trees, f)), np.float32)
        out[f, "draws"] = (w, u)
        jm = jtrain(x, y, jcfg, ranks.SEED)
        out[f, "reference"] = {**{n: np.asarray(getattr(jm.forest, n)) for n in ARRS[:-1]},
                               "edges": np.asarray(jm.bin_edges)}
    with pytest.raises(ranks.Kill):
        ranks.train("clean", 13, checkpoint_dir=out["one_process_dir"], on_level=ranks.kill_at)
    mem = tmp_path_factory.mktemp("mem")
    rng = np.random.default_rng(11)
    mm = np.memmap(mem / "mem.f64", dtype=np.float64, mode="w+",
                   shape=(ranks.MEM_ROWS, ranks.MEM_FEATURES))
    for o in range(0, ranks.MEM_ROWS, ranks.MEM_BLOCK):
        mm[o:o + ranks.MEM_BLOCK] = rng.normal(size=(ranks.MEM_BLOCK, ranks.MEM_FEATURES))
    mm.flush()
    del mm
    np.save(mem / "mem.y.npy", rng.integers(0, 2, size=ranks.MEM_ROWS).astype(np.int32))
    out["mem_dir"] = str(mem)
    return out


class _Worlds:
    """``worlds(shape)``: the ranks' results of one world, spawned at first
    use; ``worlds.ckpt[shape]``: the directory its kill left."""

    def __init__(self, ref, tmp_path_factory):
        self.ref, self.tmp, self.results, self.ckpt = ref, tmp_path_factory, {}, {}

    def __call__(self, shape):
        if shape not in self.results:
            f = FEATURES[shape]
            first = shape == SHAPES[0]
            self.ckpt[shape] = str(self.tmp.mktemp(f"ckpt_{_ids(shape)}") / "ckpt")
            self.results[shape] = run_world(
                "torch_multiproc_ranks:world", shape[0] * shape[1], timeout_s=300,
                args=(shape, f, self.ckpt[shape], self.ref["one_process_dir"] if first else None,
                      self.ref[f, "draws"], self.ref["mem_dir"] if first else None))
        return self.results[shape]


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    return _Worlds(ref, tmp_path_factory)


def _equal(got, want, what):
    for n in ARRS:
        np.testing.assert_array_equal(got[n], want[n], err_msg=f"{what}: {n}")


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
@pytest.mark.parametrize("case", ranks.PARITY)
def test_multiproc_model_bitwise_single_process(ref, worlds, shape, case):
    want = ref[FEATURES[shape], case]
    for r, out in enumerate(worlds(shape)):
        _equal(out[case], want, f"{_ids(shape)} rank {r} {case}")
        if "counters" in want:
            assert out[case]["counters"] == want["counters"]
            assert out[case]["quarantined"] == want["quarantined"]


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_multiproc_raise_same_error_every_rank(ref, worlds, shape):
    want = ref[FEATURES[shape], "raise"]
    assert want["type"] == DataIntegrityError.__name__ and want["block_index"] == 1
    for out in worlds(shape):
        assert out["raise"] == want


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_multiproc_from_reference_draws_equals_repro(ref, worlds, shape):
    want = ref[FEATURES[shape], "reference"]
    for r, out in enumerate(worlds(shape)):
        _equal(out["draws"], want, f"{_ids(shape)} rank {r}: fit_prf_multiproc_from_draws")
        if "draws_dispatch" in out:
            _equal(out["draws_dispatch"], want, f"{_ids(shape)} rank {r}: fit_prf_from_draws")


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_each_rank_feeds_its_window(worlds, shape):
    """One sweep (dimension reduction) feeds each rank its window of every
    block: padded rows over the sample shards, its feature shard's columns."""
    D, M = shape
    f = FEATURES[shape]
    sizes = [ranks.BLOCK, ranks.BLOCK, ranks.N_ROWS - 2 * ranks.BLOCK]
    window = sum(-(-n // D) for n in sizes) * (f // M)
    for out in worlds(shape):
        fed = out["stats"]["feed_bytes"]
        assert fed["dimension_reduction"] == window
        assert fed["screen"] == fed["sketch"] == fed["binning"] == 0
        assert fed["oob"] == window
        assert set(fed) <= set(out["stats"])
        assert all(out["stats"][s] >= 0 for s in fed)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_psum_hosts_exact_over_sample_shards(worlds, shape):
    def vec(r):
        return np.array([2 ** 40 + 7 * r, -(3 << 33) * (r + 1), r], np.int64)

    D = shape[0]
    world = worlds(shape)
    assert sorted({o["shard"] for o in world}) == list(range(D))
    for out in world:
        np.testing.assert_array_equal(out["psum_samples"], sum(vec(d) for d in range(D)))
        np.testing.assert_array_equal(out["psum_world"], sum(vec(r) for r in range(len(world))))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_multiproc_kill_and_resume_bitwise(ref, worlds, shape):
    want = ref[FEATURES[shape], "clean"]
    for r, out in enumerate(worlds(shape)):
        assert out["steps"] == ["step_00000001", "step_00000002"], out["steps"]
        assert out["first_resumed_level"] == ranks.KILL_AT + 1
        _equal(out["resumed"], want, f"{_ids(shape)} rank {r}: resumed")


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_multiproc_walk_back_agrees(ref, worlds, shape):
    """One process's corrupt shard of the newest step walks every process
    back to the step before (the verdicts summed over all processes,
    ranks that share a sample shard included), to the same forest."""
    want = ref[FEATURES[shape], "clean"]
    for r, out in enumerate(worlds(shape)):
        got = out["walked_back"]
        assert got["first_level"] == ranks.KILL_AT, got["first_level"]
        assert any(f"only {len(worlds(shape)) - 1} of {len(worlds(shape))} processes" in w
                   for w in got["warnings"]), got["warnings"]
        _equal(got["model"], want, f"{_ids(shape)} rank {r}: walked back")


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_multiproc_manager_rotates_and_restores(worlds, shape):
    """``MultiprocCheckpointManager`` keeps the newest two of three steps;
    rank 0 alone writes the replicated leaf, every process its shard; the
    newest step restores each process's own shard."""
    world = worlds(shape)
    for out in world:
        got, d = out["manager"], out["shard"]
        assert got["steps"] == ["step_00000002", "step_00000003"], got["steps"]
        assert got["step"] == 3
        np.testing.assert_array_equal(got["rep"], np.full(3, 3.0, np.float32))
        np.testing.assert_array_equal(got["rows"], np.arange(4 * d, 4 * d + 4) * 3)
        np.testing.assert_array_equal(got["latest_rows"], got["rows"])
        npy = [f for f in got["files"] if f.endswith(".npy")]
        assert len([f for f in npy if ".p" not in f]) == 1, got["files"]
        assert len([f for f in npy if ".p" in f]) == len(world), got["files"]
        assert "manifest.json" in got["files"]


@pytest.mark.parametrize("direction", ["2to1", "1to2"])
def test_multiproc_checkpoint_topology_change(worlds, direction):
    """A 2-process checkpoint resumed by one process, and a 1-process
    checkpoint resumed by a world of 2, refuse with the topology error."""
    world = worlds((2, 1))
    if direction == "1to2":
        for out in world:
            got = out["one_to_many"]
            assert got["type"] == CheckpointTopologyError.__name__, got
        return
    with pytest.raises(CheckpointTopologyError, match="saved by 2 process"):
        ranks.train("clean", FEATURES[(2, 1)], resume_from=worlds.ckpt[(2, 1)])


def test_memory_bounded_by_local_shard(worlds):
    world = worlds((2, 1))
    assert len({m["mem"]["forest"]["feature"].tobytes() for m in world}) == 1
    for r, out in enumerate(world):
        mem = out["mem"]
        bound = mem["raw"] / (2 * mem["n_data_shards"])
        assert mem["n_data_shards"] == 2
        assert mem["host_tensor_bytes"] > 0
        used = mem["peak"] + mem["host_tensor_bytes"]
        assert used < bound, (f"rank {r}: tracemalloc peak {mem['peak'] / 2**20:.1f} MiB + host "
                              f"tensors {mem['host_tensor_bytes'] / 2**20:.1f} MiB >= bound "
                              f"{bound / 2**20:.1f} MiB")


def test_placement_refuses_rows_of_another_window(worlds):
    for out in worlds((2, 1)):
        placed, divide = out["refusals"]
        assert placed is not None and "host-local rows" in placed
        assert divide is not None and "do not divide" in divide


def test_ranks_load_no_jax(worlds):
    for shape in SHAPES:
        for out in worlds(shape):
            assert out["loaded"] == []


_INIT = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch import multiproc
rank, world = multiproc.initialize({addr!r}, 2, int(sys.argv[1]), device="cpu", timeout_s=60)
rt = multiproc.MultiHostMesh(device="cpu")
print(json.dumps({{"rank": rank, "world": world, "multi": multiproc.is_multiprocess(),
                  "backend": rt.mesh.backend,
                  "sum": rt.psum_hosts([2 ** 35 * (rank + 1)]).tolist()}}))
"""


def test_initialize_over_tcp():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = _INIT.format(src=os.path.join(os.path.dirname(TESTS), "src"), addr=f"127.0.0.1:{port}")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, text
        got = json.loads(text.strip().splitlines()[-1])
        assert got == {"rank": r, "world": 2, "multi": True, "backend": "gloo",
                       "sum": [3 * 2 ** 35]}
