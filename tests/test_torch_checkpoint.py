"""The port's checkpoint layer (``repro_torch.checkpoint``) and fault
harness (``repro_torch.launch.fault``), on the CPU.

* Integrity, mirroring ``tests/test_integrity.py``'s drills on the port's
  module: the CRC round trip of a JSON manifest, a byte flip caught
  before deserialisation, walk-back, an all-corrupt directory giving
  ``None``, a manifest without CRCs, stray entries ignored, torn writes
  at ``pre_rename`` and ``leaf[1]``, GC of orphaned tmp dirs, ``keep``
  rotation and a topology error.
* Draws: ``CheckpointCorruptor`` flips the bytes the reference's flips
  for the same seed, and ``FaultInjector`` raises the reference's fault
  sequence.
* The flattener's keys and leaf forms; ``ElasticRunner`` and
  ``StragglerMonitor`` on a toy loop.
"""
import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro.launch import fault as jfault
from repro_torch.checkpoint import (
    CheckpointCorruptionError, CheckpointManager, CheckpointTopologyError, latest_step,
    list_steps, restore_checkpoint, restore_latest_valid, save_checkpoint, verify_checkpoint,
)
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.launch.fault import (
    CheckpointCorruptor, ElasticRunner, FaultInjector, SimulatedFailure, StragglerMonitor,
)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32)),
        "slots": [torch.from_numpy(rng.integers(0, 99, size=(11,), dtype=np.int32))],
        "step": seed,
    }


def _trees_equal(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (_, la), (_, lb) in zip(fa, fb):
        assert type(la) is type(lb)
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_manifest_carries_crc_and_roundtrips(tmp_path):
    d = str(tmp_path)
    path = save_checkpoint(_tree(1), d, 1)
    manifest = _manifest(path)
    assert manifest["step"] == 1 and "topology" not in manifest
    assert [e["key"] for e in manifest["leaves"]] == ["slots/0", "step", "w"]
    assert all(isinstance(e["crc32"], int) for e in manifest["leaves"])
    assert manifest["leaves"][1]["dtype"] == "int32" and manifest["leaves"][1]["shape"] == []
    verify_checkpoint(d, 1)
    restored, step = restore_checkpoint(_tree(0), d, 1, device="cpu")
    assert step == 1 and restored["step"] == 1
    _trees_equal(restored, _tree(1))


def test_byte_flip_caught_before_deserialization(tmp_path):
    d = str(tmp_path)
    save_checkpoint(_tree(1), d, 1)
    assert CheckpointCorruptor(seed=0).corrupt(d) == 1
    with pytest.raises(CheckpointCorruptionError):
        verify_checkpoint(d, 1)
    with pytest.raises(CheckpointCorruptionError):
        restore_checkpoint(_tree(0), d, 1)
    with pytest.warns(RuntimeWarning):
        assert restore_latest_valid(_tree(0), d) is None


def test_restore_latest_valid_walks_back_past_corruption(tmp_path):
    d = str(tmp_path)
    save_checkpoint(_tree(1), d, 1)
    save_checkpoint(_tree(2), d, 2)
    CheckpointCorruptor(seed=0).corrupt(d)     # newest = step 2
    skipped = []
    with pytest.warns(RuntimeWarning, match="skipping corrupt checkpoint"):
        restored, step = restore_latest_valid(_tree(0), d, on_skip=lambda s, e: skipped.append(s))
    assert step == 1 and skipped == [2]
    _trees_equal(restored, _tree(1))


def test_fully_corrupt_directory_degrades_to_fresh_start(tmp_path):
    d = str(tmp_path)
    for s in (1, 2):
        save_checkpoint(_tree(s), d, s)
        CheckpointCorruptor(seed=s).corrupt(d, s)
    with pytest.warns(RuntimeWarning):
        assert restore_latest_valid(_tree(0), d) is None
    mgr = CheckpointManager(d)
    with pytest.warns(RuntimeWarning), pytest.raises(FileNotFoundError):
        mgr.restore_latest_valid(_tree(0))


def test_manifest_without_crc_still_restores(tmp_path):
    """A manifest without CRCs skips the CRC check but keeps the shape and
    dtype checks."""
    d = str(tmp_path)
    path = save_checkpoint(_tree(4), d, 1)
    manifest = _manifest(path)
    for e in manifest["leaves"]:
        del e["crc32"]
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    restored, _ = restore_checkpoint(_tree(0), d, 1)
    _trees_equal(restored, _tree(4))
    manifest["leaves"][2]["shape"] = [5, 7]
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointCorruptionError, match="drifted"):
        restore_checkpoint(_tree(0), d, 1)


def test_torn_manifest_and_missing_leaf_are_corruption(tmp_path):
    d = str(tmp_path)
    path = save_checkpoint(_tree(1), d, 1)
    os.remove(os.path.join(path, "leaf_00000.npy"))
    with pytest.raises(CheckpointCorruptionError, match="missing or unreadable"):
        verify_checkpoint(d, 1)
    path = save_checkpoint(_tree(2), d, 2)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"step": 2, "leav')
    with pytest.raises(CheckpointCorruptionError, match="torn or unreadable manifest"):
        restore_checkpoint(_tree(0), d, 2)
    save_checkpoint(_tree(3), d, 3)
    with pytest.raises(CheckpointCorruptionError, match="missing from manifest"):
        restore_checkpoint({"other": torch.zeros(2)}, d, 3)


def test_latest_step_ignores_stray_and_malformed_entries(tmp_path):
    d = str(tmp_path)
    save_checkpoint(_tree(1), d, 1)
    save_checkpoint(_tree(2), d, 7)
    (tmp_path / "step_garbage").write_text("not a step")
    (tmp_path / "step_00000099").write_text("a FILE, not a step dir")
    (tmp_path / "README").write_text("stray")
    (tmp_path / ".tmp_save_dead").mkdir()
    assert list_steps(d) == [1, 7]
    assert latest_step(d) == 7
    assert latest_step(str(tmp_path / "missing")) is None
    CheckpointManager(d)                        # init GCs the orphaned tmp dir
    assert not (tmp_path / ".tmp_save_dead").exists()
    assert (tmp_path / "step_garbage").exists()


def test_torn_write_never_clobbers_previous_step(tmp_path):
    d = str(tmp_path)
    save_checkpoint(_tree(1), d, 1)

    def tear(site):
        if site == "pre_rename":
            raise SimulatedFailure("killed before rename")

    with pytest.raises(SimulatedFailure):
        save_checkpoint(_tree(2), d, 2, fault_hook=tear)
    assert latest_step(d) == 1
    assert any(f.startswith(".tmp_save_") for f in os.listdir(d))
    restored, step = restore_latest_valid(_tree(0), d)
    assert step == 1
    _trees_equal(restored, _tree(1))
    CheckpointManager(d)
    assert not any(f.startswith(".tmp_save_") for f in os.listdir(d))

    def tear_leaf(site):
        if site == "leaf[1]":
            raise SimulatedFailure("killed mid-leaf")

    mgr = CheckpointManager(d, save_interval=1, fault_hook=tear_leaf)
    with pytest.raises(SimulatedFailure):
        mgr.maybe_save(_tree(3), 3)
    assert latest_step(d) == 1


def test_manager_keep_rotation_and_interval(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2, save_interval=2)
    paths = [mgr.maybe_save(_tree(s), s) for s in range(1, 8)]
    assert [p is not None for p in paths] == [False, True, False, True, False, True, False]
    assert list_steps(d) == [4, 6]
    restored, step = mgr.restore_latest(_tree(0))
    assert step == 6
    _trees_equal(restored, _tree(6))


def test_topology_mismatch_raises_and_is_not_walked_past(tmp_path, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setattr(ckpt, "_process_count", lambda: 2)
    path = save_checkpoint(_tree(1), d, 1)
    assert _manifest(path)["topology"] == {"process_count": 2}
    restore_checkpoint(_tree(0), d, 1)          # the saving topology restores
    monkeypatch.setattr(ckpt, "_process_count", lambda: 1)
    with pytest.raises(CheckpointTopologyError, match="saved by 2 process"):
        verify_checkpoint(d, 1)
    with pytest.raises(CheckpointTopologyError):
        restore_latest_valid(_tree(0), d)


class _Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_flatten_keys_and_leaf_forms(tmp_path):
    """The reference's key spelling for every container kind, ``None``
    without a leaf, and each leaf back in its template's form."""
    from repro_torch.core.types import GrowthState

    tree = {"nt": _Pair(torch.ones(2), torch.zeros(3, dtype=torch.int32)), "none": None,
            "tup": (np.arange(3), 5), "gs": GrowthState(
                forest=None, slot_node=torch.ones(2, dtype=torch.int32),
                sample_slot=torch.zeros(3, dtype=torch.int32), level=2, hist_cache={"z": torch.ones(1)})}
    assert [k for k, _ in ckpt._flatten(tree)] == [
        "gs/1", "gs/2", "gs/4", "gs/5/z", "nt/.a", "nt/.b", "tup/0", "tup/1"]
    save_checkpoint(tree, str(tmp_path), 3)
    back, _ = restore_checkpoint(tree, str(tmp_path), 3)
    assert isinstance(back["nt"], _Pair) and isinstance(back["tup"], tuple)
    assert isinstance(back["tup"][0], np.ndarray) and back["tup"][1] == 5
    assert back["gs"].level == 2 and isinstance(back["gs"], GrowthState) and back["none"] is None
    _trees_equal(back, tree)
    with pytest.raises(TypeError):
        save_checkpoint({"s": {1, 2}}, str(tmp_path), 4)


# ---------------------------------------------------------------------------
# The chaos hooks draw what the reference's draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_bytes", [(0, 16), (7, 8), (123, 64)])
def test_corruptor_flips_the_reference_bytes(tmp_path, seed, n_bytes):
    """The same step directory, corrupted by each package's corruptor with
    the same seed, twice in a row: the same files and bytes flipped."""
    rng = np.random.default_rng(seed)
    tree = {f"l{i}": rng.normal(size=(rng.integers(1, 40), 3)).astype(np.float32) for i in range(5)}
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jsave(tree, a, 1)
    jsave(tree, a, 2)
    shutil.copytree(a, b)
    jc, tc = jfault.CheckpointCorruptor(seed=seed, n_bytes=n_bytes), CheckpointCorruptor(
        seed=seed, n_bytes=n_bytes)
    assert jc.corrupt(a) == tc.corrupt(b) == 2
    assert jc.corrupt(a, 1) == tc.corrupt(b, 1) == 1
    for step in ("step_00000001", "step_00000002"):
        for f in sorted(os.listdir(os.path.join(a, step))):
            with open(os.path.join(a, step, f), "rb") as fa, open(os.path.join(b, step, f), "rb") as fb:
                assert fa.read() == fb.read(), (step, f)


@pytest.mark.parametrize("rate,seed,streak", [(0.5, 9, 2), (0.3, 7, 2), (0.9, 1, 3)])
def test_fault_injector_draws_the_reference_sequence(rate, seed, streak):
    def outcomes(inj):
        out = []
        for i in range(300):
            try:
                inj(f"s{i}")
                out.append(None)
            except (SimulatedFailure, jfault.SimulatedFailure) as e:
                out.append(str(e))
        return out, inj.calls, inj.injected

    ours = outcomes(FaultInjector(rate, seed=seed, max_consecutive=streak))
    assert ours == outcomes(jfault.FaultInjector(rate, seed=seed, max_consecutive=streak))
    assert ours[2] > 0
    worst = run = 0
    for o in ours[0]:
        run = run + 1 if o is not None else 0
        worst = max(worst, run)
    assert worst <= streak


def test_fault_knobs_validated():
    for bad in (dict(rate=1.5), dict(rate=-0.1), dict(rate=0.5, max_consecutive=0)):
        with pytest.raises(ValueError):
            FaultInjector(**bad)
    with pytest.raises(ValueError):
        CheckpointCorruptor(n_bytes=0)


def test_straggler_monitor_flags_the_reference_steps():
    durations = [1.0, 1.1, 0.9, 1.0, 1.0, 1.05, 5.0, 1.0, 0.95, 3.5, 1.0]
    ours, ref = StragglerMonitor(), jfault.StragglerMonitor()
    got = [ours.record(i, d) for i, d in enumerate(durations)]
    assert got == [ref.record(i, d) for i, d in enumerate(durations)]
    assert ours.flagged == ref.flagged == [6, 9]


def test_elastic_runner_resumes_a_toy_loop(tmp_path):
    """A counting loop that crashes twice: the runner restores the last
    checkpoint each time, every step runs exactly once in the final
    state, and a crash streak past ``max_restarts`` propagates."""
    mgr = CheckpointManager(str(tmp_path / "run"), keep=2, save_interval=1)
    crash_at = {3, 7}
    seen = []

    def init():
        return {"acc": torch.zeros(4), "step": 0}

    def loop(state, start, n_steps, on_step):
        for step in range(start + 1, n_steps + 1):
            if step in crash_at:
                crash_at.discard(step)
                raise SimulatedFailure(f"crash at {step}")
            state = {"acc": state["acc"] + step, "step": step}
            seen.append(step)
            on_step(step, state, {})
        return state

    state, monitor, restarts = ElasticRunner(mgr, max_restarts=3).run(init, loop, 10)
    assert restarts == 2 and state["step"] == 10
    assert torch.equal(state["acc"], torch.full((4,), 55.0))
    assert seen == list(range(1, 11)) and len(monitor.durations) == 10
    assert list_steps(mgr.directory) == [9, 10]

    def always(state, start, n_steps, on_step):
        raise SimulatedFailure("down")

    with pytest.raises(SimulatedFailure):
        ElasticRunner(CheckpointManager(str(tmp_path / "dead")), max_restarts=1).run(init, always, 3)
