"""Rank programs of ``tests/test_torch_multiproc.py``.

``repro_torch.launch.mesh.run_world`` starts each rank as its own
process (gloo, the CPU) and calls ``world`` there. This module imports
numpy, torch and ``repro_torch`` only, so a rank never loads JAX or the
reference; it returns plain numpy results for the test to hold against
single-process ``train_prf`` and against ``repro``.
"""
import gc
import os
import sys
import tracemalloc
import warnings

import numpy as np
import torch

from repro_torch import ForestConfig, train_prf
from repro_torch.checkpoint import CheckpointTopologyError
from repro_torch.core import api
from repro_torch.core import distributed as dist_prf
from repro_torch.core.types import Forest
from repro_torch.data.pipeline import DataIntegrityError
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.multiproc import MultiHostMesh, MultiprocCheckpointManager

N_ROWS, BLOCK, SEED, KILL_AT = 250, 100, 3, 2
CFG = dict(n_trees=5, max_depth=4, n_bins=8, n_classes=3, feature_mode="importance",
           weighted_voting=True, sample_block=BLOCK)
# case -> (config overrides, dirty data, train_prf keywords)
CASES = {
    "clean": ({}, False, {}),
    "reuse": ({"hist_reuse": "on"}, False, {}),
    "sanitize": ({}, True, {"bad_block_policy": "sanitize"}),
    "quarantine": ({}, True, {"bad_block_policy": "quarantine"}),
    "raise": ({}, True, {}),                 # the default bad_block_policy
}
PARITY = ("clean", "reuse", "sanitize", "quarantine")
MEM_ROWS, MEM_FEATURES, MEM_BLOCK = 160_000, 128, 10_000
MEM_CFG = dict(n_trees=2, max_depth=3, n_bins=16, n_classes=2, weighted_voting=False,
               sample_block=MEM_BLOCK)


def make_data(n, f, dirty=False, nb=BLOCK):
    """``tests/test_multiproc.py``'s data: block 1 holds a NaN and an inf
    cell and block 2 an out-of-range label when ``dirty``."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32) + (x[:, 2] > 0.5).astype(np.int32)
    if dirty:
        x[nb + 3, 2] = np.nan
        x[nb + 7, 5] = np.inf
        y[2 * nb + 1] = 99
    return x, y


def model_np(model) -> dict:
    out = {n: getattr(model.forest, n).cpu().numpy() for n in Forest.FIELDS}
    out["edges"] = np.asarray(model.bin_edges)
    if model.quarantine is not None:
        out["counters"] = model.quarantine.counters()
        out["quarantined"] = list(model.quarantine.quarantined)
    return out


def error_np(e: Exception) -> dict:
    return {"type": type(e).__name__, "message": str(e),
            "block_index": getattr(e, "block_index", None),
            "columns": getattr(e, "columns", None), "reason": getattr(e, "reason", None)}


class Kill(Exception):
    """Raised from ``on_level`` after the level's checkpoint, on every rank."""


def kill_at(level, _):
    if level == KILL_AT:
        raise Kill


def train(case, n_features, runtime=None, **kw):
    """One case: ``train_prf`` (the dispatch, in a world of more than one
    process) without a runtime, else ``train_prf_multiproc`` on it."""
    over, dirty, call = CASES[case]
    x, y = make_data(N_ROWS, n_features, dirty)
    cfg = ForestConfig(**CFG, **over)
    if runtime is None:
        return train_prf(x, y, cfg, SEED, device="cpu", **call, **kw)
    return dist_prf.train_prf_multiproc(x, y, cfg, SEED, runtime=runtime, **call, **kw)


def world(shape, n_features, ckpt_dir, one_process_dir, draws, mem_dir):
    """Every case of the test module on a ``shape`` mesh: the parity cases,
    ``"raise"``, the reference's draws (dispatch and runtime forms, with
    stage stats), ``psum_hosts``, a kill at level ``KILL_AT`` and its
    resume in ``ckpt_dir``, then the walk-back past a corrupt shard; with
    ``one_process_dir`` (a single-process checkpoint) the resume that must
    refuse it and the placement's refusals, with ``mem_dir`` the memory
    case. A ``(world, 1)`` mesh goes through ``train_prf``'s own runtime,
    others through an explicit one."""
    runtime = MultiHostMesh(make_mesh(shape, device="cpu"))
    via = None if shape[1] == 1 else runtime
    out = {"runtime": repr(runtime), "shard": runtime.shard_lo}
    for case in PARITY:
        out[case] = model_np(train(case, n_features, via))
    try:
        train("raise", n_features, via)
        out["raise"] = None
    except DataIntegrityError as e:
        out["raise"] = error_np(e)

    w, u = draws
    x, y = make_data(N_ROWS, n_features)
    stats = {}
    out["draws"] = model_np(dist_prf.fit_prf_multiproc_from_draws(
        x, y, ForestConfig(**CFG), w, u, runtime=runtime, stats=stats))
    out["stats"] = stats
    if via is None:
        out["draws_dispatch"] = model_np(api.fit_prf_from_draws(x, y, ForestConfig(**CFG), w, u,
                                                                device="cpu"))

    vec = lambda r: np.array([2 ** 40 + 7 * r, -(3 << 33) * (r + 1), r], np.int64)  # noqa: E731
    out["psum_samples"] = runtime.psum_hosts(vec(runtime.shard_lo))
    out["psum_world"] = runtime.psum_hosts(vec(runtime.process_index),
                                           axes=runtime.mesh.axis_names)

    try:
        train("clean", n_features, via, checkpoint_dir=ckpt_dir, on_level=kill_at)
        raise AssertionError("the kill did not fire")
    except Kill:
        pass
    out["steps"] = sorted(os.listdir(ckpt_dir))
    levels = []
    out["resumed"] = model_np(train("clean", n_features, via, resume_from=ckpt_dir,
                                    on_level=lambda level, _: levels.append(level)))
    out["first_resumed_level"] = min(levels)
    out["walked_back"] = walk_back(runtime, via, n_features, ckpt_dir)
    out["manager"] = manager_case(runtime, os.path.join(os.path.dirname(ckpt_dir), "manager"))

    if one_process_dir is not None:
        try:
            train("clean", n_features, via, resume_from=one_process_dir)
            out["one_to_many"] = None
        except CheckpointTopologyError as e:
            out["one_to_many"] = error_np(e)
        place = runtime.block_placement([BLOCK], n_features)
        refusals = []
        for bad in (lambda: place.local(np.zeros((BLOCK // 2 - 1, n_features), np.uint8), 0),
                    lambda: runtime.local_row_range(BLOCK + 1)):
            try:
                bad()
                refusals.append(None)
            except ValueError as e:
                refusals.append(str(e))
        out["refusals"] = refusals
    if mem_dir is not None:
        out["mem"] = memory_case(mem_dir)
    out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro", "msgpack"))
    return out


def walk_back(runtime, via, n_features, ckpt_dir) -> dict:
    """The last process flips a byte of its own shard leaf of the newest
    step; a resume then walks every process back to the step before, in
    agreement, and still ends in the same forest."""
    last = os.path.join(ckpt_dir, sorted(os.listdir(ckpt_dir))[-1])
    runtime.barrier()
    if runtime.process_index == runtime.process_count - 1:
        tag = f".p{runtime.process_index:02d}.npy"
        mine = sorted(f for f in os.listdir(last) if f.endswith(tag))
        with open(os.path.join(last, mine[0]), "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
    runtime.barrier()
    levels = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = train("clean", n_features, via, resume_from=ckpt_dir,
                      on_level=lambda level, _: levels.append(level))
    return {"model": model_np(model), "first_level": min(levels),
            "warnings": [str(w.message) for w in caught if w.category is RuntimeWarning]}


def manager_case(runtime, directory) -> dict:
    """``MultiprocCheckpointManager`` on its own: steps 1-3 saved with
    ``keep=2``, each a replicated leaf and a leaf sharded by sample shard
    (4 rows a shard), then the newest restored through
    ``restore_latest_valid`` and ``restore_latest``."""
    D, d = runtime.n_data_shards, runtime.shard_lo
    boxes = {"rows": ((4 * D,), ((4 * d, 4 * d + 4),))}
    manager = MultiprocCheckpointManager(directory, keep=2, save_interval=1, runtime=runtime)
    for step in (1, 2, 3):
        manager.maybe_save({"rep": torch.full((3,), float(step)),
                            "rows": torch.arange(4 * d, 4 * d + 4) * step}, step, boxes=boxes)
    like = {"rep": torch.zeros(3), "rows": torch.zeros(4, dtype=torch.int64)}
    tree, step = manager.restore_latest_valid(like, boxes=boxes, device="cpu")
    latest, _ = manager.restore_latest(like, boxes=boxes, device="cpu")
    return {"steps": sorted(os.listdir(directory)), "step": step, "rep": tree["rep"].numpy(),
            "rows": tree["rows"].numpy(), "latest_rows": latest["rows"].numpy(),
            "files": sorted(os.listdir(os.path.join(directory, f"step_{step:08d}")))}


def memory_case(mem_dir) -> dict:
    """``tests/test_multiproc.py``'s memory drill: the streamed fit and growth
    on a float64 memmap, with ``tracemalloc``'s peak over the call and the
    bytes of the torch host tensors the run keeps."""
    x = np.memmap(os.path.join(mem_dir, "mem.f64"), dtype=np.float64, mode="r",
                  shape=(MEM_ROWS, MEM_FEATURES))
    y = np.load(os.path.join(mem_dir, "mem.y.npy"))
    runtime = MultiHostMesh(device="cpu")
    gc.collect()
    stats = {}
    tracemalloc.start()
    model = dist_prf.train_prf_multiproc(x, y, ForestConfig(**MEM_CFG), SEED, runtime=runtime,
                                         bad_block_policy=None, sketch_max_size=64, stats=stats)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    return {"peak": int(peak), "host_tensor_bytes": stats["host_tensor_bytes"],
            "raw": MEM_ROWS * MEM_FEATURES * 8,
            "n_data_shards": runtime.n_data_shards, "forest": model_np(model)}
