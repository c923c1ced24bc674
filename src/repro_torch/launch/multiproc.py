"""The multi-process training plane over ``torch.distributed`` (paper §4 at
cluster scale; counterpart of ``repro/launch/multiproc.py``).

One process per host (a rank), and the invariant that lets the out-of-core
trainer scale: *each process reads, bins and feeds only its own rows*.
Host memory and the host-to-device feed then add up over the processes
instead of passing through one machine.

* :func:`initialize` joins this process to a world (``init_process_group``
  over a ``tcp://`` rendezvous; NCCL when every process on the host has a
  card of its own, else gloo, ``launch.mesh.default_backend``).
* :class:`MultiHostMesh` is a ``launch.mesh.Mesh`` plus this process's
  place in the row layout: its sample shard (``shard_lo`` / ``shard_hi``
  of ``n_data_shards``), the rows of a padded global row dimension it
  owns (``local_row_range``), a ``BlockFeeder`` placement over the
  host-local rows it read (``block_placement``), ``feed_bytes``, and
  ``psum_hosts``, an exact integer sum over the processes.
* Multi-process checkpoints: rank 0 writes the manifest and the
  replicated leaves, every process a sub-manifest with its own shard
  leaves, under the single-process format's tmp-dir + rename protocol
  with a CRC32 per leaf (``save_checkpoint_multiproc``,
  ``restore_checkpoint_multiproc``, ``restore_latest_valid_multiproc``,
  :class:`MultiprocCheckpointManager`). A changed process count or row
  layout raises :class:`CheckpointTopologyError`, never a wrong forest.
  The mesh drivers' global steps (``save_checkpoint(layout="global")``)
  are another layout and resume on any mesh.

**Ranks, not devices.** In the reference a process may own several
devices, so a sample shard is pinned to one process and a process owns a
contiguous range of shards. Here a process is one rank of the mesh and
owns exactly one sample shard: ``shard_hi = shard_lo + 1``. On a
``(data, model)`` mesh the ranks along ``model`` share that sample shard:
they read the same local rows (all features, as the local devices of one
reference process do) and each feeds its own feature columns.
``psum_hosts`` therefore sums over the sample-axis group only, so that
each sample shard's counts are added once, and every rank of the shard
gets the sum. The reference's refusals of a shard spread over processes
and of non-contiguous shards cannot arise; what stays is the refusal of
rows from another window: a block whose host-local rows are not this
process's window of it (``block_placement``), and a padded row count that
the sample shards do not divide (``local_row_range``).

Each process writes its files on a file system that every process sees
(one host, or a shared mount).
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.checkpoint import (
    _TMP_PREFIX, CheckpointCorruptionError, CheckpointManager, CheckpointTopologyError,
    _check_topology, _crc32, _flatten, _from_host, _load_leaf, _load_manifest, _to_host,
    _unflatten, latest_step, list_steps,
)
from .mesh import Mesh, default_backend, init_rank, make_mesh, shard_rows

Box = Tuple[Tuple[int, int], ...]
Boxes = Dict[str, Tuple[Tuple[int, ...], Box]]


def initialize(coordinator: str, num_processes: int, process_id: int, *,
               backend: Optional[str] = None, device=None,
               timeout_s: float = 600.0) -> Tuple[int, int]:
    """Join this process to a world of ``num_processes`` as rank
    ``process_id``, with the rendezvous at ``coordinator`` (``host:port``;
    rank 0 listens there). ``device`` is the device the run's mesh will
    use (default CUDA). ``backend`` defaults to NCCL when that device is
    CUDA and every process on this host (``LOCAL_WORLD_SIZE``, else
    ``num_processes``) has a card, else gloo. Returns ``(rank, world
    size)``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dev_type = torch.device(device).type if device is not None else "cuda"
    init_rank(process_id, num_processes, f"tcp://{coordinator}",
              backend or default_backend(local, dev_type), timeout_s=timeout_s)
    return dist.get_rank(), dist.get_world_size()


def is_multiprocess() -> bool:
    """True in an initialised world of more than one process."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


class _HostPlacement:
    """A ``BlockFeeder`` placement over this process's host-local rows:
    ``local(block, index)`` checks that ``block`` holds this process's
    window of block ``index`` and hands on its feature shard's columns."""

    def __init__(self, runtime: "MultiHostMesh", padded_rows: Sequence[int], cols: slice):
        self.device = runtime.mesh.device
        self.runtime = runtime
        self.padded_rows = [int(m) for m in padded_rows]
        self.cols = cols

    def local(self, block, index: int):
        m = self.padded_rows[index]
        lo, hi = self.runtime.local_row_range(m)
        if block.shape[0] != hi - lo:
            raise ValueError(f"block[{index}]: host-local rows {block.shape[0]} != local range "
                             f"{hi - lo} of {m} padded rows")
        part = block[:, self.cols]
        self.runtime.feed_bytes += part.numel() * part.element_size() \
            if isinstance(part, torch.Tensor) else part.nbytes
        return part


class MultiHostMesh:
    """A mesh over every process of the world plus this process's place in
    the row layout (module docstring). ``mesh`` defaults to ``(world, 1)``
    over ``("data", "model")`` on ``device`` (``make_mesh``'s default:
    ``cuda:{local_rank % device_count}``; ``"cpu"`` for the CPU;
    ``make_mesh`` refuses a CPU mesh over NCCL). ``feed_bytes`` counts the
    bytes of every block ``block_placement`` handed to the device."""

    def __init__(self, mesh: Optional[Mesh] = None, *, sample_axes: Sequence[str] = ("data",),
                 feature_axis: str = "model", device=None):
        if mesh is None:
            mesh = make_mesh((dist.get_world_size(), 1), ("data", "model"), device=device)
        self.mesh = mesh
        self.sample_axes = tuple(sample_axes)
        self.feature_axis = feature_axis
        if set(mesh.axis_names) != set(self.sample_axes) | {feature_axis}:
            raise ValueError(f"mesh axes {mesh.axis_names} are not the sample axes "
                             f"{self.sample_axes} and the feature axis {feature_axis!r}")
        self.process_index = dist.get_rank()
        self.process_count = dist.get_world_size()
        self.n_data_shards = mesh.size(self.sample_axes)
        self.shard_lo = mesh.index(self.sample_axes)
        self.shard_hi = self.shard_lo + 1
        self.feed_bytes = 0

    def pad(self, n_rows: int) -> int:
        """Rows of padding that make ``n_rows`` divide the data shards."""
        return shard_rows(n_rows, self.n_data_shards, 0)[2] * self.n_data_shards - n_rows

    def local_row_range(self, n_rows_padded: int) -> Tuple[int, int]:
        """This process's ``[lo, hi)`` rows of a padded global row dimension
        (``launch.mesh.shard_rows``, the mesh plane's layout)."""
        if self.pad(n_rows_padded):
            raise ValueError(f"{n_rows_padded} rows do not divide {self.n_data_shards} sample "
                             "shards: pad first (see .pad())")
        return shard_rows(n_rows_padded, self.n_data_shards, self.shard_lo)[:2]

    def block_placement(self, padded_rows: Sequence[int], n_features: int) -> _HostPlacement:
        """A ``BlockFeeder`` placement for blocks that are this process's
        windows of global blocks of ``padded_rows`` rows each; it feeds the
        columns of this rank's ``model`` shard of ``n_features``."""
        M = self.mesh.size(self.feature_axis)
        if n_features % M:
            raise ValueError(f"{n_features} features do not split over {M} "
                             f"'{self.feature_axis}' shards")
        m, fl = self.mesh.index(self.feature_axis), n_features // M
        return _HostPlacement(self, padded_rows, slice(m * fl, (m + 1) * fl))

    def psum_hosts(self, vec, axes: Optional[Sequence[str]] = None) -> np.ndarray:
        """Exact int64 sum of one small integer vector per sample shard: one
        ``all_reduce`` over ``axes`` (default the sample axes, so each sample
        shard adds once; every mesh axis: each process once). Collective."""
        v = torch.as_tensor(np.asarray(vec, np.int64).ravel(), device=self.mesh.device)
        out = self.mesh.all_reduce(v, self.sample_axes if axes is None else tuple(axes))
        return out.cpu().numpy()

    def barrier(self) -> None:
        """Block until every process reaches this point."""
        self.mesh.barrier()

    def __repr__(self) -> str:
        return (f"MultiHostMesh(process {self.process_index} of {self.process_count}, sample "
                f"shard {self.shard_lo} of {self.n_data_shards}, {self.mesh!r})")


# ---------------------------------------------------------------------------
# Multi-process checkpoints: rank 0's manifest, per-host shard leaves
# ---------------------------------------------------------------------------


def _sub_manifest_name(pid: int) -> str:
    return f"shards.p{pid:02d}.json"


def _box(box) -> list:
    return [[int(lo), int(hi)] for lo, hi in box]


def save_checkpoint_multiproc(tree, directory: str, step: int, runtime: MultiHostMesh, *,
                              boxes: Optional[Boxes] = None) -> str:
    """Collective atomic save of one step. ``boxes[key] = (global_shape,
    box)`` marks a sharded leaf: this process's ``tree`` leaf holds the
    rows and columns ``box`` (``((lo, hi), ...)`` per dim) of a global
    array of ``global_shape``, and every process writes its own (listed
    in its sub-manifest). Every other leaf is replicated, written once by
    rank 0 beside the manifest. Barriers order create, write and rename:
    a reader never sees a torn step, and a crash leaves only a
    ``.tmp_save_*`` directory, which the manager removes."""
    boxes = boxes or {}
    pid = runtime.process_index
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f"{_TMP_PREFIX}step_{step:08d}")
    if pid == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    runtime.barrier()                                   # the tmp dir exists everywhere
    manifest = {"step": step, "topology": {"process_count": runtime.process_count}, "leaves": []}
    sub = {"process": pid, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        if key not in boxes and pid != 0:
            continue                                    # replicated: rank 0 writes it
        arr = _to_host(leaf)
        entry = {"key": key, "dtype": str(arr.dtype), "crc32": _crc32(arr)}
        if key in boxes:
            shape, box = boxes[key]
            fname = f"leaf_{i:05d}.p{pid:02d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            sub["leaves"].append(dict(entry, file=fname, shape=list(arr.shape), box=_box(box)))
            if pid == 0:
                manifest["leaves"].append({"key": key, "sharded": True, "dtype": str(arr.dtype),
                                           "shape": [int(s) for s in shape]})
        else:
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(dict(entry, file=fname, shape=list(arr.shape)))
    with open(os.path.join(tmp, _sub_manifest_name(pid)), "w") as f:
        json.dump(sub, f)
    if pid == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    runtime.barrier()                                   # every process is done writing
    if pid == 0:
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
    runtime.barrier()                                   # the step is visible everywhere
    return final


def _load_sub_manifest(path: str, pid: int) -> dict:
    try:
        with open(os.path.join(path, _sub_manifest_name(pid))) as f:
            sub = json.load(f)
        if not isinstance(sub, dict) or "leaves" not in sub:
            raise ValueError("shard manifest has no leaves")
        return sub
    except Exception as e:
        raise CheckpointCorruptionError(
            f"torn or unreadable shard manifest of process {pid} in {path}: {e}") from e


def _local_entries(path: str, runtime: MultiHostMesh, boxes: Boxes) -> Dict[str, dict]:
    """The manifest entry of every leaf this process restores (its own
    shard entries for the sharded ones). A step whose layout is not this
    process's raises ``CheckpointTopologyError`` before any leaf is read:
    another process count, a leaf this run shards that was saved whole,
    or a shard saved with another box."""
    manifest = _load_manifest(path)
    _check_topology(manifest, path)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    whole = [key for key in boxes if key in by_key and not by_key[key].get("sharded")]
    if whole:
        raise CheckpointTopologyError(f"leaves {whole} in {path} were saved whole, not as "
                                      "per-process shards: it is not a multi-process step")
    sub = _load_sub_manifest(path, runtime.process_index)
    mine = {e["key"]: e for e in sub["leaves"]}
    for key, (_, box) in boxes.items():
        got = mine.get(key, {}).get("box")
        if got is not None and got != _box(box):
            raise CheckpointTopologyError(
                f"sharded leaf {key!r} in {path} was saved with local box {got} but this "
                f"process's layout expects {_box(box)}: the mesh layout changed; resume on "
                "the saving topology")
    out = {}
    for key, entry in by_key.items():
        if entry.get("sharded"):
            if key not in mine:
                raise CheckpointCorruptionError(
                    f"sharded leaf {key!r} missing from process {runtime.process_index}'s "
                    f"shard manifest in {path}")
            entry = mine[key]
        out[key] = entry
    return out


def restore_checkpoint_multiproc(tree_like, directory: str, step: Optional[int] = None, *,
                                 runtime: MultiHostMesh, boxes: Optional[Boxes] = None,
                                 device=None, verify: bool = True):
    """Restore one step into the structure of ``tree_like``: replicated
    leaves from rank 0's files, sharded leaves (``boxes``, as at save) from
    this process's own, each CRC32-checked with ``verify``. Leaves come
    back as ``checkpoint.restore_checkpoint`` gives them (tensors on
    ``device``). Returns ``(tree, step)``. A changed process count or box
    raises ``CheckpointTopologyError``."""
    boxes = boxes or {}
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    entries = _local_entries(path, runtime, boxes)
    leaves = {}
    for key, like in _flatten(tree_like):
        entry = entries.get(key)
        if entry is None:
            raise CheckpointCorruptionError(f"leaf {key!r} missing from manifest in {path}")
        arr = _load_leaf(path, entry) if verify else np.load(os.path.join(path, entry["file"]))
        leaves[key] = _from_host(arr, like, device)
    return _unflatten(tree_like, leaves), step


def restore_latest_valid_multiproc(tree_like, directory: str, *, runtime: MultiHostMesh,
                                   boxes: Optional[Boxes] = None, device=None):
    """Collective ``restore_latest_valid``: every process verifies its own
    leaves of each step, newest first, and the verdicts are summed over
    every process (``psum_hosts``), so all restore the same step; one
    host's corrupt shard walks every process back. A topology mismatch on
    any process raises ``CheckpointTopologyError`` on all of them (it
    applies to every step). Returns ``(tree, step)``, or None when no
    step verifies everywhere."""
    boxes = boxes or {}
    every_axis = runtime.mesh.axis_names
    for step in reversed(list_steps(directory)):
        path = os.path.join(directory, f"step_{step:08d}")
        ok, moved, why = 1, 0, None
        try:
            entries = _local_entries(path, runtime, boxes)
            for entry in entries.values():
                _load_leaf(path, entry)
        except CheckpointTopologyError as e:
            moved, why = 1, e
        except (CheckpointCorruptionError, OSError, ValueError, KeyError):
            ok = 0
        agree, moved_any = runtime.psum_hosts([ok, moved], axes=every_axis)
        if moved_any:
            raise why or CheckpointTopologyError(
                f"checkpoint step {step} in {directory} does not fit another process's layout")
        if agree == runtime.process_count:
            return restore_checkpoint_multiproc(tree_like, directory, step, runtime=runtime,
                                                boxes=boxes, device=device, verify=False)
        warnings.warn(f"skipping checkpoint step {step} in {directory}: only {agree} of "
                      f"{runtime.process_count} processes verified it", RuntimeWarning,
                      stacklevel=2)
    return None


class MultiprocCheckpointManager(CheckpointManager):
    """Rotating multi-process checkpoints: ``checkpoint.CheckpointManager``
    whose save is collective (``save_checkpoint_multiproc``, ``boxes=``
    through ``maybe_save``) and whose orphan and old-step removal rank 0
    does, followed by a barrier. Runs resume through
    ``restore_latest_valid_multiproc`` (the drivers' ``resume_from``;
    ``restore_latest_valid`` here)."""

    def __init__(self, directory: str, keep: int = 3, save_interval: int = 100, *,
                 runtime: MultiHostMesh):
        self.runtime = runtime
        super().__init__(directory, keep, save_interval)
        runtime.barrier()

    def _remove_orphans(self):
        if self.runtime.process_index == 0:
            super()._remove_orphans()

    def _save(self, tree, step: int, *, boxes: Optional[Boxes] = None) -> str:
        return save_checkpoint_multiproc(tree, self.directory, step, self.runtime, boxes=boxes)

    def _gc(self):
        if self.runtime.process_index == 0:
            super()._gc()
        self.runtime.barrier()

    def restore_latest(self, tree_like, *, boxes: Optional[Boxes] = None, device=None):
        return restore_checkpoint_multiproc(tree_like, self.directory, runtime=self.runtime,
                                            boxes=boxes, device=device)

    def restore_latest_valid(self, tree_like, *, boxes: Optional[Boxes] = None, device=None):
        """Collective: the newest step every process verifies, as ``(tree,
        step)``; raises ``FileNotFoundError`` when there is none."""
        out = restore_latest_valid_multiproc(tree_like, self.directory, runtime=self.runtime,
                                             boxes=boxes, device=device)
        if out is None:
            raise FileNotFoundError(f"no valid checkpoint in {self.directory}")
        return out
