"""Checkpointing with verified restore (fault-tolerance substrate).

Counterpart of ``repro/checkpoint/checkpoint.py``. Format: one ``.npy``
file per leaf inside a step directory, plus ``manifest.json`` holding
each leaf's key, file, dtype, shape **and CRC32**. The reference writes
the same fields with msgpack; the port writes JSON, so it needs nothing
beyond the standard library and numpy (it does not read the reference's
msgpack manifests). Writes go to a temp dir that is atomically renamed:
a crash mid-save never corrupts the latest checkpoint.

Restore is *verified*: leaves are CRC / shape / dtype-checked against
the manifest before they are trusted (a byte-flipped checkpoint raises
:class:`CheckpointCorruptionError` instead of restoring garbage), then
put on the device the caller names, or where ``placement`` puts each
leaf (a mesh rank takes its rows of a global slot table).
``restore_latest_valid`` walks back past corrupt or torn steps to the
newest verifiable one; the resume paths of every growth driver use it.
A step saved with ``layout="global"`` (the mesh drivers: sharded leaves
gathered, one writer) holds whole arrays and restores under any process
count and mesh shape.

Leaves are keyed as the reference's ``jax.tree_util`` paths key them
(``_flatten``), so the port's growth carries are saved under the
reference's keys: a dataclass by its ``FIELDS`` (or field) index, a
dict by sorted key, a list or tuple by index, a NamedTuple by
``.name``; ``None`` holds no leaf; a Python ``int`` is a 0-d int32 leaf.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import warnings
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_PREFIX = ".tmp_save_"
_MANIFEST = "manifest.json"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity verification: CRC mismatch,
    shape/dtype drift, a missing or unreadable leaf file, or a torn
    manifest. Raised *before* any corrupt bytes are deserialized into a
    training state."""


class CheckpointTopologyError(RuntimeError):
    """A checkpoint was written by a different process topology than the
    one restoring it. Deliberately NOT a :class:`CheckpointCorruptionError`:
    ``restore_latest_valid`` walks back past *corrupt* steps, but a
    topology mismatch applies to every step in the directory, so this
    propagates instead. Resume on the topology that saved, or start fresh
    with a new checkpoint directory."""


def _process_count() -> int:
    """World size of the initialised process group, else 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _check_topology(manifest: dict, path: str) -> None:
    """Refuse to restore across a changed process count. Single-process
    manifests carry no ``topology`` key and imply one process; a global
    step (``layout="global"``) restores under any."""
    if manifest.get("topology", {}).get("layout") == "global":
        return
    saved = manifest.get("topology", {}).get("process_count", 1)
    now = _process_count()
    if int(saved) != now:
        raise CheckpointTopologyError(
            f"checkpoint {path} was saved by {saved} process(es) but this "
            f"runtime has {now} — per-host shard leaves do not transfer "
            "across process counts; resume on the saving topology or start "
            "a fresh checkpoint directory"
        )


def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray, int))


def _field_names(node) -> List[Optional[str]]:
    """A dataclass's leaf fields by index (``FIELDS``, where ``None`` keeps
    an index empty), else all its fields."""
    return getattr(type(node), "FIELDS", None) or [f.name for f in dataclasses.fields(node)]


def _children(node) -> List[Tuple[str, Any]]:
    """(key, child) pairs of one container, in the reference's order."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(str(i), getattr(node, n)) for i, n in enumerate(_field_names(node)) if n is not None]
    if isinstance(node, tuple) and hasattr(node, "_fields"):         # NamedTuple
        return [(f".{n}", getattr(node, n)) for n in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` in the reference's leaf order and key spelling."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += _flatten(child, f"{prefix}/{key}" if prefix else key)
    return out


def _unflatten(tree, leaves: dict, prefix: str = ""):
    """``tree`` with every leaf replaced by ``leaves[key]``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return leaves[prefix]
    new = {key: _unflatten(child, leaves, f"{prefix}/{key}" if prefix else key)
           for key, child in _children(tree)}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{n: new[str(i)] for i, n in enumerate(_field_names(tree)) if n is not None})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(new[f".{n}"] for n in tree._fields))
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    return type(tree)(new[str(i)] for i in range(len(tree)))


def _to_host(leaf) -> np.ndarray:
    """One leaf as the numpy array it is saved as (a device copy for a tensor;
    bfloat16, which numpy lacks, as its bits in int16)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return (leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf).cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _from_host(arr: np.ndarray, like, device, placed=None):
    """A restored array in the form of its template leaf: ``placed`` when
    the caller's placement gave one, else a tensor on ``device`` (None: the
    template's device), an int, or a numpy array."""
    if placed is not None:
        return placed
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)
        if like.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        return t.to(like.device if device is None else device)
    if isinstance(like, int):
        return int(arr)
    return arr


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of an array's raw bytes (C-contiguous canonical form)."""
    return zlib.crc32(np.ascontiguousarray(arr).data)


def save_checkpoint(
    tree, directory: str, step: int,
    *,
    fault_hook: Optional[Callable[[str], None]] = None,
    layout: Optional[str] = None,
) -> str:
    """Atomic save with a checksummed manifest. Returns the final path.

    ``fault_hook`` is a deterministic chaos hook (see
    ``launch.fault.FaultInjector``) called at ``"leaf[i]"`` before each
    leaf write and at ``"pre_rename"`` between the complete tmp write
    and the atomic rename (the torn-write window). ``layout="global"``
    marks a step of whole arrays written by one rank for a whole mesh.
    """
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=_TMP_PREFIX)
    manifest = {"step": step, "leaves": []}
    if layout == "global":
        manifest["topology"] = {"layout": "global", "process_count": _process_count()}
    elif _process_count() > 1:
        manifest["topology"] = {"process_count": _process_count()}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        if fault_hook is not None:
            fault_hook(f"leaf[{i}]")
        arr = _to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "key": key, "file": fname, "dtype": str(arr.dtype),
            "shape": list(arr.shape), "crc32": _crc32(arr),
        })
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if fault_hook is not None:
        fault_hook("pre_rename")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_steps(directory: str) -> List[int]:
    """All step numbers in ``directory``, ascending. Stray files, orphaned
    ``.tmp_save_*`` dirs and any other non-``step_NNNNNNNN`` entries are
    ignored."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and os.path.isdir(os.path.join(directory, d)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _load_manifest(path: str) -> dict:
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        if not isinstance(manifest, dict) or "leaves" not in manifest:
            raise ValueError("manifest has no leaves")
        return manifest
    except Exception as e:
        raise CheckpointCorruptionError(
            f"torn or unreadable manifest in {path}: {e}"
        ) from e


def _load_leaf(path: str, entry: dict) -> np.ndarray:
    """Load + verify one leaf against its manifest entry."""
    fname = entry["file"]
    try:
        arr = np.load(os.path.join(path, fname))
    except Exception as e:
        raise CheckpointCorruptionError(
            f"leaf {entry['key']!r} ({fname}) in {path} is missing or "
            f"unreadable: {e}"
        ) from e
    if list(arr.shape) != list(entry["shape"]) or str(arr.dtype) != entry["dtype"]:
        raise CheckpointCorruptionError(
            f"leaf {entry['key']!r} ({fname}) in {path} drifted: manifest "
            f"says {entry['dtype']}{entry['shape']}, file holds "
            f"{arr.dtype}{list(arr.shape)}"
        )
    want = entry.get("crc32")          # a manifest without CRCs skips the check
    if want is not None and _crc32(arr) != want:
        raise CheckpointCorruptionError(
            f"leaf {entry['key']!r} ({fname}) in {path} failed its CRC32 "
            f"check — the checkpoint is corrupt"
        )
    return arr


def verify_checkpoint(directory: str, step: int) -> None:
    """Verify every leaf of one step against its manifest (CRC + shape +
    dtype) without building a tree. Raises
    :class:`CheckpointCorruptionError` on the first failure."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = _load_manifest(path)
    _check_topology(manifest, path)
    for entry in manifest["leaves"]:
        _load_leaf(path, entry)


def restore_checkpoint(
    tree_like, directory: str, step: Optional[int] = None,
    *, device=None, verify: bool = True, placement=None,
):
    """Restore into the structure of ``tree_like`` (values ignored).
    Returns ``(tree, step)``.

    Each leaf comes back in its template leaf's form: a tensor on
    ``device`` (``None``: on the template tensor's own device), an int,
    or a numpy array. ``placement(key, array, like)``, when given, is
    asked first for every leaf and may return the leaf to use (a mesh
    rank's slice of a global array on its device), or None for the
    default (the reference's ``shardings``). With ``verify`` (the default) every leaf is checked
    against the manifest's CRC32 / shape / dtype before it is used; a
    failed check raises :class:`CheckpointCorruptionError` (use
    ``restore_latest_valid`` to fall back past corrupt steps).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = _load_manifest(path)
    _check_topology(manifest, path)

    by_key = {e["key"]: e for e in manifest["leaves"]}
    leaves = {}
    for key, like in _flatten(tree_like):
        entry = by_key.get(key)
        if entry is None:
            raise CheckpointCorruptionError(
                f"leaf {key!r} missing from manifest in {path}"
            )
        arr = _load_leaf(path, entry) if verify else np.load(os.path.join(path, entry["file"]))
        leaves[key] = _from_host(arr, like, device,
                                 None if placement is None else placement(key, arr, like))
    return _unflatten(tree_like, leaves), step


def restore_latest_valid(
    tree_like, directory: str,
    *,
    device=None,
    on_skip: Optional[Callable[[int, Exception], None]] = None,
    placement=None,
) -> Optional[Tuple[Any, int]]:
    """Restore the newest *verifiable* checkpoint, walking back past
    corrupt or torn steps.

    Steps are tried newest-first; one that fails verification is skipped
    with a ``RuntimeWarning`` (and ``on_skip(step, error)``, if given)
    and the next older step is tried. Returns ``(tree, step)`` of the
    first valid one, or ``None`` when the directory holds no restorable
    checkpoint at all: the resume paths treat that like an empty
    directory (a fresh start).
    """
    for step in reversed(list_steps(directory)):
        try:
            return restore_checkpoint(tree_like, directory, step, device=device, verify=True,
                                      placement=placement)
        except (CheckpointCorruptionError, OSError, ValueError, KeyError) as e:
            if on_skip is not None:
                on_skip(step, e)
            warnings.warn(
                f"skipping corrupt checkpoint step {step} in {directory}: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
    return None


class CheckpointManager:
    """Rotating checkpoints + resume: the training loop's fault-tolerance
    interface.

    Init garbage-collects orphaned ``.tmp_save_*`` dirs left behind by a
    save killed between its tmp write and the atomic rename.
    ``maybe_save`` saves every ``save_interval`` steps and keeps the
    newest ``keep``. ``fault_hook`` forwards to :func:`save_checkpoint`.
    """

    def __init__(
        self, directory: str, keep: int = 3, save_interval: int = 100,
        *,
        fault_hook: Optional[Callable[[str], None]] = None,
    ):
        self.directory = directory
        self.keep = keep
        self.save_interval = save_interval
        self.fault_hook = fault_hook
        self._remove_orphans()

    def _remove_orphans(self):
        if os.path.isdir(self.directory):
            for d in os.listdir(self.directory):
                if d.startswith(_TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def maybe_save(self, tree, step: int, **save_kw) -> Optional[str]:
        """Save ``tree`` as ``step`` when ``save_interval`` divides it, then
        drop all but the newest ``keep`` steps. ``save_kw`` goes to the
        save (here ``layout``)."""
        if step % self.save_interval != 0:
            return None
        path = self._save(tree, step, **save_kw)
        self._gc()
        return path

    def _save(self, tree, step: int, *, layout: Optional[str] = None) -> str:
        return save_checkpoint(tree, self.directory, step, fault_hook=self.fault_hook,
                               layout=layout)

    def _gc(self):
        for s in list_steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

    def restore_latest(self, tree_like, *, device=None):
        return restore_checkpoint(tree_like, self.directory, device=device)

    def restore_latest_valid(self, tree_like, *, device=None):
        """Newest verifiable checkpoint as ``(tree, step)``; corrupt or
        torn steps are skipped. Raises ``FileNotFoundError`` when no step
        verifies."""
        out = restore_latest_valid(tree_like, self.directory, device=device)
        if out is None:
            raise FileNotFoundError(f"no valid checkpoint in {self.directory}")
        return out
