"""The device mesh of the vertical-partition plane, over ``torch.distributed``
(counterpart of ``repro/launch/mesh.py``).

One process per mesh position (SPMD). ``make_mesh(shape, axes)`` lays the
initialised process group out as a row-major grid with named axes
(``"data"``, ``"model"``) through ``init_device_mesh``: this rank's
coordinates, a process group per axis (``DeviceMesh.get_group``) and one
per set of axes (the whole world for all of them; ``new_group`` for the
others, made here so every rank makes them in the same order). Each rank
runs on ``cuda:{local_rank % device_count}`` unless ``device="cpu"`` asks
for the CPU.

The mesh carries the plane's collectives (``all_reduce``,
``reduce_scatter``, ``all_gather``, ``barrier``; ``all_to_all`` for the
expert-parallel MoE, differentiable), and their transport is
chosen here, once, from the process group's backend: NCCL takes device
tensors; gloo takes CUDA tensors only for ``all_reduce`` and
``broadcast``, so on gloo a CUDA tensor is copied to the host, reduced
there and copied back (``host_staged``). Several ranks can then share one
card, which NCCL refuses ("Duplicate GPU detected").

``run_world`` starts a world of ``nproc`` ranks as processes on this
host (``python -m repro_torch.launch.mesh``), each calling one function,
with a wall-clock limit so that a deadlock fails instead of hanging;
``default_backend`` is the one choice between NCCL and gloo.

``make_production_mesh`` lays out the production meshes, 16 x 16
(``data``, ``model``) or 2 x 16 x 16 (``pod``, ``data``, ``model``), over a
world of 256 or 512. ``init_fake_world`` starts such a world in this one
process on torch's fake process group (no peers: its collectives do
nothing), on which the dry run (``launch/dryrun.py``) runs a step on fake
tensors and counts what one device would do.
"""
from __future__ import annotations

import datetime
import importlib
import itertools
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """This rank's view of a named process grid (``make_mesh``)."""

    def __init__(self, device_mesh, device: torch.device, groups: Dict[Tuple[str, ...], object]):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.coords: Dict[str, int] = dict(zip(self.axis_names, device_mesh.get_coordinate()))
        self._groups = groups
        self.backend = dist.get_backend()
        # the one place the transport is chosen: gloo reduces CUDA tensors on the host
        self.host_staged = self.backend == "gloo" and device.type == "cuda"
        self.staged_bytes = 0           # the largest tensor staged through the host so far
        self.all_to_all_calls = 0       # exchanges made by ``all_to_all`` (the expert-parallel MoE)

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def size(self, axes: Axes) -> int:
        """Ranks along ``axes`` (``_axis_size``)."""
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes: Axes) -> int:
        """This rank's row-major index over ``axes``, taken in the mesh's
        axis order (``_multi_axis_index``): its position in a gather over them."""
        i = 0
        for a in self.axis_names:
            if a in _axes(axes):
                i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Axes):
        return self._groups[tuple(a for a in self.axis_names if a in _axes(axes))]

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        if self.host_staged and t.is_cuda:
            self.staged_bytes = max(self.staged_bytes, t.numel() * t.element_size())
            return t.cpu()
        return t.contiguous()

    def all_reduce(self, t: torch.Tensor, axes: Axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Sum (``op``) of ``t`` over ``axes``, a new tensor on ``t``'s device
        (``psum``)."""
        h = self._stage(t)
        h = h.clone() if h is t else h
        dist.all_reduce(h, op=op, group=self.group(axes))
        return h.to(t.device)

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over ``axis`` of ``t``, scattered along dim 0 in tiles:
        this rank keeps rows ``[i * m, (i + 1) * m)``, ``i`` its index on
        ``axis``, ``m = t.shape[0] / size(axis)`` (``psum_scatter``)."""
        n = self.size(axis)
        if t.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim 0 of {tuple(t.shape)} does not split {n} ways")
        h = self._stage(t)
        out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]), dtype=t.dtype, device=h.device)
        dist.reduce_scatter_tensor(out, h, group=self.group(axis))
        return out.to(t.device)

    def all_gather(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``[size(axes), *t.shape]``: every rank's ``t`` along ``axes``, in
        the order of ``index(axes)``."""
        h = self._stage(t).reshape(-1)
        out = torch.empty(self.size(axes) * h.numel(), dtype=t.dtype, device=h.device)
        dist.all_gather_into_tensor(out, h, group=self.group(axes))
        return out.view((self.size(axes),) + tuple(t.shape)).to(t.device)

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` [size(axis), ...]: slice ``j`` goes to the rank at index ``j``
        on ``axis``, and slice ``j`` of the result is what that rank sent
        here (``all_to_all`` with ``split_axis = concat_axis = 0``, untiled).
        Differentiable (the backward is the reverse exchange); counted in
        ``all_to_all_calls``."""
        from torch.distributed._functional_collectives import all_to_all_single_autograd

        n = self.size(axis)
        if t.shape[0] != n:
            raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} is not the {n} ranks of {axis!r}")
        self.all_to_all_calls += 1
        h = self._stage(t)
        out = all_to_all_single_autograd(h, None, None, self.group(axis))
        return out.to(t.device)

    def barrier(self) -> None:
        dist.barrier()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device}, "
                f"{self.backend}{', host-staged' if self.host_staged else ''})")


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the mesh on the CPU"
        )
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(shape: Sequence[int], axes: Sequence[str] = ("data", "model"), *,
              device=None) -> Mesh:
    """A ``Mesh`` over the initialised default process group, whose world
    size must be ``prod(shape)``. ``device``: this rank's device (default
    ``cuda:{local_rank % device_count}``; ``"cpu"`` for the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size() or len(shape) != len(axes):
        raise ValueError(f"mesh {shape} over axes {axes} does not cover a world of "
                         f"{dist.get_world_size()}")
    dev = torch.device(device) if device is not None else None
    if dev is None or (dev.type == "cuda" and dev.index is None):
        dev = _default_device()
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(f"a mesh on {dev} needs a gloo process group: NCCL reduces CUDA "
                         "tensors only")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    groups = {(a,): dm.get_group(a) for a in axes}
    groups[axes] = dist.group.WORLD
    coords = list(itertools.product(*(range(s) for s in shape)))      # rank -> coordinates
    for r in range(2, len(axes)):                 # proper subsets of two or more axes
        for sub in itertools.combinations(range(len(axes)), r):
            cosets: Dict[tuple, list] = {}
            for rank, c in enumerate(coords):
                cosets.setdefault(tuple(c[d] for d in range(len(axes)) if d not in sub),
                                  []).append(rank)
            for key in sorted(cosets):            # every rank makes every group, in one order
                g = dist.new_group(cosets[key])
                if dist.get_rank() in cosets[key]:
                    groups[tuple(axes[d] for d in sub)] = g
    return Mesh(dm, dev, groups)


PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The 16 x 16 (``data``, ``model``) mesh, or with ``multi_pod`` the 2 x 16
    x 16 (``pod``, ``data``, ``model``) one, over the initialised world
    (the reference's ``make_production_mesh``); raises ``ValueError`` unless
    the world has 256 or 512 ranks to match. ``device``: as ``make_mesh``'s
    (``"cpu"`` for the dry run's fake world)."""
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh needs a world of {n} ranks, "
                         f"got {world or 'none'}")
    return make_mesh(shape, axes, device=device)


def init_fake_world(world_size: int) -> None:
    """Initialise this process as rank 0 of a world of ``world_size`` on
    torch's fake process group (``torch.testing._internal.distributed.fake_pg``):
    every collective returns at once and moves nothing, so one process can
    lay out a mesh of any size and run a step on fake tensors. Replaces a
    fake world already initialised; call ``dist.destroy_process_group()`` to
    end it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised in this process")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The sample (data-parallel) axes: every axis but ``"model"``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def shard_rows(n_rows: int, n_shards: int, shard: int) -> Tuple[int, int, int]:
    """``(lo, hi, n_local)``: sample shard ``shard``'s rows of ``n_rows``
    padded to a multiple of ``n_shards``, and how many rows each shard
    holds. The one row layout of the mesh plane and the multi-process
    plane: the pad rows are the last shards' tail."""
    nl = -(-n_rows // n_shards)
    return shard * nl, (shard + 1) * nl, nl


# ---------------------------------------------------------------------------
# Worlds of processes on this host
# ---------------------------------------------------------------------------


def default_backend(local_processes: int, device_type: str = "cuda") -> str:
    """NCCL when every process on this host has a card of its own, else
    gloo (the CPU, or several processes sharing a card, which NCCL
    refuses; ``Mesh.host_staged`` then stages the collectives)."""
    if device_type == "cuda" and torch.cuda.is_available() \
            and torch.cuda.device_count() >= local_processes:
        return "nccl"
    return "gloo"


def init_rank(rank: int, world_size: int, init_method: str, backend: str = "gloo", *,
              timeout_s: float = 120.0) -> None:
    """``init_process_group`` for one rank, with a timeout on every
    collective (a peer that died fails the call instead of hanging it)."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


class WorldError(RuntimeError):
    """A rank of ``run_world`` failed, or the world ran past its limit."""


def run_world(target: str, nproc: int, *, args: tuple = (), backend: str = "gloo",
              timeout_s: float = 300.0, collective_timeout_s: float = 60.0,
              threads: int = 1, env: Optional[dict] = None) -> list:
    """Run ``module:function(*args)`` in each of ``nproc`` new processes,
    ranks 0..nproc-1 of one ``torch.distributed`` world (``backend``;
    a ``FileStore`` rendezvous in a temporary directory), and return the
    ranks' results in rank order. ``args`` and results are pickled.

    Each rank sets ``LOCAL_RANK``, ``torch.set_num_threads(threads)`` and
    a ``collective_timeout_s`` on its collectives. The world is killed
    when any rank fails or when ``timeout_s`` passes: ``WorldError``
    names the rank and ends with its output (shown only then). The
    children get this process's ``sys.path`` as ``PYTHONPATH``."""
    with tempfile.TemporaryDirectory(prefix="prf_world_") as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        path = [p for p in sys.path if p] + os.environ.get("PYTHONPATH", "").split(os.pathsep)
        base_env = dict(os.environ, **(env or {}),
                        PYTHONPATH=os.pathsep.join(p for p in path if p),
                        OMP_NUM_THREADS=str(threads))
        procs, logs = [], []
        for r in range(nproc):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.mesh", tmp, str(r), str(nproc), backend,
                 target, str(threads), str(collective_timeout_s)],
                env=dict(base_env, LOCAL_RANK=str(r)), stdout=log, stderr=subprocess.STDOUT,
            ))
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = (bad[0], f"exit code {codes[bad[0]]}")
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = (next(r for r, c in enumerate(codes) if c is None),
                              f"no result within {timeout_s} s")
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if failed is not None:
            r, why = failed
            logs[r].seek(0)
            tail = logs[r].read()[-6000:]
            for log in logs:
                log.close()
            raise WorldError(f"rank {r} of {nproc} ({target}): {why}\n{tail}")
        out = []
        for r in range(nproc):
            logs[r].close()
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(argv: Sequence[str]) -> None:
    tmp, rank, nproc, backend, target, threads, coll_timeout = argv
    rank, nproc = int(rank), int(nproc)
    torch.set_num_threads(int(threads))
    init_rank(rank, nproc, f"file://{os.path.join(tmp, 'store')}", backend,
              timeout_s=float(coll_timeout))
    try:
        module, name = target.split(":")
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        result = getattr(importlib.import_module(module), name)(*args)
        with open(os.path.join(tmp, f"result{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(tmp, f"result{rank}.pkl.tmp"), os.path.join(tmp, f"result{rank}.pkl"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
