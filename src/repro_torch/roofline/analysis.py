"""Roofline terms of a step on a mesh, counted per device (no card needed).

Counterpart of ``repro/roofline/analysis.py``. The reference parses the
post-SPMD HLO of a compiled step, in which every shape is one device's.
Here the step runs eagerly on DTensors whose local shards are fake tensors
(``FakeTensorMode`` over a fake process group: no memory, no data, no
card), and ``count`` reads what each op does to this rank's shards:

* FLOPs: the matrix products only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; the reference counts ``dot``s), 2 x m x n x k each, on the
  local shards. DTensor dispatches an op at its global shape and then runs
  it on the local shards, and both calls pass through a dispatch mode:
  ``FlopCounterMode`` counts the global one (a sharded product's whole
  FLOPs), so ``DeviceCounter`` lets DTensor's calls through (returning
  ``NotImplemented``) and counts only the ops on plain tensors, skipping
  the global-shape calls DTensor makes to infer output shapes. Compute that
  a rank repeats because its inputs are replicated counts on every rank.
* Bytes: operand plus result bytes of every local op that is not a view
  (the reference sums them per HLO instruction after fusion; eager ops are
  not fused, so this count is larger than a compiled step's traffic).
* Collectives: each functional collective DTensor issues, by kind (``count``,
  ``operand_bytes``, ``result_bytes``), its count checked against
  ``CommDebugMode``'s; wire bytes by the reference's ring model
  (``wire_bytes``).
* Memory: ``MemTracker``'s peak of this rank's live tensors.

``HW`` holds one H100 SXM's rates: 989e12 dense bf16 FLOP/s and 3.35e12 B/s
of HBM3 (NVIDIA H100 datasheet, SXM5), 80 GiB of HBM. The collective term
uses one link rate per device, 50e9 B/s: both production meshes (256 and
512 devices) span many 8-GPU nodes, so a 16-wide axis leaves NVLink, and a
DGX H100 node gives each GPU one 400 Gb/s (50 GB/s) ConnectX-7 port to the
cluster's InfiniBand fabric (NVIDIA DGX H100 datasheet).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s, dense
    "hbm_bw": 3.35e12,           # B/s
    "link_bw": 50e9,             # B/s per device, inter-node (InfiniBand NDR, one port a GPU)
    "hbm_bytes": 80 * 2 ** 30,   # capacity
}

aten = torch.ops.aten
_MATMULS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
_COLLECTIVE_KINDS = {              # op name (no namespace, no overload) -> the reference's kind
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_NO_BYTES = {"detach", "alias", "lift_fresh", "_local_scalar_dense", "empty", "empty_strided",
             "empty_like", "wait_tensor", "set_", "resize_"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class DeviceCounter(TorchDispatchMode):
    """Counts one rank's local ops (see the module note): ``flops``,
    ``bytes_accessed``, ``collectives`` {kind: {count, operand_bytes,
    result_bytes}}."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self._inferring = 0            # inside DTensor's global-shape inference

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor redispatches on the local shards
        out = func(*args, **kwargs)
        if self._inferring:
            return out
        packet = func.overloadpacket
        name = packet.__name__
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is not None:
            e = self.collectives.setdefault(kind, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
            e["count"] += 1
            e["operand_bytes"] += _nbytes((args, kwargs))
            e["result_bytes"] += _nbytes(out)
            return out
        if packet in _MATMULS:
            from torch.utils.flop_counter import flop_registry

            self.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_BYTES:
            self.bytes_accessed += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    @contextlib.contextmanager
    def _skip_shape_inference(self):
        """Marks DTensor's global-shape inference (its sharding propagator
        runs the op on fake tensors of the global shapes) so it is not counted."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = next(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                    if hasattr(ShardingPropagator, n))
        orig = getattr(ShardingPropagator, name)
        counter = self

        def wrapped(self_, *a, **k):
            counter._inferring += 1
            try:
                return orig(self_, *a, **k)
            finally:
                counter._inferring -= 1

        setattr(ShardingPropagator, name, wrapped)
        try:
            yield
        finally:
            setattr(ShardingPropagator, name, orig)


def _local_mem_tracker(counter: DeviceCounter):
    """A ``MemTracker`` that also skips the allocations of DTensor's
    global-shape inference (``counter`` marks them): under an outer
    ``FakeTensorMode`` they run in that same mode, which ``MemTracker``'s own
    test for them does not tell apart."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if counter._inferring and not any(issubclass(t, DTensor) for t in types):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def wire_bytes(colls: Dict[str, Dict[str, float]]) -> float:
    """Ring-model per-device wire bytes (the reference's): an all-reduce
    moves ~2x its operand, an all-gather ~ its result, the others ~ their
    operand; the (n-1)/n factor dropped."""
    wire = 0.0
    for kind, e in colls.items():
        if kind == "all-gather":
            wire += e["result_bytes"]
        elif kind == "all-reduce":
            wire += 2.0 * e["operand_bytes"]
        else:
            wire += e["operand_bytes"]
    return wire


def count(fn: Callable[[], Any], *, external=(), repeat: int = 1) -> Dict[str, Any]:
    """Runs ``fn()`` once under ``DeviceCounter``, ``CommDebugMode`` and
    ``MemTracker`` (``external``: modules and tensors that live across the
    call, the state) and returns the reference's fields, per device:
    ``flops``, ``bytes_accessed``, ``collective_bytes``, ``collectives``
    (each times ``repeat``: a loop body run once and counted as many times
    as the loop runs) and ``memory`` {"peak_bytes"}. Raises if the
    collectives seen disagree with ``CommDebugMode``'s count."""
    from torch.distributed.tensor.debug import CommDebugMode

    counter, comm = DeviceCounter(), CommDebugMode()
    mem = _local_mem_tracker(counter)
    if external:
        mem.track_external(*external)
    with counter._skip_shape_inference(), mem, comm, counter:
        fn()
    seen = sum(e["count"] for e in counter.collectives.values())
    want = comm.get_total_counts()
    if seen != want:
        raise RuntimeError(f"collectives: {seen} counted, CommDebugMode saw {want} "
                           f"({comm.get_comm_counts()})")
    colls = {k: {kk: vv * repeat for kk, vv in e.items()} for k, e in counter.collectives.items()}
    peak = mem.get_tracker_snapshot("peak")
    return {
        "flops": counter.flops * repeat,
        "bytes_accessed": counter.bytes_accessed * repeat,
        "collective_bytes": wire_bytes(colls),
        "collectives": colls,
        "memory": {"peak_bytes": int(max((d.get("Total", 0) for d in peak.values()), default=0))},
    }


def combine(*analyses: Dict[str, Any]) -> Dict[str, Any]:
    """The sum of several ``count`` results (one step's phases); memory is
    the largest peak."""
    out = {"flops": 0.0, "bytes_accessed": 0.0, "collective_bytes": 0.0, "collectives": {},
           "memory": {"peak_bytes": 0}}
    for a in analyses:
        for k in ("flops", "bytes_accessed", "collective_bytes"):
            out[k] += a[k]
        for kind, e in a["collectives"].items():
            t = out["collectives"].setdefault(kind, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
            for kk, vv in e.items():
                t[kk] += vv
        out["memory"]["peak_bytes"] = max(out["memory"]["peak_bytes"], a["memory"]["peak_bytes"])
    return out


def roofline_terms(analysis: Dict[str, Any], *, model_flops_per_device: float,
                   hw: Dict[str, float] = HW) -> Dict[str, Any]:
    """The reference's three terms (seconds per device) and their summary."""
    compute_s = analysis["flops"] / hw["peak_flops_bf16"]
    memory_s = analysis["bytes_accessed"] / hw["hbm_bw"]
    coll_s = analysis["collective_bytes"] / hw["link_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    model_s = model_flops_per_device / hw["peak_flops_bf16"]
    return {
        **terms,
        "dominant": dominant,
        "model_flops_per_device": model_flops_per_device,
        "model_compute_s": model_s,
        "useful_flops_ratio": (
            model_flops_per_device / analysis["flops"] if analysis["flops"] else 0.0
        ),
        "roofline_fraction": model_s / max(terms.values()) if max(terms.values()) else 0.0,
    }
