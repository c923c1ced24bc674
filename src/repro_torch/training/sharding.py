"""Parameter sharding rules: FSDP (``data``) x TP (``model``) x pure DP (``pod``).

Counterpart of ``repro/training/sharding.py`` (``param_spec``,
``param_specs``, ``param_shardings``, ``opt_state_specs``). A spec is a
``P``: one entry per tensor dim, each ``None``, a mesh axis name or a tuple
of axis names (the reference's ``PartitionSpec``, without ``jax``). Every
rule is validated against the dim sizes: an axis is assigned only to a dim
it divides, so the GQA case (kv heads < tp) stays replicated.

The port's leaves are per layer (``layers.3.attn.wq``, the state dict's
names; ``convert._flat_lm`` maps them to the reference's paths) where the
reference stacks a stage's layers on a leading, never sharded axis: a
port spec is the reference's without that leading ``None``.

``param_shardings`` turns specs into DTensor placements on a mesh's
``DeviceMesh``: an axis, or a tuple of axes (taken in mesh order), becomes
``Shard(dim)`` on each of those mesh dims; every other mesh dim is
``Replicate()``. ``distribute`` places a tree of tensors by such placements.

A mesh here is anything with ``axis_names`` and a ``shape`` mapping axis ->
size (``launch.mesh.Mesh``, or a stand-in for a mesh that is never built).
``cache_specs`` places a model's serving caches (``Model.cache_struct``'s
list of per-layer dicts) by the reference's rules, leaf by leaf by name,
without its group axis; ``cache_shardings`` gives their placements.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``; ``P()`` is
    replicated. Equal to the plain tuple of its entries; a one-axis tuple
    entry is stored as the axis, as ``PartitionSpec`` stores it."""

    def __new__(cls, *entries: Axis):
        def norm(e):
            if isinstance(e, (list, tuple)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_sizes(mesh) -> Dict[str, int]:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in mesh.axis_names}
    return dict(zip(mesh.axis_names, (int(s) for s in shape)))


def _fits(size: int, dim: int) -> bool:
    return dim % size == 0 and dim >= size


def param_spec(path: str, shape: Sequence[int], mesh, *, fsdp=None, tp: str = "model",
               uneven_heads: bool = False, fsdp_tables_only: bool = False) -> P:
    """The ``P`` of one parameter, by the last part of its dotted ``path``
    and its ``shape`` (the reference's ``param_spec``, rule for rule).

    ``fsdp`` defaults to every axis but ``tp`` (pods included); ``()``
    turns FSDP off. ``uneven_heads`` shards head axes over ``tp`` even when
    the head count does not divide it (DTensor then shards unevenly, as
    GSPMD pads). ``fsdp_tables_only`` keeps FSDP on embedding tables only.
    """
    sz = _axis_sizes(mesh)
    if fsdp is None:
        fsdp = tuple(a for a in mesh.axis_names if a != tp)
    if isinstance(fsdp, str):
        fsdp = (fsdp,)
    fsdp = tuple(fsdp)
    fsdp_size = 1
    for a in fsdp:
        fsdp_size *= sz[a]
    dims = list(shape)
    name = path.split(".")[-1]
    head_param = name in ("wq", "wk", "wv", "wo")
    if fsdp_tables_only and name != "table":
        fsdp, fsdp_size = (), 1                # weight-stationary layers (serving)

    def maybe(axis, i):
        if not 0 <= i < len(dims):
            return None
        if axis == fsdp:
            if not fsdp:                       # FSDP off: replicated over the data axes
                return None
            return fsdp if _fits(fsdp_size, dims[i]) else None
        if axis in sz and _fits(sz[axis], dims[i]):
            return axis
        if axis in sz and uneven_heads and head_param and dims[i] >= 2:
            return axis                        # uneven sharding
        return None

    spec = [None] * len(dims)
    if name == "table":                        # embed / unembed [V, D]
        spec[0], spec[1] = maybe(tp, 0), maybe(fsdp, 1)
    elif name in ("wq", "wk", "wv"):           # [D, heads, hd]; KV % tp != 0 -> None
        spec[0], spec[1] = maybe(fsdp, 0), maybe(tp, 1)
    elif name == "wo":                         # [H, hd, D]
        spec[0], spec[2] = maybe(tp, 0), maybe(fsdp, 2)
    elif name in ("w1", "w3") and len(dims) == 2:     # [D, F]
        spec[0], spec[1] = maybe(fsdp, 0), maybe(tp, 1)
    elif name == "w2" and len(dims) == 2:      # [F, D]
        spec[0], spec[1] = maybe(tp, 0), maybe(fsdp, 1)
    elif name in ("w1", "w3") and len(dims) == 3:     # experts [E, D, F]
        spec[0], spec[1] = maybe(tp, 0), maybe(fsdp, 1)
    elif name == "w2" and len(dims) == 3:      # experts [E, F, D]
        spec[0], spec[2] = maybe(tp, 0), maybe(fsdp, 2)
    elif name == "router":                     # [D, E]
        spec[0] = maybe(fsdp, 0)
    elif name in ("wdq", "wdkv", "wkrope"):    # MLA down [D, r]
        spec[0] = maybe(fsdp, 0)
    elif name in ("wuq", "wuk", "wuv"):        # MLA up [r, H, k]
        spec[1] = maybe(tp, 1)
    elif name == "in_proj":                    # mamba [D, X]
        spec[0], spec[1] = maybe(fsdp, 0), maybe(tp, 1)
    elif name == "out_proj":                   # mamba [d_inner, D]
        spec[0], spec[1] = maybe(tp, 0), maybe(fsdp, 1)
    elif name == "conv_w":                     # [W, C]
        spec[1] = maybe(tp, 1)
    elif name == "conv_b":                     # [C]
        spec[0] = maybe(tp, 0)
    # everything else (norms, biases, gates, meta, a_log, ...) replicated
    return P(*spec)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_specs(params: Mapping[str, object], mesh, **kw) -> Dict[str, P]:
    """{name: ``P``} for a dict of parameters (tensors, or shapes) named as
    the model's state dict."""
    return {n: param_spec(n, _shape(t), mesh, **kw) for n, t in params.items()}


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim, ``Shard(d)``
    where tensor dim d names that axis (alone or in a tuple), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.axis_names:
        dims = [d for d, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and axis in e)]
        if len(dims) > 1:
            raise ValueError(f"{spec} names axis {axis!r} on more than one dim")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(params: Mapping[str, object], mesh, **kw) -> Dict[str, tuple]:
    """{name: DTensor placements} of ``param_specs`` on ``mesh``."""
    return {n: placements(s, mesh) for n, s in param_specs(params, mesh, **kw).items()}


def opt_state_specs(opt: Mapping[str, object], params_specs: Mapping[str, P]) -> dict:
    """Moment specs: ``m`` and ``v`` inherit the parameter specs; a factored
    second moment's ``{"vr", "vc"}`` (small) is replicated; ``step`` is
    ``P()``. ``opt`` is ``adamw_init``'s state (its ``v`` names which
    leaves are factored)."""
    v = {n: ({"vr": P(), "vc": P()} if isinstance(opt["v"][n], dict) else s)
         for n, s in params_specs.items()}
    return {"m": dict(params_specs), "v": v, "step": P()}


def cache_spec(name: str, shape: Sequence[int], mesh, *, batch_sharded: bool,
               dp_axes=("data",), tp: str = "model") -> P:
    """The ``P`` of one cache leaf by its name and shape (the reference's
    ``cache_specs`` rule, its dims less the group axis).

    ``k`` / ``v`` / ``ckv`` / ``krope`` [B, L, ...]: with ``batch_sharded``
    and a batch that ``dp_axes`` divide, the batch over them and the length
    over ``tp`` (flash decoding); otherwise the length over every mesh axis
    where it divides, else over ``tp``. ``h`` [B, H, N, P]: the batch over
    ``dp_axes`` as above, else the state dim over ``data``; the heads over
    ``tp``. ``conv`` [B, W-1, C]: the batch as above, the channels over
    ``tp``."""
    sz = _axis_sizes(mesh)
    dims = list(shape)
    spec = [None] * len(dims)
    dp_total = 1
    for a in dp_axes:
        dp_total *= sz[a]
    tp_size = sz.get(tp, 1)
    batch = batch_sharded and _fits(dp_total, dims[0])
    if name in ("k", "v", "ckv", "krope"):
        if batch:
            spec[0] = tuple(dp_axes)
            if _fits(tp_size, dims[1]):
                spec[1] = tp
        else:                                  # a batch too small: the length over the whole mesh
            full = 1
            for s in sz.values():
                full *= s
            if _fits(full, dims[1]):
                spec[1] = tuple(mesh.axis_names)
            elif _fits(tp_size, dims[1]):
                spec[1] = tp
    elif name == "h":
        if batch:
            spec[0] = tuple(dp_axes)
        elif _fits(sz.get("data", 1), dims[2]):
            spec[2] = "data"                   # the SSD state dim over data at batch 1
        if _fits(tp_size, dims[1]):
            spec[1] = tp
    elif name == "conv":
        if batch:
            spec[0] = tuple(dp_axes)
        if _fits(tp_size, dims[2]):
            spec[2] = tp
    return P(*spec)


def cache_specs(caches, mesh, *, batch_sharded: bool, dp_axes=("data",), tp: str = "model"):
    """``cache_spec`` of every leaf of ``caches`` (tensors or shapes, nested
    dicts and lists as ``Model.cache_struct`` returns them), in the same
    structure. A leaf is named by its last key, so hybrid's ``attn`` /
    ``ssm`` and whisper's ``self`` / ``cross`` caches follow the same rules."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name) for v in tree]
        return cache_spec(name, _shape(tree), mesh, batch_sharded=batch_sharded, dp_axes=dp_axes, tp=tp)

    return walk(caches)


def cache_shardings(caches, mesh, **kw):
    """DTensor placements of ``cache_specs(caches, mesh, **kw)``, in the same structure."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return placements(tree, mesh)

    return walk(cache_specs(caches, mesh, **kw))


def distribute(tree, shardings, mesh):
    """``tree``'s tensors (nested dicts) as DTensors placed by the matching
    entries of ``shardings`` (placements, or ``P`` specs): a plain tensor
    (the same whole tensor on every rank) is distributed, each rank keeping
    its shard; a DTensor is redistributed. Other leaves (ints) unchanged."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute(v, s, mesh) for v, s in zip(tree, shardings)]
    if not isinstance(tree, torch.Tensor):
        return tree
    pl = list(placements(shardings, mesh) if isinstance(shardings, P) else shardings)
    if isinstance(tree, DTensor):
        return tree if list(tree.placements) == pl else tree.redistribute(mesh.device_mesh, pl)
    return distribute_tensor(tree.detach(), mesh.device_mesh, pl)


def gather(tree):
    """``distribute``'s inverse: every DTensor of ``tree`` as its whole tensor
    (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather(v) for v in tree]
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
