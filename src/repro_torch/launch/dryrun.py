"""Multi-pod dry run: every (arch x shape x mesh) cell of the LM configs, and
the PRF cell, on a production mesh, counted per device, with no card.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and compiles
each cell on 512 virtual host devices and reads the partitioned HLO. Here
one process is rank 0 of a fake world of 256 or 512
(``launch.mesh.init_fake_world``) laid out as the production mesh; the
model's parameters (and the optimizer state, the batch, the caches) are
DTensors placed by ``training.sharding`` whose shards are fake tensors
(``FakeTensorMode``: shapes only, no memory), and the cell runs eagerly on
the plain path (``use_kernels=False``), as the reference counts its einsum
attention, not its kernel. ``roofline.analysis.count`` reads this rank's
local ops.

Cells, by the shape's kind:

* train (``build_train_cell``, all ten configs): like the reference's scan,
  one microbatch's loss and gradients (the forward, its recomputation under
  ``cfg.remat``, the backward) counted and multiplied by ``n_micro``, then
  the optimizer step once; the peak memory is the larger phase's, with the
  state and the f32 gradient accumulators live throughout. The MoE configs
  run the expert-parallel MoE (``ep_mode="shard_map"``, ``all_to_all`` over
  ``model``);
* prefill (``build_prefill_cell``): ``serving.make_serve_fns``' prefill of
  the global batch, its caches placed by ``cache_specs`` at the end (the
  reference's ``out_shardings``);
* decode (``build_decode_cell``): one decode step over caches placed by
  ``cache_specs``, ``batch_sharded`` when the batch divides the data axes
  (else, at batch 1, the length over every axis);
* ``long_500k`` of a config that is not ``sub_quadratic``: ``SKIP(full-attn)``;
* PRF (``build_prf_cell``, the CLI's ``prf`` arch, ``train_4k`` only): the
  paper's own workload at the reference cell's per-device shape. It cannot
  run on fake tensors (the growth syncs on the host once a level), so rank
  0's real shard of seeded bins and labels (2^22 rows x 4096 features, 16
  classes, split over the mesh) grows a forest on ``device`` (the card by
  default) through ``core.distributed.make_prf_train_fn``, its collectives
  answered by ``ReplicaMesh`` as a world whose ranks all hold this shard
  would answer them, so every gathered index stays valid; the cell counts
  its levels, collectives, bytes and peak memory. As in the reference it has
  no model FLOPs (``PRF_MODEL_FLOPS``).

Options (``--opt``): the reference's ``no-fsdp``, ``micro4``,
``bf16-params``, ``remat-none``, ``uneven-heads`` (train, and the serving
cells' parameters), ``where-update``, ``flash-decode``,
``fsdp-tables-only`` (serving), ``prf-packed``, ``prf-rs`` (PRF).

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

import numpy as np
import torch.distributed as dist

from ..configs.base import SHAPES, get_config
from ..roofline.analysis import HW, combine, count, roofline_terms
from .mesh import Mesh, dp_axes, init_fake_world, make_production_mesh

TRAIN_ARCHS = ("smollm-135m", "mamba2-780m", "hymba-1.5b", "qwen1.5-4b", "gemma3-12b",
               "gemma3-27b", "whisper-large-v3", "llama-3.2-vision-90b", "deepseek-moe-16b",
               "deepseek-v3-671b")
TRAIN_OPTS = ("no-fsdp", "micro4", "bf16-params", "remat-none", "uneven-heads")
SERVE_OPTS = ("no-fsdp", "bf16-params", "uneven-heads", "where-update", "flash-decode", "fsdp-tables-only")
PRF_OPTS = ("prf-packed", "prf-rs")
OPTS = tuple(dict.fromkeys(TRAIN_OPTS + SERVE_OPTS + PRF_OPTS))
PRF_MODEL_FLOPS = None   # PRF has no 6 N D analogue (the reference's)


def model_flops_global(cfg, shape: Dict) -> float:
    """6 N D (train), 2 N D (prefill), 2 N a token (decode), N the active
    parameters: the reference's ``model_flops_global``."""
    n_active = cfg.active_param_count()
    if shape["kind"] == "train":
        return 6.0 * n_active * shape["global_batch"] * shape["seq_len"]
    if shape["kind"] == "prefill":
        return 2.0 * n_active * shape["global_batch"] * shape["seq_len"]
    return 2.0 * n_active * shape["global_batch"]


def _extras(cfg, batch: int) -> Dict[str, tuple]:
    """Modality stubs (precomputed embeddings), the reference's ``_extras_specs``."""
    out = {}
    if cfg.family == "vlm":
        out["vision_embeds"] = (batch, cfg.vision_tokens, cfg.d_model)
    if cfg.family == "encdec":
        out["frames"] = (batch, cfg.encoder_frames, cfg.d_model)
    return out


def _fake_params(model) -> None:
    """Replace every parameter of a model built on "meta" by a fake tensor
    of its shape and dtype (``FakeTensorMode`` must be active)."""
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            mod._parameters[name] = torch.nn.Parameter(torch.empty(p.shape, dtype=p.dtype),
                                                       requires_grad=p.requires_grad)


def _check_opts(opts, known) -> None:
    bad = [o for o in opts if o not in known]
    if bad:
        raise ValueError(f"unknown options {bad}; known: {known}")


def _with_opts(cfg, opts, known):
    """(cfg, the sharding rules' keywords) under the options ``opts``."""
    _check_opts(opts, known)
    over = {"bf16-params": dict(param_dtype="bfloat16"), "remat-none": dict(remat="none"),
            "uneven-heads": dict(seq_shard_attn=False), "where-update": dict(decode_cache_update="where"),
            "flash-decode": dict(flash_decode=True)}
    for o in opts:
        if o in over:
            cfg = dataclasses.replace(cfg, **over[o])
    spec_kw = {"fsdp": ()} if "no-fsdp" in opts else {}
    if "uneven-heads" in opts:
        spec_kw["uneven_heads"] = True
    if "fsdp-tables-only" in opts:
        spec_kw["fsdp_tables_only"] = True
    return cfg, spec_kw


def _fake_model(cfg, mesh):
    """The model on the plain path with fake parameters (``FakeTensorMode``
    must be active)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    from ..models.model import build_model

    with unset_fake_temporarily():             # the parameters' casts run on "meta", not on fakes
        model = build_model(cfg, "meta", mesh=mesh, use_kernels=False)
    _fake_params(model)
    return model


def build_train_cell(cfg, shape: Dict, mesh, opts=()):
    """One train cell on ``mesh`` (active ``FakeTensorMode``): returns
    ``(phases, info)``. ``phases`` is ``[(name, fn, repeat)]``: one
    microbatch's loss and gradients (``n_micro`` times), then the AdamW
    update; ``info`` {"micro", "n_micro", "state"}: the state's tensors
    (params, moments, accumulators) for the memory count.

    opts: ``no-fsdp`` (params replicated over the data axes), ``micro4`` (4
    sequences a device a microbatch), ``bf16-params``, ``remat-none``,
    ``uneven-heads`` (heads sharded over ``model`` even when they do not
    divide it; no sequence sharding)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from ..training.optimizer import AdamWConfig, adamw_update
    from ..training.sharding import distribute
    from ..training.train_step import init_state, make_sharded_train_step

    dp = dp_axes(mesh)
    dp_total = mesh.size(dp)
    gb, S = shape["global_batch"], shape["seq_len"]
    micro = min(dp_total * (4 if "micro4" in opts else 1), gb)
    n_micro = max(gb // micro, 1)
    cfg, spec_kw = _with_opts(cfg, opts, TRAIN_OPTS)
    model = _fake_model(cfg, mesh)
    opt = AdamWConfig(moment_dtype=cfg.moment_dtype, factored=cfg.factored_second_moment)
    state = init_state(model, opt)
    _, shardings, _ = make_sharded_train_step(model, opt, mesh, dp_axes=dp, **spec_kw)
    params = distribute(state.params, shardings.params, mesh)
    moments = distribute(state.opt, shardings.opt, mesh)
    acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    live = dict(model.named_parameters())

    bp = [Shard(0) if a in dp else Replicate() for a in mesh.axis_names]
    batch = {k: distribute_tensor(torch.zeros((micro, S), dtype=torch.long), mesh.device_mesh, bp)
             for k in ("tokens", "targets")}
    for k, bshape in _extras(cfg, micro).items():
        batch[k] = distribute_tensor(torch.empty(bshape), mesh.device_mesh, bp)

    def grads():
        with implicit_replication():
            loss, _ = model.loss_fn(batch)
            for n, g in zip(live, torch.autograd.grad(loss, list(live.values()), allow_unused=True)):
                if g is not None:
                    acc[n].add_(g.float())

    def update():
        with implicit_replication():
            adamw_update(params, acc, moments, opt)

    info = {"micro": micro, "n_micro": n_micro, "state": [params, moments, acc]}
    return [("grads", grads, n_micro), ("update", update, 1)], info


def _serve_cell(cfg, shape: Dict, mesh, opts, batch_sharded: bool):
    """The serving functions of a fake model on ``mesh`` (``make_serve_fns``
    at ``s_max`` = the shape's length) and its parameters."""
    from ..serving.serve_step import make_serve_fns

    cfg, spec_kw = _with_opts(cfg, opts, SERVE_OPTS)
    model = _fake_model(cfg, mesh)
    fns = make_serve_fns(model, mesh, s_max=shape["seq_len"], batch_sharded=batch_sharded,
                         dp_axes=dp_axes(mesh), **spec_kw)
    return model, fns, [dict(model.named_parameters())]


def build_prefill_cell(cfg, shape: Dict, mesh, opts=()):
    """The prefill of the global batch on ``mesh`` (active ``FakeTensorMode``),
    the caches placed by ``cache_specs`` at its end: ``(phases, info)`` as
    ``build_train_cell``'s."""
    gb, S = shape["global_batch"], shape["seq_len"]
    model, (prefill, _, _), state = _serve_cell(cfg, shape, mesh, opts, batch_sharded=True)
    tokens = _batch_tensor(torch.zeros((gb, S), dtype=torch.long), mesh)
    extras = {k: _batch_tensor(torch.empty(b), mesh) for k, b in _extras(cfg, gb).items()}
    return [("prefill", lambda: prefill(tokens, extras), 1)], {"micro": gb, "n_micro": 1, "state": state}


def _batch_tensor(t, mesh):
    """``t`` placed as the serving functions place a batch (its dim 0 over
    the data axes where it divides them), before the count."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dp = dp_axes(mesh)
    split = t.shape[0] % mesh.size(dp) == 0
    return distribute_tensor(t, mesh.device_mesh, [Shard(0) if a in dp and split else Replicate()
                                                   for a in mesh.axis_names])


def build_decode_cell(cfg, shape: Dict, mesh, opts=()):
    """One decode step of the global batch on ``mesh`` (active
    ``FakeTensorMode``) at the caches' last position, the caches placed by
    ``cache_specs`` in and out (``batch_sharded`` when the batch divides the
    data axes, as the reference computes it): ``(phases, info)``."""
    from ..training.sharding import distribute

    gb, S = shape["global_batch"], shape["seq_len"]
    dp_total = mesh.size(dp_axes(mesh))
    batch_sharded = gb % dp_total == 0 and gb >= dp_total
    model, (_, decode, shardings), state = _serve_cell(cfg, shape, mesh, opts, batch_sharded)
    caches = model.cache_struct(gb, S)
    caches = distribute(caches, shardings["cache"](caches), mesh)
    token = _batch_tensor(torch.zeros((gb,), dtype=torch.long), mesh)
    info = {"micro": gb, "n_micro": 1, "state": state + [caches], "batch_sharded": batch_sharded}
    return [("decode", lambda: decode(caches, token, S - 1), 1)], info


BUILDERS = {"train": build_train_cell, "prefill": build_prefill_cell, "decode": build_decode_cell}


def _tensor_list(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_list(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_list(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def analyze_cell(cfg, shape: Dict, mesh, opts=()) -> Dict[str, Any]:
    """The shape's cell builder (``BUILDERS``) under ``FakeTensorMode``, its
    phases counted and combined: ``roofline.analysis.count``'s fields per
    device, plus ``micro``, ``n_micro`` and ``build_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with FakeTensorMode():
        phases, info = BUILDERS[shape["kind"]](cfg, shape, mesh, opts)
        t_build = time.time() - t0
        state = _tensor_list(info["state"])
        analysis = combine(*(count(fn, external=state, repeat=rep) for _, fn, rep in phases))
    return {**analysis, "micro": info["micro"], "n_micro": info["n_micro"], "build_s": t_build}





class ReplicaMesh(Mesh):
    """A ``Mesh`` (of a fake world, say) whose collectives run in this process
    as a world would answer them whose every shard holds a copy of this
    rank's block and whose split winners are this rank's: an all-gather
    returns this rank's tensor once a rank, a sum (or a reduce-scatter) this
    rank's tensor alone (its slice), the others' terms zero, as a winner's
    masked sum held here gives; a max or a min, the copies being equal,
    the tensor. So every gathered index stays valid. Each call is counted in
    ``collectives`` ({kind: {count, operand_bytes, result_bytes}}, the
    counter's form) and listed in ``calls``."""

    def __init__(self, mesh: Mesh, device):
        self.device_mesh, self.axis_names, self.shape = mesh.device_mesh, mesh.axis_names, mesh.shape
        self.coords, self._groups, self.backend = mesh.coords, mesh._groups, mesh.backend
        self.device = torch.device(device)
        self.host_staged, self.staged_bytes, self.all_to_all_calls = False, 0, 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.calls: list = []           # (kind, axes, operand shape) of each call, in order

    def _count(self, kind: str, t: torch.Tensor, out: torch.Tensor, axes) -> torch.Tensor:
        self.calls.append((kind, (axes,) if isinstance(axes, str) else tuple(axes), tuple(t.shape)))
        e = self.collectives.setdefault(kind, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        e["count"] += 1
        e["operand_bytes"] += t.numel() * t.element_size()
        e["result_bytes"] += out.numel() * out.element_size()
        return out

    def all_reduce(self, t, axes, op=dist.ReduceOp.SUM):
        return self._count("all-reduce", t, t.clone(), axes)

    def reduce_scatter(self, t, axis):
        n = self.size(axis)
        m = t.shape[0] // n
        i = self.index(axis)
        return self._count("reduce-scatter", t, t[i * m:(i + 1) * m].clone(), axis)

    def all_gather(self, t, axes):
        return self._count("all-gather", t, t.unsqueeze(0).repeat((self.size(axes),) + (1,) * t.dim()), axes)

    def all_to_all(self, t, axis):
        raise NotImplementedError("the PRF cell makes no all-to-all")

    def barrier(self) -> None:
        pass


class _Rank0Block:
    """A global ``[N, F]`` bin matrix of which only this rank's block exists:
    indexing it with that block's rows and columns returns the block."""

    def __init__(self, block: np.ndarray, shape, rows: slice, cols: slice):
        self.block, self.shape, self._key = block, tuple(shape), (rows, cols)

    def __getitem__(self, key):
        if key != self._key:
            raise IndexError(f"only rows {self._key[0]} and columns {self._key[1]} are held, not {key}")
        return self.block


def prf_cell_config(opts=()):
    """The reference cell's ``ForestConfig`` (64 trees, depth 12, 64 bins,
    16 classes, frontier 16, 8-tree chunks, importance mode)."""
    from ..core.types import ForestConfig

    _check_opts(opts, PRF_OPTS)
    return ForestConfig(n_trees=64, max_depth=12, n_bins=64, n_classes=16, max_frontier=16, tree_chunk=8,
                        feature_mode="importance", packed_hist="prf-packed" in opts,
                        hist_reduce="psum_scatter" if "prf-rs" in opts else "psum")


def build_prf_cell(mesh, opts=(), *, n_samples: int = 2 ** 22, n_features: int = 4096, device=None,
                   seed: int = 0, config=None):
    """The PRF cell on ``mesh``: rank 0's block of seeded bins
    ``[n_samples / D, n_features / M]`` (uint8 below ``n_bins``) and the
    global labels, ``make_prf_train_fn`` over a ``ReplicaMesh`` on
    ``device`` (None: the card). Returns ``(train, replica, config)``:
    ``train()`` grows the forest and returns it."""
    from ..core.distributed import _shard, make_prf_train_fn
    from ..device import resolve_device

    cfg = config or prf_cell_config(opts)
    replica = ReplicaMesh(mesh, resolve_device(device))
    dp = dp_axes(mesh)
    sh = _shard(replica, n_features, dp, "model")
    lo, hi, nl = sh.rows(n_samples)
    rng = np.random.default_rng(seed)
    block = rng.integers(0, cfg.n_bins, (nl, sh.Fl), dtype=np.uint8)
    y = rng.integers(0, cfg.n_classes, n_samples).astype(np.int32)
    xb = _Rank0Block(block, (n_samples, n_features), slice(lo, min(hi, n_samples)), sh.cols)
    train_fn, _ = make_prf_train_fn(cfg, replica, sample_axes=dp, feature_axis="model")
    return (lambda: train_fn(xb, y, seed)), replica, cfg


def analyze_prf_cell(mesh, opts=(), **kw) -> Dict[str, Any]:
    """``build_prf_cell``'s growth counted (``roofline.analysis.count``: this
    rank's torch ops' bytes and peak memory; the CUDA kernels, launched
    through ``ctypes``, are not seen, their launches are listed), with its
    ``ReplicaMesh``'s collectives, its levels and its wall time."""
    from ..core.engine import levels_run
    from ..kernels.gain_ratio import ops as hist_ops
    from ..kernels.split_scan import ops as scan_ops
    from ..kernels.tree_traverse import ops as trav_ops
    from ..roofline.analysis import wire_bytes

    t0 = time.time()
    train, replica, cfg = build_prf_cell(mesh, opts, **kw)
    t_build = time.time() - t0
    n0 = (hist_ops.launches, scan_ops.launches, trav_ops.launches)
    forest = []
    t1 = time.time()
    analysis = count(lambda: forest.append(train()))
    grow_s = time.time() - t1
    colls = replica.collectives
    return {**analysis, "collectives": colls, "collective_bytes": wire_bytes(colls),
            "levels": levels_run(forest[0]), "config": dataclasses.asdict(cfg), "calls": replica.calls,
            "kernel_launches": {"hist": hist_ops.launches - n0[0], "split_scan": scan_ops.launches - n0[1],
                                "traverse": trav_ops.launches - n0[2]},
            "device": str(replica.device), "grow_s": grow_s, "build_s": t_build, "micro": None, "n_micro": None}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Optional[str] = None,
             opts=(), device=None) -> Dict[str, Any]:
    """One cell: its result dict (the reference's fields; ``status`` "OK",
    "SKIP(full-attn)" or "FAIL: ..."), written as JSON under ``out_dir``
    when given. ``device``: the PRF cell's (None: the card)."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_dev = 512 if multi_pod else 256
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "devices": n_dev,
                              "opts": list(opts)}
    t0 = time.time()
    try:
        analysis, mf = None, 0.0
        if arch == "prf":
            init_fake_world(n_dev)
            analysis = analyze_prf_cell(make_production_mesh(multi_pod=multi_pod, device="cpu"), opts,
                                        device=device)
        else:
            cfg = get_config(arch)
            shape = SHAPES[shape_name]
            if shape_name == "long_500k" and not cfg.sub_quadratic:
                result["status"] = "SKIP(full-attn)"
            else:
                init_fake_world(n_dev)
                analysis = analyze_cell(cfg, shape, make_production_mesh(multi_pod=multi_pod, device="cpu"), opts)
                mf = model_flops_global(cfg, shape) / n_dev
        if analysis is not None:
            terms = roofline_terms(analysis, model_flops_per_device=mf)
            peak = analysis["memory"]["peak_bytes"]
            extra = {k: analysis[k] for k in ("levels", "kernel_launches", "device", "grow_s", "config")
                     if k in analysis}
            result.update(
                status="OK",
                build_s=round(analysis["build_s"], 1),
                count_s=round(time.time() - t0 - analysis["build_s"], 1),
                micro=analysis["micro"], n_micro=analysis["n_micro"],
                flops_per_device=analysis["flops"],
                bytes_per_device=analysis["bytes_accessed"],
                collective_bytes=analysis["collective_bytes"],
                collectives={k: {kk: int(vv) for kk, vv in v.items()} for k, v in analysis["collectives"].items()},
                memory=analysis["memory"],
                hbm_per_device_gb=round(peak / 2 ** 30, 3),
                fits_hbm=bool(peak < HW["hbm_bytes"]),
                **terms, **extra,
            )
    except Exception as e:                     # a cell's failure is its status, as in the reference
        result["status"] = f"FAIL: {type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-8000:]
    result["wall_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = ("~" + "~".join(sorted(opts))) if opts else ""
        with open(os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}{tag}.json"), "w") as f:
            json.dump(result, f, indent=2, default=str)
    return result


def format_line(r: Dict[str, Any]) -> str:
    line = f"{r['arch']:24s} {r['shape']:11s} {r['mesh']:8s} {r['status'][:60]:15s} wall={r['wall_s']:6.1f}s"
    if r["status"] == "OK":
        colls = " ".join(f"{k}={v['count']}/{v['operand_bytes']:.3e}B" for k, v in sorted(r["collectives"].items()))
        line += (f" flops/dev={r['flops_per_device']:.4e} bytes/dev={r['bytes_per_device']:.4e}"
                 f" coll={r['collective_bytes']:.4e}B [{colls}]"
                 f" hbm/dev={r['hbm_per_device_gb']:.3f}GB fits={r['fits_hbm']}"
                 f" compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s"
                 f" dom={r['dominant']} frac={r['roofline_fraction']:.3f}")
        if "levels" in r:
            line += f" levels={r['levels']} launches={r['kernel_launches']}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry run of the LM cells and the PRF cell, per device")
    ap.add_argument("--arch", default="all", help=f"one of {TRAIN_ARCHS}, 'prf', or 'all' (with prf)")
    ap.add_argument("--shape", default="all", help=f"one of {tuple(SHAPES)}, or 'all' (prf: train_4k only)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--opt", default="", help="comma-separated: " + ",".join(OPTS))
    ap.add_argument("--device", default=None, help="the PRF cell's device (default: the card)")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)
    archs = list(TRAIN_ARCHS) + ["prf"] if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    any_fail = False
    for arch in archs:
        for shape in (["train_4k"] if arch == "prf" else shapes):
            for mp in meshes:
                r = run_cell(arch, shape, mp, args.out, opts, device=args.device)
                any_fail |= r["status"].startswith("FAIL")
                print(format_line(r), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if any_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
