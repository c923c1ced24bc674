"""Multi-pod dry run: one LM training step of every (arch x mesh) cell on a
production mesh, counted per device, with no card.

Counterpart of ``repro/launch/dryrun.py``'s train cells. The reference
lowers and compiles each cell on 512 virtual host devices and reads the
partitioned HLO. Here one process is rank 0 of a fake world of 256 or 512
(``launch.mesh.init_fake_world``) laid out as the production mesh; the
model's parameters, the optimizer state and the batch are DTensors placed
by ``training.sharding`` whose shards are fake tensors (``FakeTensorMode``:
shapes only, no memory), and the step runs eagerly on the plain path
(``use_kernels=False``), as the reference counts its einsum attention, not
its kernel. ``roofline.analysis.count`` reads this rank's local ops.

Like the reference's scan, a cell counts one microbatch's loss and
gradients (the model's forward, its recomputation under ``cfg.remat`` and
its backward) and multiplies by ``n_micro``, then adds the optimizer step
once; the peak memory is the largest of the two phases', with the state
and the f32 gradient accumulators live throughout.

Cells: ``build_train_cell`` for the eight configs whose train cell needs no
expert-parallel MoE (``TRAIN_ARCHS``), with the reference's options
(``no-fsdp``, ``micro4``, ``bf16-params``, ``remat-none``,
``uneven-heads``). The MoE configs' train cells and the prefill, decode and
PRF cells are not ported (ROADMAP.md item 20).

    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh both --out DIR
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

from ..configs.base import SHAPES, get_config
from ..roofline.analysis import HW, combine, count, roofline_terms
from .mesh import dp_axes, init_fake_world, make_production_mesh

TRAIN_ARCHS = ("smollm-135m", "mamba2-780m", "hymba-1.5b", "qwen1.5-4b", "gemma3-12b",
               "gemma3-27b", "whisper-large-v3", "llama-3.2-vision-90b")
OPTS = ("no-fsdp", "micro4", "bf16-params", "remat-none", "uneven-heads")


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

    from ..models.model import build_model
    from ..training.optimizer import AdamWConfig, adamw_update
    from ..training.sharding import distribute
    from ..training.train_step import init_state, make_sharded_train_step

    bad = [o for o in opts if o not in OPTS]
    if bad:
        raise ValueError(f"unknown options {bad}; known: {OPTS}")
    dp = dp_axes(mesh)
    dp_total = mesh.size(dp)
    gb, S = shape["global_batch"], shape["seq_len"]
    micro = min(dp_total * (4 if "micro4" in opts else 1), gb)
    n_micro = max(gb // micro, 1)
    if "bf16-params" in opts:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if "remat-none" in opts:
        cfg = dataclasses.replace(cfg, remat="none")
    if "uneven-heads" in opts:
        cfg = dataclasses.replace(cfg, seq_shard_attn=False)
    spec_kw = {"fsdp": ()} if "no-fsdp" in opts else {}
    if "uneven-heads" in opts:
        spec_kw["uneven_heads"] = True

    model = build_model(cfg, "meta", mesh=mesh, use_kernels=False)
    _fake_params(model)
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


def _tensor_list(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_list(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_list(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def analyze_train_cell(cfg, shape: Dict, mesh, opts=()) -> Dict[str, Any]:
    """``build_train_cell`` under ``FakeTensorMode``, its phases counted and
    combined: ``roofline.analysis.count``'s fields per device, plus
    ``micro``, ``n_micro`` and ``build_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with FakeTensorMode():
        phases, info = build_train_cell(cfg, shape, mesh, opts)
        t_build = time.time() - t0
        state = _tensor_list(info["state"])
        analysis = combine(*(count(fn, external=state, repeat=rep) for _, fn, rep in phases))
    return {**analysis, "micro": info["micro"], "n_micro": info["n_micro"], "build_s": t_build}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Optional[str] = None,
             opts=()) -> Dict[str, Any]:
    """One cell: its result dict (the reference's fields; ``status`` "OK" or
    "FAIL: ..."), written as JSON under ``out_dir`` when given."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_dev = 512 if multi_pod else 256
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "devices": n_dev,
                              "opts": list(opts)}
    t0 = time.time()
    try:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        if shape["kind"] != "train" or arch not in TRAIN_ARCHS:
            raise ValueError(f"only the train cells of {TRAIN_ARCHS} are ported")
        init_fake_world(n_dev)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        analysis = analyze_train_cell(cfg, shape, mesh, opts)
        mf = model_flops_global(cfg, shape) / n_dev
        terms = roofline_terms(analysis, model_flops_per_device=mf)
        peak = analysis["memory"]["peak_bytes"]
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
            **terms,
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
    line = f"{r['arch']:24s} {r['shape']:10s} {r['mesh']:8s} {r['status'][:60]:8s} wall={r['wall_s']:6.1f}s"
    if r["status"] == "OK":
        colls = " ".join(f"{k}={v['count']}/{v['operand_bytes']:.3e}B" for k, v in sorted(r["collectives"].items()))
        line += (f" flops/dev={r['flops_per_device']:.4e} bytes/dev={r['bytes_per_device']:.4e}"
                 f" coll={r['collective_bytes']:.4e}B [{colls}]"
                 f" hbm/dev={r['hbm_per_device_gb']:.3f}GB fits={r['fits_hbm']}"
                 f" compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s"
                 f" dom={r['dominant']} frac={r['roofline_fraction']:.3f}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry run of the LM train cells, per device")
    ap.add_argument("--arch", default="all", help=f"one of {TRAIN_ARCHS}, or 'all'")
    ap.add_argument("--shape", default="train_4k", help="a train shape of SHAPES")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--opt", default="", help="comma-separated: " + ",".join(OPTS))
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)
    archs = list(TRAIN_ARCHS) if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    any_fail = False
    for arch in archs:
        for mp in meshes:
            r = run_cell(arch, args.shape, mp, args.out, opts)
            any_fail |= r["status"] != "OK"
            print(format_line(r), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 1 if any_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
