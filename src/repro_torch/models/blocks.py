"""Per-layer-kind block assembly (pre-norm residual blocks).

Counterpart of ``repro/models/blocks.py``:

  dense / local / global   self-attention (+window/theta variants) + MLP
  moe                      self-attention (MLA with ``use_mla``) + MoE FFN (shared + routed)
  ssm                      Mamba-2 block (no MLP when d_ff == 0)
  hybrid                   parallel attention + Mamba heads (Hymba) + MLP
  cross                    gated cross-attention to the vision embeddings + MLP (llama-vision)
  enc / dec                whisper's encoder (bidirectional) and decoder
                           (causal self-attention, cross-attention to the encoder) blocks

``block_init(kind, gen, cfg, device)`` builds one layer's params;
``block_apply`` runs one of the reference's three modes: "train" (full
sequence, no cache, under autograd), "prefill" (full sequence -> cache)
or "decode" (one token + cache), and returns (x, cache, aux) as the
reference does (aux: the MoE load-balance loss, 0.0 for other kinds).
``enc`` layers run only inside ``Model._encode`` and keep no cache.

``ctx.mesh`` (a ``launch.mesh.Mesh``, with DTensor activations) reaches the
attention, MLA and SSD layers in every mode; a ``moe`` layer on a mesh runs
the expert-parallel form (``_moe_shard_map``), the experts split over
``model``. With ``ep_mode == "shard_map"`` and a batch that divides the data
axes, the tokens are split over them and the capacity comes from each
shard's tokens, as in the reference's ``shard_map``; otherwise (the gspmd
form, or decode at batch 1) every rank holds all the tokens, and the
capacity from the whole batch is the reference's ``moe_apply_gspmd``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..configs.base import ArchConfig
from . import mamba as mb
from . import mla
from . import moe as moe_mod
from ..launch.mesh import dp_axes
from .layers import (
    _dtensor_api, _is_dtensor, attention_decode, attention_prefill, attention_train, cross_attention_decode,
    cross_attention_prefill, encoder_attention, init_attention, init_mlp, init_rmsnorm, mlp_apply,
    rmsnorm,
)

ATTN_KINDS = ("dense", "local", "global")
KINDS = ATTN_KINDS + ("ssm", "hybrid", "moe", "cross", "enc", "dec")


def check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


@dataclasses.dataclass
class Ctx:
    """Modal context threaded through block_apply."""
    cfg: ArchConfig
    mode: str                                   # train | prefill | decode
    positions: Optional[torch.Tensor] = None    # train / prefill: [S]
    pos: Optional[int] = None                   # decode: position of the new token
    s_max: int = 0                              # cache capacity
    use_kernels: bool = True                    # train / prefill: the CUDA kernels (plain on the CPU)
    meta: Optional[torch.Tensor] = None         # hymba meta tokens [M, D]
    cross_src: Optional[torch.Tensor] = None    # train / prefill: vision embeddings / encoder output [B, T, D]
    mesh: Any = None                            # a launch.mesh.Mesh (DTensor activations), every mode


def _kind_attn_args(kind: str, cfg: ArchConfig):
    window = cfg.local_window if kind in ("local", "hybrid") else 0
    theta = (
        cfg.rope_theta_global
        if (kind == "global" and cfg.rope_theta_global)
        else cfg.rope_theta
    )
    return window, theta


def block_init(kind: str, gen, cfg: ArchConfig, device) -> dict:
    check_kind(kind)
    D = cfg.d_model
    if kind in ATTN_KINDS:
        ff = cfg.dense_d_ff if (cfg.n_experts and cfg.dense_d_ff) else cfg.d_ff
        return {
            "ln1": init_rmsnorm(D, device), "attn": init_attention(gen, cfg, device),
            "ln2": init_rmsnorm(D, device), "mlp": init_mlp(gen, D, ff, cfg.act, device),
        }
    if kind == "moe":
        return {
            "ln1": init_rmsnorm(D, device),
            "attn": mla.init_mla(gen, cfg, device) if cfg.use_mla else init_attention(gen, cfg, device),
            "ln2": init_rmsnorm(D, device), "moe": moe_mod.init_moe(gen, cfg, device),
        }
    if kind == "hybrid":
        return {
            "ln1": init_rmsnorm(D, device),
            "attn": init_attention(gen, cfg, device),
            "ssm": mb.init_mamba(gen, cfg, device),
            "attn_norm": init_rmsnorm(D, device),
            "ssm_norm": init_rmsnorm(D, device),
            "gate_attn": torch.full((D,), 0.5, device=device),
            "gate_ssm": torch.full((D,), 0.5, device=device),
            "ln2": init_rmsnorm(D, device),
            "mlp": init_mlp(gen, D, cfg.d_ff, cfg.act, device),
        }
    if kind in ("cross", "enc"):
        p = {
            "ln1": init_rmsnorm(D, device), "attn": init_attention(gen, cfg, device),
            "ln2": init_rmsnorm(D, device), "mlp": init_mlp(gen, D, cfg.d_ff, cfg.act, device),
        }
        if kind == "cross":                          # llama-vision's gate: tanh(0) shuts it at init
            p["xgate"] = torch.zeros((D,), device=device)
        return p
    if kind == "dec":
        return {
            "ln1": init_rmsnorm(D, device), "attn": init_attention(gen, cfg, device),
            "lnx": init_rmsnorm(D, device), "xattn": init_attention(gen, cfg, device),
            "ln2": init_rmsnorm(D, device), "mlp": init_mlp(gen, D, cfg.d_ff, cfg.act, device),
        }
    return {"ln1": init_rmsnorm(D, device), "ssm": mb.init_mamba(gen, cfg, device)}


def _self_attn(p, h, ctx: Ctx, kind: str, cache=None):
    """Returns (out, cache); hymba's meta tokens lead the keys and the cache."""
    cfg = ctx.cfg
    window, theta = _kind_attn_args(kind, cfg)
    M = cfg.meta_tokens if kind == "hybrid" else 0
    if ctx.mode == "decode":
        return attention_decode(p, h, ctx.pos + M, cache, cfg, window=window, theta=theta, prefix=M,
                                mesh=ctx.mesh)
    if ctx.mode == "train":
        return attention_train(p, h, ctx.positions, cfg, window=window, theta=theta,
                               use_kernels=ctx.use_kernels, meta=ctx.meta if M else None, mesh=ctx.mesh), None
    return attention_prefill(p, h, ctx.positions, cfg, window=window, theta=theta, s_max=ctx.s_max,
                             use_kernels=ctx.use_kernels, meta=ctx.meta if M else None, mesh=ctx.mesh)


def _ssm(p, h, ctx: Ctx, cache=None):
    if ctx.mode == "decode":
        return mb.mamba_decode(p, h, cache, ctx.cfg, mesh=ctx.mesh)
    if ctx.mode == "train":
        return mb.mamba_train(p, h, ctx.cfg, use_kernels=ctx.use_kernels, mesh=ctx.mesh), None
    return mb.mamba_prefill(p, h, ctx.cfg, use_kernels=ctx.use_kernels, mesh=ctx.mesh)


def _cross_attn(p, h, ctx: Ctx, cache=None):
    """Cross-attention over ``ctx.cross_src`` (train, prefill) or its cache (decode)."""
    if ctx.mode == "decode":
        return cross_attention_decode(p, h, cache, mesh=ctx.mesh, flash=ctx.cfg.flash_decode)
    out, kv = cross_attention_prefill(p, h, ctx.cross_src, ctx.cfg, use_kernels=ctx.use_kernels, mesh=ctx.mesh)
    return out, None if ctx.mode == "train" else kv


def block_apply(kind: str, p, x, ctx: Ctx, cache=None):
    """Returns (x, new_cache, aux); in "train" the cache is None."""
    check_kind(kind)
    cfg = ctx.cfg
    if kind in ATTN_KINDS:
        a, kv = _self_attn(p["attn"], rmsnorm(p["ln1"], x), ctx, kind, cache)
        x = x + a
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)
        return x, kv, 0.0
    if kind == "moe":
        h = rmsnorm(p["ln1"], x)
        if not cfg.use_mla:
            a, kv = _self_attn(p["attn"], h, ctx, "dense", cache)
        elif ctx.mode == "decode":
            a, kv = mla.mla_decode(p["attn"], h, ctx.pos, cache, cfg, mesh=ctx.mesh)
        elif ctx.mode == "train":
            a, kv = mla.mla_train(p["attn"], h, ctx.positions, cfg, mesh=ctx.mesh), None
        else:
            a, kv = mla.mla_prefill(p["attn"], h, ctx.positions, cfg, s_max=ctx.s_max, mesh=ctx.mesh)
        x = x + a
        h2 = rmsnorm(p["ln2"], x)
        if ctx.mesh is None or not _is_dtensor(h2):
            y, aux = moe_mod.moe_apply(p["moe"], h2, cfg)
        else:
            split = cfg.ep_mode == "shard_map" and h2.shape[0] % ctx.mesh.size(dp_axes(ctx.mesh)) == 0
            y, aux = _moe_shard_map(p["moe"], h2, cfg, ctx.mesh, split_tokens=split)
        return x + y, kv, aux
    if kind == "hybrid":
        h = rmsnorm(p["ln1"], x)
        a, kv = _self_attn(p["attn"], h, ctx, "hybrid", None if cache is None else cache["attn"])
        s, st = _ssm(p["ssm"], h, ctx, None if cache is None else cache["ssm"])
        x = x + (p["gate_attn"].to(x.dtype) * rmsnorm(p["attn_norm"], a)
                 + p["gate_ssm"].to(x.dtype) * rmsnorm(p["ssm_norm"], s))
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)
        return x, (None if ctx.mode == "train" else {"attn": kv, "ssm": st}), 0.0
    if kind == "cross":
        a, kv = _cross_attn(p["attn"], rmsnorm(p["ln1"], x), ctx, cache)
        x = x + torch.tanh(p["xgate"]).to(x.dtype) * a
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)
        return x, kv, 0.0
    if kind == "enc":
        x = x + encoder_attention(p["attn"], rmsnorm(p["ln1"], x), cfg, use_kernels=ctx.use_kernels,
                                  mesh=ctx.mesh)
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)
        return x, None, 0.0
    if kind == "dec":
        # self-attention at the config's theta (whisper: 0, no RoPE), then the encoder's output
        a, kv = _self_attn(p["attn"], rmsnorm(p["ln1"], x), ctx, "dense", None if cache is None else cache["self"])
        x = x + a
        a, xkv = _cross_attn(p["xattn"], rmsnorm(p["lnx"], x), ctx, None if cache is None else cache["cross"])
        x = x + a
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)
        return x, (None if ctx.mode == "train" else {"self": kv, "cross": xkv}), 0.0
    y, st = _ssm(p["ssm"], rmsnorm(p["ln1"], x), ctx, cache)
    return x + y, st, 0.0


def _moe_leaves(moe_params, mesh):
    """The MoE parameters as flat lists for ``local_map``: ``(names, leaves,
    placements)``, a name ``(group, key)`` (key None for the router), the
    placements the reference's ``_moe_param_specs``: the experts split on
    their leading axis over ``model`` and whole elsewhere (FSDP's dim
    gathered), the router and the shared experts replicated."""
    _, _, Replicate, Shard, _ = _dtensor_api()
    ep = [Shard(0) if a == "model" else Replicate() for a in mesh.axis_names]
    rep = [Replicate()] * len(mesh.axis_names)
    names, leaves, pls = [], [], []
    for n in ("router", "experts", "shared"):
        if n not in moe_params:
            continue
        sub = moe_params[n]
        keys = [None] if isinstance(sub, torch.Tensor) else list(sub._parameters)   # a ParamTree's parameters
        for k in keys:
            names.append((n, k))
            leaves.append(sub if k is None else sub[k])
            pls.append(ep if n == "experts" else rep)
    return names, leaves, pls


def _moe_tree(names, ws) -> dict:
    """``_moe_leaves``' flat list back into the MoE parameter dict."""
    tree = {}
    for (n, k), w in zip(names, ws):
        if k is None:
            tree[n] = w
        else:
            tree.setdefault(n, {})[k] = w
    return tree


def _moe_shard_map(p, h, cfg: ArchConfig, mesh, split_tokens: bool = True):
    """``moe.moe_apply_shard_map`` on each rank's shards under ``local_map``
    (the reference's ``jax.shard_map``): the parameters as ``_moe_leaves``
    places them; tokens [B, S, D] whole over ``model`` and, with
    ``split_tokens``, split over the data axes (aux averaged over them),
    else whole on every rank (capacity from the whole batch: the gspmd
    form's function). Gradients: the tokens' as the tokens; with
    ``split_tokens`` the experts' and the replicated weights' partial sums
    over the data axes, else each rank's whole."""
    _, Partial, Replicate, Shard, local_map = _dtensor_api()
    dp = dp_axes(mesh) if split_tokens else ()
    dm = mesh.device_mesh
    xp = [Shard(0) if a in dp else Replicate() for a in mesh.axis_names]
    names, leaves, pls = _moe_leaves(p, mesh)
    grads = [[Partial() if a in dp else q for a, q in zip(mesh.axis_names, pl)] for pl in pls]

    def body(x, *ws):
        y, aux = moe_mod.moe_apply_shard_map(_moe_tree(names, ws), x, cfg, mesh=mesh)
        return y, aux.reshape(1)

    # aux leaves as one value a data shard, averaged by DTensor's own mean: its gradient is
    # 1/D a shard (a Partial("avg") output would hand each shard the whole gradient)
    y, aux = local_map(body, out_placements=(xp, xp), in_placements=(xp, *pls), in_grad_placements=(xp, *grads),
                       device_mesh=dm)(h.redistribute(dm, xp), *(w.redistribute(dm, pl) for w, pl in zip(leaves, pls)))
    return y, aux.mean().redistribute(dm, [Replicate()] * dm.ndim)
