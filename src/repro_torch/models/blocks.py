"""Per-layer-kind block assembly (pre-norm residual blocks).

Counterpart of ``repro/models/blocks.py`` for the kinds the port runs:

  dense / local / global   self-attention (+window/theta variants) + MLP
  ssm                      Mamba-2 block (no MLP when d_ff == 0)

``block_init(kind, gen, cfg, device)`` builds one layer's params;
``block_apply`` runs "prefill" (full sequence -> cache) or "decode" (one
token + cache). The other kinds raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ArchConfig
from . import mamba as mb
from .layers import (
    attention_decode, attention_prefill, init_attention, init_mlp, init_rmsnorm,
    mlp_apply, rmsnorm,
)

ATTN_KINDS = ("dense", "local", "global")
KINDS = ATTN_KINDS + ("ssm",)
_UNPORTED = {
    "hybrid": "Queue 1 item 14 (hybrid: meta-prefix attention mask)",
    "moe": "Queue 1 item 16 (moe + mla)",
    "cross": "Queue 1 item 17 (cross / enc-dec)",
    "enc": "Queue 1 item 17 (cross / enc-dec)",
    "dec": "Queue 1 item 17 (cross / enc-dec)",
}


def check_kind(kind: str) -> None:
    if kind in KINDS:
        return
    if kind in _UNPORTED:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet: ROADMAP.md {_UNPORTED[kind]}")
    raise ValueError(kind)


@dataclasses.dataclass
class Ctx:
    """Modal context threaded through block_apply."""
    cfg: ArchConfig
    mode: str                                   # prefill | decode
    positions: Optional[torch.Tensor] = None    # prefill: [S]
    pos: Optional[int] = None                   # decode: position of the new token
    s_max: int = 0                              # cache capacity
    use_kernels: bool = True                    # prefill: the CUDA kernels (plain on the CPU)


def _kind_attn_args(kind: str, cfg: ArchConfig):
    window = cfg.local_window if kind == "local" else 0
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
    return {"ln1": init_rmsnorm(D, device), "ssm": mb.init_mamba(gen, cfg, device)}


def block_apply(kind: str, p, x, ctx: Ctx, cache=None):
    """Returns (x, new_cache)."""
    check_kind(kind)
    cfg = ctx.cfg
    if kind in ATTN_KINDS:
        h = rmsnorm(p["ln1"], x)
        window, theta = _kind_attn_args(kind, cfg)
        if ctx.mode == "decode":
            a, kv = attention_decode(p["attn"], h, ctx.pos, cache, cfg, window=window, theta=theta)
        else:
            a, kv = attention_prefill(p["attn"], h, ctx.positions, cfg, window=window, theta=theta,
                                      s_max=ctx.s_max, use_kernels=ctx.use_kernels)
        x = x + a
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)
        return x, kv
    h = rmsnorm(p["ln1"], x)
    if ctx.mode == "decode":
        y, st = mb.mamba_decode(p["ssm"], h, cache, cfg)
    else:
        y, st = mb.mamba_prefill(p["ssm"], h, cfg, use_kernels=ctx.use_kernels)
    return x + y, st
