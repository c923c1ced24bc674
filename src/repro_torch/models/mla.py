"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437).

Counterpart of ``repro/models/mla.py``. Queries and KV are low-rank
compressed; the decode cache holds only the compressed KV latent
(``kv_lora_rank``) and the shared RoPE key (``qk_rope_dim``). The
reference attends in plain XLA (no Pallas kernel), so ``_attend`` is
plain PyTorch: its qk width (nope + rope, 192 at v3) differs from its v
width (128), which the attention kernel does not take. Queries are
chunked by ``layers._auto_q_chunk``'s memory rule as well as the
reference's (exact: every chunk sees all keys).

On a mesh (DTensor activations) training and prefill attend on each rank's
batch rows and heads (``_heads_on_mesh``) and prefill builds its cache on
each rank's rows; decode reads ``ckv`` / ``krope``
placed by ``training.cache_specs`` (the length over ``model``) through
``layers._decode_on_mesh``: each length shard decompresses its own keys and
values (the LSE combine under ``cfg.flash_decode``, a gathered cache
otherwise).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ref import MASKED, MaskSpec
from .layers import (
    _auto_q_chunk, _decode_on_mesh, _dense_init, _is_dtensor, _proj_heads, _rows_local, batch_layout,
    cache_write, init_rmsnorm, rmsnorm, rope_apply,
)


def init_mla(gen, cfg: ArchConfig, device) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    rd, nd, vd = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    return {
        "wdq": _dense_init(gen, (D, qr), device),
        "qnorm": init_rmsnorm(qr, device),
        "wuq": _dense_init(gen, (qr, H, nd + rd), device),
        "wdkv": _dense_init(gen, (D, kvr), device),
        "kvnorm": init_rmsnorm(kvr, device),
        "wkrope": _dense_init(gen, (D, rd), device),
        "wuk": _dense_init(gen, (kvr, H, nd), device),
        "wuv": _dense_init(gen, (kvr, H, vd), device),
        "wo": _dense_init(gen, (H, vd, D), device, scale=(H * vd) ** -0.5),
    }


def _q_proj(p, x, positions, cfg: ArchConfig):
    cq = rmsnorm(p["qnorm"], batch_layout(x @ p["wdq"].to(x.dtype)))
    q = _proj_heads(cq, p["wuq"])
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, rope_apply(q_rope, positions, cfg.rope_theta)


def _kv_latent(p, x, positions, cfg: ArchConfig):
    # on a mesh, the down projections' outputs (and gradients) in the batch layout
    ckv = rmsnorm(p["kvnorm"], batch_layout(x @ p["wdkv"].to(x.dtype)))          # [B, S, kvr]
    k_rope = rope_apply(batch_layout(x @ p["wkrope"].to(x.dtype))[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]                                  # [B, S, rd] shared
    return ckv, k_rope


def _attend(p, q_nope, q_rope, ckv, k_rope, cfg: ArchConfig, mask=None,
            mask_spec: Optional[MaskSpec] = None, mesh=None):
    """Score via decompressed keys; f32 softmax; queries chunked at long Sq
    or many heads; then ``wo``. On a ``mesh`` (DTensor inputs) through
    ``_heads_on_mesh``."""
    if mesh is not None and _is_dtensor(q_nope):
        return _out_proj(p, _heads_on_mesh(q_nope, q_rope, ckv, k_rope, p["wuk"], p["wuv"], cfg, mesh, mask_spec))
    return _out_proj(p, _attend_heads(q_nope, q_rope, ckv, k_rope, p["wuk"], p["wuv"], cfg, mask, mask_spec))


def _heads_on_mesh(q_nope, q_rope, ckv, k_rope, wuk, wuv, cfg: ArchConfig, mesh, mask_spec):
    """``_attend_heads`` of DTensors on each rank's shards under
    ``local_map``: the batch over the axes but ``model`` where it divides,
    the heads of q and of ``wuk`` / ``wuv`` over ``model`` where they divide
    it (else whole), the latent ``ckv`` and the rope key whole over
    ``model``, their gradients partial sums there when the heads split
    (DTensor's own rules for these einsums fail on such layouts)."""
    from .layers import _batch_placements, _dtensor_api

    _, Partial, Replicate, Shard, local_map = _dtensor_api()
    names, dm = mesh.axis_names, mesh.device_mesh
    bp = _batch_placements(mesh, q_nope.shape[0], "model")
    heads = "model" in names and q_nope.shape[2] % mesh.shape["model"] == 0
    split = [a == "model" and heads for a in names]
    qp = [Shard(2) if h else b for h, b in zip(split, bp)]
    wp = [Shard(1) if h else Replicate() for h in split]
    cg = [Partial() if h else b for h, b in zip(split, bp)]
    wg = [Shard(1) if h else (Partial() if isinstance(b, Shard) else Replicate()) for h, b in zip(split, bp)]

    def fn(qn, qr, c, kr, wk, wv):
        return _attend_heads(qn, qr, c, kr, wk, wv, cfg, None, mask_spec)

    return local_map(fn, out_placements=(qp,), in_placements=(qp, qp, bp, bp, wp, wp),
                     in_grad_placements=(qp, qp, cg, cg, wg, wg), device_mesh=dm)(
        q_nope.redistribute(dm, qp), q_rope.redistribute(dm, qp), ckv.redistribute(dm, bp),
        k_rope.redistribute(dm, bp), wuk.redistribute(dm, wp), wuv.redistribute(dm, wp))


def _attend_heads(q_nope, q_rope, ckv, k_rope, wuk, wuv, cfg: ArchConfig, mask=None,
                  mask_spec: Optional[MaskSpec] = None):
    """The attention of ``_attend`` before ``wo``: [B, Sq, H, v_head_dim]."""
    k_nope = _proj_heads(ckv, wuk).float()
    v = _proj_heads(ckv, wuv).float()
    kr = k_rope.float()
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    B, Sq, H, _ = q_nope.shape
    Sk = ckv.shape[1]

    def attend_block(qn, qr, q0):
        logits = (torch.einsum("bqhk,bshk->bhqs", qn.float(), k_nope)
                  + torch.einsum("bqhk,bsk->bhqs", qr.float(), kr)) * scale
        if mask_spec is not None:
            logits = torch.where(mask_spec.block(q0, qn.shape[1], Sk, qn.device)[:, None], logits, MASKED)
        elif mask is not None:
            logits = torch.where(mask[:, None], logits, MASKED)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqs,bshk->bqhk", probs, v).to(q_nope.dtype)

    qc = _auto_q_chunk(Sq, Sk, B * H)
    if qc and Sq % qc == 0 and mask is None:
        o = torch.cat([attend_block(q_nope[:, i:i + qc], q_rope[:, i:i + qc], i)
                       for i in range(0, Sq, qc)], dim=1)
    else:
        o = attend_block(q_nope, q_rope, 0)
    return o


def _out_proj(p, o):
    B, Sq, H, vd = o.shape
    D = p["wo"].shape[-1]
    return batch_layout(o.reshape(B, Sq, H * vd) @ p["wo"].reshape(H * vd, D).to(o.dtype))


def mla_train(p, x, positions, cfg: ArchConfig, *, mesh=None) -> torch.Tensor:
    """Full-sequence causal MLA without a cache (plain, under autograd; on
    a ``mesh`` through ``_heads_on_mesh``)."""
    q_nope, q_rope = _q_proj(p, x, positions, cfg)
    ckv, k_rope = _kv_latent(p, x, positions, cfg)
    return _attend(p, q_nope, q_rope, ckv, k_rope, cfg, mask_spec=MaskSpec(causal=True), mesh=mesh)


def mla_prefill(p, x, positions, cfg: ArchConfig, *, s_max: Optional[int] = None, mesh=None):
    """Returns (out, cache {"ckv" [B, S_max, kvr], "krope" [B, S_max, rd]});
    on a ``mesh`` the attention runs through ``_heads_on_mesh``."""
    q_nope, q_rope = _q_proj(p, x, positions, cfg)
    ckv, k_rope = _kv_latent(p, x, positions, cfg)
    out = _attend(p, q_nope, q_rope, ckv, k_rope, cfg, mask_spec=MaskSpec(causal=True), mesh=mesh)
    pad = (s_max or x.shape[1]) - x.shape[1]

    def to_cache(a):
        return F.pad(a, (0, 0, 0, pad)) if pad else a
    return out, {"ckv": _rows_local(to_cache, ckv), "krope": _rows_local(to_cache, k_rope)}


def mla_decode(p, x, pos: int, cache: dict, cfg: ArchConfig, *, mesh=None):
    """x [B, 1, D]; the cache is written at ``pos`` in place and returned.
    On a ``mesh`` (DTensor caches) through ``layers._decode_on_mesh``."""
    at = torch.tensor([[pos]], device=x.device)
    q_nope, q_rope = _q_proj(p, x, at, cfg)
    ckv_new, krope_new = _kv_latent(p, x, at, cfg)
    ckv = cache_write(cache["ckv"], ckv_new, pos, cfg.decode_cache_update)
    krope = cache_write(cache["krope"], krope_new, pos, cfg.decode_cache_update)
    if mesh is not None and _is_dtensor(ckv):
        out = _decode_mesh(p, q_nope, q_rope, ckv, krope, cfg, pos)
    else:
        mask = torch.arange(ckv.shape[1], device=x.device)[None, None, :] <= pos
        out = _attend(p, q_nope, q_rope, ckv, krope, cfg, mask)
    return out, {"ckv": ckv, "krope": krope}


def _decode_mesh(p, q_nope, q_rope, ckv, krope, cfg: ArchConfig, pos: int):
    """``_attend`` of one query over length-sharded DTensor caches: the
    logits and e @ V of each rank's keys (``_decode_on_mesh``), then ``wo``."""
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5

    def up(c, w):                                   # [B, L, kvr] @ [kvr, H, k] -> [B, L, H, k] f32
        r, H, k = w.shape
        return (c @ w.reshape(r, H * k).to(c.dtype)).view(*c.shape[:2], H, k).float()

    def scores(qn, qr, c, kr, wuk, wuv):
        return (torch.einsum("bqhk,bshk->bhqs", qn.float(), up(c, wuk))
                + torch.einsum("bqhk,bsk->bhqs", qr.float(), kr.float())) * scale

    def weigh(e, c, kr, wuk, wuv):
        return torch.einsum("bhqs,bshk->bqhk", e, up(c, wuv))

    def rows(t):                                    # [B, H, 1, 1] -> [B, 1, H, 1]
        return t.permute(0, 2, 1, 3)

    o = _decode_on_mesh((q_nope, q_rope), (ckv, krope), lambda kp: kp <= pos, cfg.flash_decode, scores, weigh,
                        rows, weights=(p["wuk"], p["wuv"]))
    return _out_proj(p, o)
