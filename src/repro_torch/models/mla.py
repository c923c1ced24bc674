"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437).

Counterpart of ``repro/models/mla.py``. Queries and KV are low-rank
compressed; the decode cache holds only the compressed KV latent
(``kv_lora_rank``) and the shared RoPE key (``qk_rope_dim``). The
reference attends in plain XLA (no Pallas kernel), so ``_attend`` is
plain PyTorch: its qk width (nope + rope, 192 at v3) differs from its v
width (128), which the attention kernel does not take. Queries are
chunked by ``layers._auto_q_chunk``'s memory rule as well as the
reference's (exact: every chunk sees all keys).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ref import MASKED, MaskSpec
from .layers import _auto_q_chunk, _dense_init, _proj_heads, cache_write, init_rmsnorm, rmsnorm, rope_apply


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
    cq = rmsnorm(p["qnorm"], x @ p["wdq"].to(x.dtype))
    q = _proj_heads(cq, p["wuq"])
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, rope_apply(q_rope, positions, cfg.rope_theta)


def _kv_latent(p, x, positions, cfg: ArchConfig):
    ckv = rmsnorm(p["kvnorm"], x @ p["wdkv"].to(x.dtype))                        # [B, S, kvr]
    k_rope = rope_apply((x @ p["wkrope"].to(x.dtype))[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]                                  # [B, S, rd] shared
    return ckv, k_rope


def _attend(p, q_nope, q_rope, ckv, k_rope, cfg: ArchConfig, mask=None,
            mask_spec: Optional[MaskSpec] = None):
    """Score via decompressed keys; f32 softmax; queries chunked at long Sq
    or many heads."""
    k_nope = _proj_heads(ckv, p["wuk"]).float()
    v = _proj_heads(ckv, p["wuv"]).float()
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
    H_, vd, D = p["wo"].shape
    return o.reshape(B, Sq, H_ * vd) @ p["wo"].reshape(H_ * vd, D).to(o.dtype)


def mla_train(p, x, positions, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence causal MLA without a cache (plain, under autograd)."""
    q_nope, q_rope = _q_proj(p, x, positions, cfg)
    ckv, k_rope = _kv_latent(p, x, positions, cfg)
    return _attend(p, q_nope, q_rope, ckv, k_rope, cfg, mask_spec=MaskSpec(causal=True))


def mla_prefill(p, x, positions, cfg: ArchConfig, *, s_max: Optional[int] = None):
    """Returns (out, cache {"ckv" [B, S_max, kvr], "krope" [B, S_max, rd]})."""
    q_nope, q_rope = _q_proj(p, x, positions, cfg)
    ckv, k_rope = _kv_latent(p, x, positions, cfg)
    out = _attend(p, q_nope, q_rope, ckv, k_rope, cfg, mask_spec=MaskSpec(causal=True))
    pad = (s_max or x.shape[1]) - x.shape[1]
    if pad:
        ckv = F.pad(ckv, (0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
    return out, {"ckv": ckv, "krope": k_rope}


def mla_decode(p, x, pos: int, cache: dict, cfg: ArchConfig):
    """x [B, 1, D]; the cache is written at ``pos`` in place and returned."""
    at = torch.tensor([[pos]], device=x.device)
    q_nope, q_rope = _q_proj(p, x, at, cfg)
    ckv_new, krope_new = _kv_latent(p, x, at, cfg)
    ckv = cache_write(cache["ckv"], ckv_new, pos, cfg.decode_cache_update)
    krope = cache_write(cache["krope"], krope_new, pos, cfg.decode_cache_update)
    mask = torch.arange(ckv.shape[1], device=x.device)[None, None, :] <= pos
    out = _attend(p, q_nope, q_rope, ckv, krope, cfg, mask)
    return out, {"ckv": ckv, "krope": krope}
