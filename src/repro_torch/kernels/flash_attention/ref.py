"""Plain PyTorch versions of the attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``).

``attention_ref`` is the reference's oracle (``repro/kernels/flash_attention/
ref.py``) on ``[BH, L, D]`` with ``-inf`` masks. ``gqa_attend`` with a
``MaskSpec`` is the plain version of the kernel in the model's layout
(``repro/models/layers.py``): the kernel's CPU path, the model's
``use_kernels=False`` path and the yardstick the kernel is held to.
``gqa_attend_lse`` is the same forward returning each row's log-sum-exp,
and ``attention_bwd_ref`` the backward from it (FlashAttention-2's
formulas): the CPU path of the training forward and backward and the
yardstick of the backward kernel. The reference has no backward of its
own beyond differentiating ``gqa_attend``'s einsums.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

MASKED = -1e30   # the logit of a masked key


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Parametric attention mask, built per query block, never at [Sq, Sk]."""
    causal: bool = True
    window: int = 0
    offset: int = 0      # qpos = q_index + offset (ends-aligned: Sk - Sq)
    prefix: int = 0      # first `prefix` key positions always visible (hymba's meta tokens)

    def block(self, q0: int, qc: int, sk: int, device=None) -> torch.Tensor:
        qpos = (torch.arange(qc, device=device) + q0 + self.offset)[:, None]
        kpos = torch.arange(sk, device=device)[None, :]
        m = torch.ones((qc, sk), dtype=torch.bool, device=device)
        if self.causal:
            m &= kpos <= qpos
        if self.window > 0:
            m &= kpos > qpos - self.window
        if self.prefix > 0:
            m |= kpos < self.prefix
        return m[None]


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, prefix: int = 0) -> torch.Tensor:
    """q [BH, Lq, D], k/v [BH, Lk, D] -> [BH, Lq, D] in q's dtype."""
    lq, lk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    mask = MaskSpec(causal=causal, window=window, offset=lk - lq, prefix=prefix).block(0, lq, lk, q.device)
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def gqa_attend(
    q: torch.Tensor,     # [B, Sq, H, hd]
    k: torch.Tensor,     # [B, Sk, KV, hd]
    v: torch.Tensor,     # [B, Sk, KV, hd]
    *,
    mask_spec: Optional[MaskSpec] = None,       # parametric mask (None: all keys)
    q_chunk: int = 0,
) -> torch.Tensor:
    """Plain GQA attention: KV heads repeated to H, f32 logits, masked
    logits -1e30, f32 softmax. ``q_chunk`` loops over query blocks so the
    [Sq, Sk] logits never exist at full size (exact)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        G = H // KV
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    Sk = k.shape[1]
    kf, vf = k.float(), v.float()

    def attend_block(qb, q0):
        logits = torch.einsum("bqhd,bshd->bhqs", qb.float(), kf) * (hd ** -0.5)
        if mask_spec is not None:
            m = mask_spec.block(q0, qb.shape[1], Sk, q.device)
            logits = torch.where(m[:, None], logits, MASKED)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", probs, vf).to(q.dtype)

    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        return torch.cat([attend_block(q[:, i:i + q_chunk], i) for i in range(0, Sq, q_chunk)], dim=1)
    return attend_block(q, 0)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 arithmetic for f32 and bf16 inputs; f64 stays f64 (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _grouped_logits(q, k, mask_spec, ct):
    """[B, KV, G, Sq, Sk] scaled logits, masked to MASKED: query head
    kv * G + g against KV head kv, no repeat of K."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.to(ct).reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(ct)) * hd ** -0.5
    if mask_spec is not None:
        s = torch.where(mask_spec.block(0, Sq, Sk, q.device)[:, None, None], s, MASKED)
    return qg, s


def gqa_attend_lse(q, k, v, *, mask_spec: Optional[MaskSpec] = None):
    """``gqa_attend`` that also returns lse [B, H, Sq] (f32; f64 for f64
    inputs): the natural log of each row's softmax denominator over the
    scaled, masked logits. Out is exp(logits - lse) V in q's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    ct = _acc_dtype(q.dtype)
    _, s = _grouped_logits(q, k, mask_spec, ct)
    lse = torch.logsumexp(s, dim=-1)                                     # [B, KV, G, Sq]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(ct)).reshape(B, Sq, H, hd)
    return out.to(q.dtype), lse.reshape(B, H, Sq)


def attention_bwd_ref(q, k, v, o, lse, do, mask_spec: Optional[MaskSpec] = None):
    """Gradients (dq, dk, dv) of ``sum(o * do)`` for o = attention(q, k, v)
    under ``mask_spec`` (None: every key), given the forward's o and lse
    [B, H, Sq]; FlashAttention-2's formulas in f32 (f64 for f64 inputs):
    P = exp(S - lse), dV = Pᵀ dO, dP = dO Vᵀ, D = rowsum(dO ∘ O),
    dS = P ∘ (dP - D), dQ = scale dS K, dK = scale dSᵀ Q. dK and dV of a KV
    head sum over its H / KV query heads. Each gradient in its input's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    ct = _acc_dtype(q.dtype)
    qg, s = _grouped_logits(q, k, mask_spec, ct)
    p = torch.exp(s - lse.to(ct).reshape(B, KV, G, Sq)[..., None])      # masked: exactly 0
    dog = do.to(ct).reshape(B, Sq, KV, G, hd)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.to(ct))
    delta = (dog * o.to(ct).reshape(B, Sq, KV, G, hd)).sum(-1).permute(0, 2, 3, 1)   # [B, KV, G, Sq]
    ds = p * (dp - delta[..., None])
    scale = hd ** -0.5
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(ct)).reshape(B, Sq, H, hd) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
