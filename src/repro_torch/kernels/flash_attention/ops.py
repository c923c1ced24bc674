"""Wrapper of the attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py:attention_pallas_call``
(``_attn_kernel``) on the model's prefill path. On CUDA tensors it
launches one of the source's two kernels, by dtype: bfloat16 goes to the
tensor-core kernel (wgmma + TMA), float32 to the CUDA-core kernel (exact
f32 products). Both take every head dim up to ``MAX_HEAD_DIM``; a bf16
head dim that is no multiple of 8 (TMA's 16-byte row rule) is padded
here with zero columns, which add nothing to Q Kᵀ, and the output's
padded columns are dropped. Each launch counts in ``launches`` and in its
route's own count. On CPU tensors it runs ``ref.gqa_attend``, ends
aligned through ``MaskSpec.offset``. What bounds the kernels and how
their design answers that is in the source's note.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .ref import MaskSpec, gqa_attend

launches = 0        # kernel launches in this process (the CPU path does not count)
launches_bf16 = 0   # of which the bf16 tensor-core kernel
launches_f32 = 0    # of which the f32 CUDA-core kernel
MAX_HEAD_DIM = 256


def flash_attention(
    q: torch.Tensor,     # [B, Lq, H, D]
    k: torch.Tensor,     # [B, Lk, KV, D]
    v: torch.Tensor,     # [B, Lk, KV, D]
    *,
    causal: bool = True,
    window: int = 0,     # 0 = unbounded; else only the last `window` keys
    prefix: int = 0,     # the first `prefix` keys are visible to every query
) -> torch.Tensor:
    """Blocked attention with ends aligned (query i at position i + Lk - Lq);
    returns [B, Lq, H, D] in q's dtype. Query head h reads KV head
    h // (H / KV). The mask is (causal and window) or key < prefix."""
    global launches, launches_bf16, launches_f32
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Lq,H,D], k = v [B,Lk,KV,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, H, D = q.shape
    _, Lk, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair (H % KV must be 0)")
    if window < 0 or prefix < 0:
        raise ValueError(f"window and prefix must be >= 0, got {window}, {prefix}")
    if (causal or window > 0) and Lq > Lk:
        raise ValueError(f"a masked attention needs Lq <= Lk (ends aligned), got {Lq} > {Lk}")
    if not q.is_cuda:
        return gqa_attend(q, k, v, mask_spec=MaskSpec(causal=causal, window=window, offset=Lk - Lq,
                                                      prefix=prefix))
    from .._build import launch

    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, float32 or bfloat16; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    bf16 = q.dtype == torch.bfloat16
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    if bf16 and Lk == 0:
        raise ValueError("the bf16 tensor-core kernel needs at least one key")
    Dk = -(-D // 8) * 8 if bf16 else D          # the head dim the kernel reads
    if Dk != D:
        q, k, v = (F.pad(t, (0, Dk - D)) for t in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 tensor-core kernel reads q, k, v by TMA: 16-byte aligned bases")
    out = torch.empty_like(q)
    if out.numel():
        launch("lm_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               B, Lq, Lk, H, KV, Dk, int(causal), int(window), int(prefix), ctypes.c_float(D ** -0.5),
               int(bf16))
        launches += 1
        if bf16:
            launches_bf16 += 1
        else:
            launches_f32 += 1
    return out if Dk == D else out[..., :D].contiguous()
