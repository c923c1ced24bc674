"""Wrapper of the attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py:attention_pallas_call``
(``_attn_kernel``) on the model's prefill path. On CUDA tensors it
launches one of the source's two kernels, by dtype: bfloat16 goes to the
tensor-core kernel (wgmma + TMA; head dims ``TC_HEAD_DIMS`` only, any
other raises), float32 to the CUDA-core kernel (exact f32 products).
Each launch counts in ``launches`` and in its route's own count. On CPU
tensors it runs ``ref.gqa_attend``, ends aligned through
``MaskSpec.offset``. What bounds the kernels and how their design
answers that is in the source's note.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import MaskSpec, gqa_attend

launches = 0        # kernel launches in this process (the CPU path does not count)
launches_bf16 = 0   # of which the bf16 tensor-core kernel
launches_f32 = 0    # of which the f32 CUDA-core kernel
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (32, 64, 128, 256)   # head dims the tensor-core kernel takes


def flash_attention(
    q: torch.Tensor,     # [B, Lq, H, D]
    k: torch.Tensor,     # [B, Lk, KV, D]
    v: torch.Tensor,     # [B, Lk, KV, D]
    *,
    causal: bool = True,
    window: int = 0,     # 0 = unbounded; else only the last `window` keys
) -> torch.Tensor:
    """Blocked attention with ends aligned (query i at position i + Lk - Lq);
    returns [B, Lq, H, D] in q's dtype. Query head h reads KV head
    h // (H / KV)."""
    global launches, launches_bf16, launches_f32
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Lq,H,D], k = v [B,Lk,KV,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, H, D = q.shape
    _, Lk, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair (H % KV must be 0)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if (causal or window > 0) and Lq > Lk:
        raise ValueError(f"a masked attention needs Lq <= Lk (ends aligned), got {Lq} > {Lk}")
    if not q.is_cuda:
        return gqa_attend(q, k, v, mask_spec=MaskSpec(causal=causal, window=window, offset=Lk - Lq))
    from .._build import launch

    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, float32 or bfloat16; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    bf16 = q.dtype == torch.bfloat16
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    if bf16 and D not in TC_HEAD_DIMS:
        raise ValueError(f"the bf16 tensor-core kernel takes head dims {TC_HEAD_DIMS}, got {D}")
    if bf16 and Lk == 0:
        raise ValueError("the bf16 tensor-core kernel needs at least one key")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 tensor-core kernel reads q, k, v by TMA: 16-byte aligned bases")
    out = torch.empty_like(q)
    if out.numel():
        launch("lm_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               B, Lq, Lk, H, KV, D, int(causal), int(window), ctypes.c_float(D ** -0.5), int(bf16))
        launches += 1
        if bf16:
            launches_bf16 += 1
        else:
            launches_f32 += 1
    return out
