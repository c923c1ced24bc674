"""Wrappers of the attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``).

The forward replaces ``repro/kernels/flash_attention/kernel.py:
attention_pallas_call`` (``_attn_kernel``) on the model's prefill and
training paths. On CUDA tensors it launches one of the source's two
kernels, by dtype: bfloat16 goes to the tensor-core kernel (wgmma + TMA),
float32 to the CUDA-core kernel (exact f32 products). Both take every
head dim up to ``MAX_HEAD_DIM``; a bf16 head dim that is no multiple of
8 (TMA's 16-byte row rule) is padded here with zero columns, which add
nothing to Q Kᵀ, and the output's padded columns are dropped. Each
launch counts in ``launches`` and in its route's own count. On CPU
tensors it runs ``ref.gqa_attend``, ends aligned through
``MaskSpec.offset``. What bounds the kernels and how their design
answers that is in the source's note.

Under autograd (grad enabled and an input that requires grad)
``flash_attention`` goes through ``FlashAttentionFn``: its forward runs
the same kernel, which also writes each row's log-sum-exp, and its
backward calls the backward kernels (no TPU counterpart: the reference
differentiates its einsums with XLA), counted in ``launches_bwd`` and
its route's count. The route follows dtype and head dim
(``bwd_route``): bf16 at a padded head dim of 32, 64 or 128 runs the
tensor-core kernels (wgmma + TMA, dK / dV and dQ blocks in one launch;
``launches_bwd_tc``), the head dim padded to a multiple of 8 with zero
columns in q, k, v, out and dout and the gradients' padded columns
dropped; bf16 at 192 or 256 runs the CUDA-core kernels
(``launches_bwd_bf16_fma``; their tensor-core form is still to do); f32
runs the CUDA-core kernels (``launches_bwd_f32``).
On CPU tensors the two halves are ``ref.gqa_attend_lse`` and
``ref.attention_bwd_ref``. On the card nothing falls back to the plain
versions or to another route: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .ref import MaskSpec, attention_bwd_ref, gqa_attend, gqa_attend_lse

launches = 0        # forward kernel launches in this process (the CPU path does not count)
launches_bf16 = 0   # of which the bf16 tensor-core kernel
launches_f32 = 0    # of which the f32 CUDA-core kernel
launches_bwd = 0        # backward calls (tensor cores: two launches, delta and dK / dV + dQ; else three)
launches_bwd_bf16 = 0   # of which on bf16 tensors
launches_bwd_tc = 0     # of those, on the tensor-core kernels (padded head dim <= 128)
launches_bwd_bf16_fma = 0   # and on the CUDA-core kernels (padded head dim 192 / 256)
launches_bwd_f32 = 0    # of which on f32 tensors
MAX_TC_BWD_HEAD_DIM = 128   # the widest head dim of the tensor-core backward
MAX_HEAD_DIM = 256


def _check(q, k, v, causal, window, prefix):
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


def _check_cuda(tensors, D):
    if any(t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError("q, k, v (and out, dout) must share one dtype, float32 or bfloat16; got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")


def _spec(q, k, causal, window, prefix) -> MaskSpec:
    return MaskSpec(causal=causal, window=window, offset=k.shape[1] - q.shape[1], prefix=prefix)


def _forward(q, k, v, causal, window, prefix, want_lse):
    """The forward kernel on CUDA tensors; returns (out, lse [B, H, Lq] f32 or None)."""
    global launches, launches_bf16, launches_f32
    from .._build import launch

    B, Lq, H, D = q.shape
    _, Lk, KV, _ = k.shape
    _check_cuda((q, k, v), D)
    bf16 = q.dtype == torch.bfloat16
    if bf16 and Lk == 0:
        raise ValueError("the bf16 tensor-core kernel needs at least one key")
    Dk = -(-D // 8) * 8 if bf16 else D          # the head dim the kernel reads
    if Dk != D:
        q, k, v = (F.pad(t, (0, Dk - D)) for t in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 tensor-core kernel reads q, k, v by TMA: 16-byte aligned bases")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device) if want_lse else None
    if out.numel():
        launch("lm_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               None if lse is None else lse.data_ptr(), B, Lq, Lk, H, KV, Dk, int(causal), int(window),
               int(prefix), ctypes.c_float(D ** -0.5), int(bf16))
        launches += 1
        if bf16:
            launches_bf16 += 1
        else:
            launches_f32 += 1
    return (out if Dk == D else out[..., :D].contiguous()), lse


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
    h // (H / KV). The mask is (causal and window) or key < prefix.
    Differentiable: under autograd it runs ``FlashAttentionFn``."""
    _check(q, k, v, causal, window, prefix)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, prefix)
    if not q.is_cuda:
        return gqa_attend(q, k, v, mask_spec=_spec(q, k, causal, window, prefix))
    return _forward(q, k, v, causal, window, prefix, want_lse=False)[0]


def flash_attention_lse(q, k, v, *, causal=True, window=0, prefix=0):
    """The forward with each row's log-sum-exp: (out [B, Lq, H, D], lse
    [B, H, Lq] f32), the kernel's on CUDA tensors, ``gqa_attend_lse`` on the CPU."""
    _check(q, k, v, causal, window, prefix)
    if not q.is_cuda:
        return gqa_attend_lse(q, k, v, mask_spec=_spec(q, k, causal, window, prefix))
    return _forward(q, k, v, causal, window, prefix, want_lse=True)


def bwd_route(dtype: torch.dtype, D: int) -> tuple[bool, int]:
    """(tensor cores?, the head dim the backward kernels read) for q's dtype
    and head dim D: bf16 whose head dim, padded to a multiple of 8, is at
    most ``MAX_TC_BWD_HEAD_DIM`` runs the tensor-core kernels at that padded
    width; anything else the CUDA-core kernels at D."""
    Dk = -(-D // 8) * 8
    if dtype == torch.bfloat16 and Dk <= MAX_TC_BWD_HEAD_DIM:
        return True, Dk
    return False, D


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0, prefix=0):
    """(dq, dk, dv) in the inputs' dtype from the forward's ``out`` and
    ``lse``: the backward kernels on CUDA tensors (route by ``bwd_route``;
    f32 accumulators; deterministic), ``attention_bwd_ref`` on the CPU."""
    global launches_bwd, launches_bwd_bf16, launches_bwd_tc, launches_bwd_bf16_fma, launches_bwd_f32
    _check(q, k, v, causal, window, prefix)
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"out and dout must be q's shape {tuple(q.shape)} and lse [B, H, Lq]; got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, {tuple(lse.shape)}")
    if not q.is_cuda:
        return attention_bwd_ref(q, k, v, out, lse, dout, _spec(q, k, causal, window, prefix))
    from .._build import launch

    B, Lq, H, D = q.shape
    _, Lk, KV, _ = k.shape
    _check_cuda((q, k, v, out, dout), D)
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    tc, Dk = bwd_route(q.dtype, D)
    if not tc and B * max(H, KV) > 65535:
        raise ValueError(f"batch x heads {B * H} > 65535 blocks of the grid's second axis")
    if Lq == 0 or Lk == 0 or B * H * D == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if Dk != D:
        q, k, v, out, dout = (F.pad(t, (0, Dk - D)) for t in (q, k, v, out, dout))
    q, k, v, out, dout, lse = (t.contiguous() for t in (q, k, v, out, dout, lse))
    if tc and any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("the bf16 tensor-core backward reads q, k, v, out, dout by TMA and in pairs: "
                         "16-byte aligned bases")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bf16 = q.dtype == torch.bfloat16
    # row-term scratch: per 64-query tile lse and delta (tensor cores), else delta [B, H, Lq]
    n_scratch = B * H * (-(-Lq // 64) * 128 if tc else Lq)
    delta = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    launch("lm_flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           B, Lq, Lk, H, KV, Dk, int(causal), int(window), int(prefix), ctypes.c_float(D ** -0.5), int(bf16))
    launches_bwd += 1
    if bf16:
        launches_bwd_bf16 += 1
        if tc:
            launches_bwd_tc += 1
        else:
            launches_bwd_bf16_fma += 1
    else:
        launches_bwd_f32 += 1
    if Dk != D:
        dq, dk, dv = (g[..., :D].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a hand-written backward: the forward kernel writes the
    LSE beside its output, and the backward kernel takes q, k, v, out and
    lse. ``apply(q, k, v, causal, window, prefix)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window, prefix=prefix)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, prefix)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, prefix = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window,
                                         prefix=prefix)
        return dq, dk, dv, None, None, None
