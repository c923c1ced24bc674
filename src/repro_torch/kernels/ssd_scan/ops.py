"""Wrapper of the SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan/kernel.py:ssd_pallas_call``
(``_ssd_kernel``) on the Mamba-2 prefill path. On CUDA tensors it
launches one of the source's two kernels, by dtype: bfloat16 goes to the
tensor-core kernel (wgmma + TMA; head dims ``TC_HEAD_DIMS`` and state
sizes ``TC_STATES`` only, any other raises), float32 to the CUDA-core
kernel (exact f32 products). Each launch counts in ``launches`` and in
its route's own count. On CPU tensors it runs ``ref.ssd_chunked``. What
bounds the kernels and how their design answers that is in the source's
note.
"""
from __future__ import annotations

import torch

from .ref import ssd_chunked

launches = 0        # kernel launches in this process (the CPU path does not count)
launches_bf16 = 0   # of which the bf16 tensor-core kernel
launches_f32 = 0    # of which the f32 CUDA-core kernel
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 256   # the f32 kernel's limits
TC_HEAD_DIMS, TC_STATES = (32, 64), (16, 32, 64, 128)   # shapes the tensor-core kernel takes


def ssd_scan(
    x: torch.Tensor,      # [B, L, H, P]
    loga: torch.Tensor,   # [B, L, H] log decay (<= 0)
    b: torch.Tensor,      # [B, L, N] shared over heads
    c: torch.Tensor,      # [B, L, N] shared over heads
    *,
    chunk: int = 128,
):
    """SSD scan from h = 0. Returns (y [B, L, H, P] in x's dtype, h_final
    [B, H, N, P] f32). The f32 kernel and the CPU path walk chunks of
    ``min(chunk, L)`` steps, which must divide ``L``; the bf16 kernel
    ignores ``chunk``, walks 64-step chunks of its own and takes any ``L``."""
    global launches, launches_bf16, launches_f32
    if x.dim() != 4 or loga.shape != x.shape[:3] or b.dim() != 3 or b.shape != c.shape:
        raise ValueError(f"want x [B,L,H,P], loga [B,L,H], b = c [B,L,N]; got {tuple(x.shape)}, "
                         f"{tuple(loga.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    B, L, H, P = x.shape
    N = b.shape[-1]
    if b.shape[:2] != (B, L):
        raise ValueError(f"b {tuple(b.shape)} does not pair with x {tuple(x.shape)}")
    chunk = min(chunk, L)
    bf16_kernel = x.is_cuda and x.dtype == torch.bfloat16
    if not bf16_kernel and (chunk < 1 or L % chunk):
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    if not x.is_cuda:
        return ssd_chunked(x, loga, b, c, None, chunk)
    from .._build import launch

    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c must share one dtype, float32 or bfloat16; got {x.dtype}, "
                        f"{b.dtype}, {c.dtype}")
    bf16 = bf16_kernel
    if bf16 and (P not in TC_HEAD_DIMS or N not in TC_STATES):
        raise ValueError(f"the bf16 tensor-core kernel takes P in {TC_HEAD_DIMS}, N in {TC_STATES}; "
                         f"got P {P}, N {N}")
    if not bf16 and (chunk > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE):
        raise ValueError(f"the f32 kernel takes chunk <= {MAX_CHUNK}, P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE}; got {chunk}, {P}, {N}")
    x, b, c = x.contiguous(), b.contiguous(), c.contiguous()
    if bf16 and any(t.data_ptr() % 16 for t in (x, b, c)):
        raise ValueError("the bf16 tensor-core kernel reads x, b, c by TMA: 16-byte aligned bases")
    loga = loga.float().contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel():
        launch("lm_ssd_scan", x.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(),
               y.data_ptr(), h.data_ptr(), B, L, H, P, N, chunk, int(bf16))
        launches += 1
        if bf16:
            launches_bf16 += 1
        else:
            launches_f32 += 1
    return y, h
