"""Wrapper of the SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan/kernel.py:ssd_pallas_call``
(``_ssd_kernel``) on the Mamba-2 prefill path. On CUDA tensors it
launches the kernel (counted in ``launches``); on CPU tensors it runs
``ref.ssd_chunked``. What bounds the kernel and how its design answers
that is in the source's note.
"""
from __future__ import annotations

import torch

from .ref import ssd_chunked

launches = 0   # kernel launches in this process (the CPU path does not count)
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 256


def ssd_scan(
    x: torch.Tensor,      # [B, L, H, P]
    loga: torch.Tensor,   # [B, L, H] log decay (<= 0)
    b: torch.Tensor,      # [B, L, N] shared over heads
    c: torch.Tensor,      # [B, L, N] shared over heads
    *,
    chunk: int = 128,
):
    """SSD scan from h = 0 in chunks of ``min(chunk, L)`` (``L`` must divide).
    Returns (y [B, L, H, P] in x's dtype, h_final [B, H, N, P] f32)."""
    global launches
    if x.dim() != 4 or loga.shape != x.shape[:3] or b.dim() != 3 or b.shape != c.shape:
        raise ValueError(f"want x [B,L,H,P], loga [B,L,H], b = c [B,L,N]; got {tuple(x.shape)}, "
                         f"{tuple(loga.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    B, L, H, P = x.shape
    N = b.shape[-1]
    if b.shape[:2] != (B, L):
        raise ValueError(f"b {tuple(b.shape)} does not pair with x {tuple(x.shape)}")
    chunk = min(chunk, L)
    if chunk < 1 or L % chunk:
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    if not x.is_cuda:
        return ssd_chunked(x, loga, b, c, None, chunk)
    from .._build import launch

    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c must share one dtype, float32 or bfloat16; got {x.dtype}, "
                        f"{b.dtype}, {c.dtype}")
    if chunk > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"the kernel takes chunk <= {MAX_CHUNK}, P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE}; got {chunk}, {P}, {N}")
    x, b, c = x.contiguous(), b.contiguous(), c.contiguous()
    loga = loga.float().contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel():
        launch("lm_ssd_scan", x.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(),
               y.data_ptr(), h.data_ptr(), B, L, H, P, N, chunk, int(x.dtype == torch.bfloat16))
        launches += 1
    return y, h
