"""Wrappers of the SSD chunked-scan kernels (``csrc/ssd_scan.cu``,
``csrc/ssd_scan_bwd.cu``).

The forward replaces ``repro/kernels/ssd_scan/kernel.py:ssd_pallas_call``
(``_ssd_kernel``) on the Mamba-2 prefill and training paths. On CUDA
tensors it launches one of the source's two kernels, by dtype: bfloat16
goes to the tensor-core kernel (wgmma + TMA; head dims ``TC_HEAD_DIMS``
and state sizes ``TC_STATES`` only, any other raises), float32 to the
CUDA-core kernel (exact f32 products). Each launch counts in ``launches``
and in its route's own count. On CPU tensors it runs ``ref.ssd_chunked``.
What bounds the kernels and how their design answers that is in the
source's note.

The training path (``models/mamba.mamba_train``) runs ``SSDScanFn``:
its forward is the forward kernel's y (the final state is no output
there: training never reads it), its backward under autograd
``ssd_scan_bwd``, the backward kernel (no TPU counterpart: the
reference differentiates its chunked einsums with XLA), f32 arithmetic
on the CUDA cores for both dtypes, one call counted in ``launches_bwd``
and its dtype's count. On CPU tensors the two halves are
``ref.ssd_chunked`` and ``ref.ssd_chunked_bwd``. On the card nothing
falls back to the plain versions: a failed build or launch raises.
"""
from __future__ import annotations

import torch

from .ref import ssd_chunked, ssd_chunked_bwd

launches = 0        # kernel launches in this process (the CPU path does not count)
launches_bf16 = 0   # of which the bf16 tensor-core kernel
launches_f32 = 0    # of which the f32 CUDA-core kernel
launches_bwd = 0        # backward calls (two launches each: the block walk, then the head sums of db, dc)
launches_bwd_bf16 = 0   # of which on bf16 tensors
launches_bwd_f32 = 0    # of which on f32 tensors
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 256   # the f32 kernel's limits
TC_HEAD_DIMS, TC_STATES = (32, 64), (16, 32, 64, 128)   # shapes the tensor-core kernel takes
BWD_HEAD_DIMS, BWD_STATES = (32, 64), (16, 32, 64, 128)  # shapes the backward kernel takes
BWD_CHUNK = 64      # steps per chunk of the backward kernel, whatever chunk the forward walked


def _check(x, loga, b, c):
    if x.dim() != 4 or loga.shape != x.shape[:3] or b.dim() != 3 or b.shape != c.shape:
        raise ValueError(f"want x [B,L,H,P], loga [B,L,H], b = c [B,L,N]; got {tuple(x.shape)}, "
                         f"{tuple(loga.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    if b.shape[:2] != x.shape[:2]:
        raise ValueError(f"b {tuple(b.shape)} does not pair with x {tuple(x.shape)}")


def _check_dtypes(x, b, c, *more):
    if x.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != x.dtype for t in (b, c, *more)):
        raise TypeError(f"x, b, c (and dy) must share one dtype, float32 or bfloat16; got "
                        + ", ".join(str(t.dtype) for t in (x, b, c, *more)))


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
    _check(x, loga, b, c)
    B, L, H, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, L)
    bf16_kernel = x.is_cuda and x.dtype == torch.bfloat16
    if not bf16_kernel and (chunk < 1 or L % chunk):
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    if not x.is_cuda:
        return ssd_chunked(x, loga, b, c, None, chunk)
    from .._build import launch

    _check_dtypes(x, b, c)
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


def ssd_scan_bwd(x, loga, b, c, dy, *, chunk: int = 128):
    """(dx, dloga, db, dc) of ``ssd_scan``'s y against ``dy`` [B, L, H, P]
    (in x's, loga's, b's and c's dtypes). CUDA tensors: the backward kernel
    (64-step chunks of its own, any ``L``; P in ``BWD_HEAD_DIMS``, N in
    ``BWD_STATES``, else ``ValueError``; f32 arithmetic; bitwise run to
    run). CPU tensors: ``ref.ssd_chunked_bwd`` in chunks of
    ``min(chunk, L)``, which must divide ``L``."""
    global launches_bwd, launches_bwd_bf16, launches_bwd_f32
    _check(x, loga, b, c)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be x's shape {tuple(x.shape)}")
    B, L, H, P = x.shape
    N = b.shape[-1]
    if not x.is_cuda:
        chunk = min(chunk, L)
        if chunk < 1 or L % chunk:
            raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
        return ssd_chunked_bwd(x, loga, b, c, dy, chunk)
    from .._build import launch

    _check_dtypes(x, b, c, dy)
    if P not in BWD_HEAD_DIMS or N not in BWD_STATES:
        raise ValueError(f"the SSD backward kernel takes P in {BWD_HEAD_DIMS}, N in {BWD_STATES}; got "
                         f"x {tuple(x.shape)}, b {tuple(b.shape)}")
    if loga.dtype != torch.float32:
        raise TypeError(f"loga must be float32, got {loga.dtype}")
    if x.numel() == 0:
        return torch.zeros_like(x), torch.zeros_like(loga), torch.zeros_like(b), torch.zeros_like(c)
    x, loga, b, c, dy = (t.contiguous() for t in (x, loga, b, c, dy))
    dx, dloga = torch.empty_like(x), torch.empty_like(loga)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    f32 = dict(dtype=torch.float32, device=x.device)
    states = torch.empty((B, H, -(-L // BWD_CHUNK), N, P), **f32)      # the state entering each chunk
    db_part, dc_part = torch.empty((B, H, L, N), **f32), torch.empty((B, H, L, N), **f32)
    bf16 = x.dtype == torch.bfloat16
    launch("lm_ssd_scan_bwd", x.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
           dx.data_ptr(), dloga.data_ptr(), db.data_ptr(), dc.data_ptr(), states.data_ptr(),
           db_part.data_ptr(), dc_part.data_ptr(), B, L, H, P, N, int(bf16))
    launches_bwd += 1
    if bf16:
        launches_bwd_bf16 += 1
    else:
        launches_bwd_f32 += 1
    return dx, dloga, db, dc


class SSDScanFn(torch.autograd.Function):
    """The SSD scan's y with a hand-written backward: the forward kernel,
    then ``ssd_scan_bwd`` on the saved inputs (the backward recomputes the
    chunk states; nothing else is kept). ``apply(x, loga, b, c, chunk)``."""

    @staticmethod
    def forward(ctx, x, loga, b, c, chunk):
        y, _ = ssd_scan(x, loga, b, c, chunk=chunk)
        ctx.save_for_backward(x, loga, b, c)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, loga, b, c = ctx.saved_tensors
        dx, dloga, db, dc = ssd_scan_bwd(x, loga, b, c, dy, chunk=ctx.chunk)
        return dx, dloga, db, dc, None
