"""Wrapper of the traversal kernel (``csrc/tree_traverse.cu``).

Replaces ``repro/kernels/tree_traverse/kernel.py:traverse_block``. On
CUDA tensors it launches the kernel (counted in ``launches``); on CPU
tensors it runs ``ref.py``. What bounds the kernel and how its design
answers that is in the source's note; ``traverse_plan`` sizes its tiles.

Order of the sums. The reference has two: its plain version
(``repro/kernels/tree_traverse/ref.py:traverse_ref``) adds the chunk's
trees and then the carry, ``carry + (p_0 + p_1 + ...)``; its Pallas
kernel seeds the output with the carry and adds each tree to it,
``((carry + p_0) + p_1) + ...``. The two are equal when the carry is
zero, i.e. for the first chunk, and differ by rounding after it. The
port follows ``traverse_ref`` on both of its paths (the kernel and
``ref.py`` agree bitwise), so against the reference's Pallas kernel the
chunked CPU test holds scores to rtol 1e-6 and argmax exactly.
"""
from __future__ import annotations

import functools

import torch

from .ref import traverse_block_ref

launches = 0   # kernel launches in this process (the CPU path does not count)

SMEM_BYTES = 232448     # shared memory one block may use on sm_90 (227 KiB)
MAX_FEATURES = 65536    # feature ids that ride in 16 bits of the narrow packed node


def _smem(TN: int, Fs: int) -> int:
    return -(-TN * Fs // 16) * 16


@functools.lru_cache(maxsize=256)
def traverse_plan(F: int) -> dict:
    """Tile plan of one launch: TN samples per block (one thread each),
    the bins' row stride Fs in shared memory (an odd number of words),
    the block's shared-memory bytes and the node layout. TN is 128,
    halved for a wide F until the bins fit. A small batch gains nothing
    from shorter blocks: each thread's walk is a chain of dependent loads
    however many SMs hold the batch (blocks of 32, 64 and 128 rows take
    the same call time at N 256, PERF.md).

    Past ``MAX_FEATURES`` a feature id does not fit the narrow node's 16
    bits: the plan is ``wide``, an int4 node with a 32-bit feature id,
    and the bins stay in device memory (no shared memory), 128 rows a
    block."""
    if F > MAX_FEATURES:
        return {"TN": 128, "Fs": 0, "smem_bytes": 0, "wide": True}
    Fs = -(-F // 4) * 4
    if (Fs // 4) % 2 == 0:
        Fs += 4
    TN = 128
    while TN > 1 and _smem(TN, Fs) > SMEM_BYTES:
        TN //= 2
    return {"TN": TN, "Fs": Fs, "smem_bytes": _smem(TN, Fs), "wide": False}


def traverse_block(
    x_binned: torch.Tensor,      # [N, F] uint8
    feature: torch.Tensor,       # [tc, P] int32
    threshold: torch.Tensor,     # [tc, P] int32
    left_child: torch.Tensor,    # [tc, P] int32
    payload: torch.Tensor,       # [tc, P, C] float32
    carry,                       # [N, C] float32 running scores, or None (zeros)
    *,
    depth: int,
) -> torch.Tensor:
    """Fold one tree chunk's weighted votes into the running [N, C] scores."""
    global launches
    N, F = x_binned.shape
    tc, P = feature.shape
    C = payload.shape[-1]
    if x_binned.dtype != torch.uint8:
        raise TypeError(f"x_binned must be uint8, got {x_binned.dtype}")
    for name, a in (("feature", feature), ("threshold", threshold), ("left_child", left_child)):
        if a.dtype != torch.int32 or tuple(a.shape) != (tc, P):
            raise TypeError(f"{name} must be int32 [{tc}, {P}]")
    if payload.dtype != torch.float32 or tuple(payload.shape) != (tc, P, C):
        raise TypeError(f"payload must be float32 [{tc}, {P}, {C}]")
    if carry is None:
        carry = torch.zeros((N, C), dtype=torch.float32, device=x_binned.device)
    if carry.dtype != torch.float32 or tuple(carry.shape) != (N, C):
        raise TypeError(f"carry must be float32 [{N}, {C}]")
    devs = {a.device for a in (x_binned, feature, threshold, left_child, payload, carry)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if not x_binned.is_cuda:
        return traverse_block_ref(
            x_binned, feature, threshold, left_child, payload, carry, depth=depth
        )
    from .._build import launch

    plan = traverse_plan(F)
    x_binned, feature, threshold, left_child, payload, carry = (
        a.contiguous() for a in (x_binned, feature, threshold, left_child, payload, carry)
    )
    out = torch.empty((N, C), dtype=torch.float32, device=x_binned.device)
    words = 4 if plan["wide"] else 2           # int4 or int2 packed nodes
    packed = torch.empty((tc, P + (P & 1), words), dtype=torch.int32, device=x_binned.device)
    launch(
        "prf_traverse", x_binned.data_ptr(), N, F, feature.data_ptr(),
        threshold.data_ptr(), left_child.data_ptr(), payload.data_ptr(),
        carry.data_ptr(), out.data_ptr(), packed.data_ptr(), tc, P, C, depth,
        plan["Fs"], plan["TN"], plan["smem_bytes"], int(plan["wide"]),
    )
    launches += 1
    return out
