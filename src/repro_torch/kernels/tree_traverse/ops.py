"""Wrapper of the traversal kernel (``csrc/tree_traverse.cu``).

Replaces ``repro/kernels/tree_traverse/kernel.py:traverse_block``. On
CUDA tensors it launches the kernel (counted in ``launches``); on CPU
tensors it runs ``ref.py``. What bounds the kernel and how its design
answers that is in the source's note.
"""
from __future__ import annotations

import torch

from .ref import traverse_block_ref

launches = 0   # kernel launches in this process (the CPU path does not count)


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

    x_binned, feature, threshold, left_child, payload, carry = (
        a.contiguous() for a in (x_binned, feature, threshold, left_child, payload, carry)
    )
    out = torch.empty((N, C), dtype=torch.float32, device=x_binned.device)
    launch(
        "prf_traverse", x_binned.data_ptr(), N, F, feature.data_ptr(),
        threshold.data_ptr(), left_child.data_ptr(), payload.data_ptr(),
        carry.data_ptr(), out.data_ptr(), tc, P, C, depth,
    )
    launches += 1
    return out
