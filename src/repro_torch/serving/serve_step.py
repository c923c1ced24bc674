"""Batched greedy decoding (counterpart of ``repro/serving/serve_step.py``).

The reference's ``make_serve_fns`` is mesh and jit glue; PyTorch runs
eagerly on one device, so only the loop is ported.
"""
from __future__ import annotations

import torch

from ..models.model import Model


@torch.no_grad()
def greedy_generate(model: Model, tokens, extras=None, *, steps: int, s_max: int) -> torch.Tensor:
    """Prefill the prompts [B, S] (``extras``: ``Model.prefill``'s vision
    embeddings or frames), then decode greedily; returns [B, steps] int32."""
    logits, cache = model.prefill(tokens, extras, s_max=s_max)
    out = [torch.argmax(logits, -1)]
    pos = tokens.shape[1]
    for i in range(steps - 1):
        logits, cache = model.decode_step(cache, out[-1], pos + i)
        out.append(torch.argmax(logits, -1))
    return torch.stack(out, dim=1).to(torch.int32)
