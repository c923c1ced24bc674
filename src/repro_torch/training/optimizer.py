"""AdamW with dtype-configurable moments and an optional factored second moment.

Counterpart of ``repro/training/optimizer.py``, as plain functions over a
dict of tensors named as the model's state dict (``layers.3.attn.wq``),
not ``torch.optim.AdamW``: the reference clips the global norm before
the moments, decays only matrices, and can factor the second moment
(Adafactor-style) for the XXL configs, none of which the library's
optimizer does. All arithmetic is f32; ``moment_dtype`` sets only the
moments' storage.

The reference stacks each layer's leaves on a leading group axis, so
every per-layer leaf is a matrix there: a layer's norm scale [D] is a
[groups, D] leaf and takes weight decay. ``adamw_update`` keeps that
rule through ``stacked`` (the names of the port's per-layer leaves, whose
rank in the reference is one more). With ``factored``, each leaf whose
last two dims exceed 1 is factored as the reference factors it; a
per-layer vector keeps its full second moment here, where the reference
factors a stage's stacked vectors across its layers (its ``vc`` averages
over the layers): the one place the factored state differs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    factored: bool = False


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in f32 (0-d, on the CPU)."""
    step = _f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _is_factorable(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def adamw_init(params: Dict[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """{"m": zeros, "v": zeros or {"vr", "vc"} (f32) per factored leaf, "step": 0}."""
    dt = getattr(torch, cfg.moment_dtype)

    def vinit(p):
        if cfg.factored and _is_factorable(p):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device)}
        return torch.zeros_like(p, dtype=dt)

    return {"m": {n: torch.zeros_like(p, dtype=dt) for n, p in params.items()},
            "v": {n: vinit(p) for n, p in params.items()},
            "step": 0}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (0-d, on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree.values()))


# Elements of a row slice: a larger plain leaf whose second moment is not
# factored updates slice by slice (see ``adamw_update``).
UPDATE_SLICE = 1 << 25


def _row_slices(p: torch.Tensor, v) -> Optional[list]:
    """Row slices of a large plain leaf with a full second moment, else None
    (the leaf updates whole). A DTensor or the dry run's fake tensors
    update whole: their slices would be collectives or other ops."""
    if isinstance(v, dict) or type(p) is not torch.Tensor or p.dim() == 0 or p.numel() <= UPDATE_SLICE:
        return None
    rows = max(1, UPDATE_SLICE // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def adamw_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
                 cfg: AdamWConfig, *, stacked: Optional[Callable[[str], bool]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], dict, Dict[str, torch.Tensor]]:
    """One step; returns (new_params, new_state, {"grad_norm", "lr"}) as new
    tensors, leaving the inputs as they were. ``stacked(name)`` is True for
    a leaf the reference holds with a group axis (decay then applies from
    rank 1); None: no leaf is. A plain leaf of more than ``UPDATE_SLICE``
    elements with a full second moment is updated in row slices written
    into its new tensors: the arithmetic is elementwise, so the bits are
    the whole leaf's, and its temporaries stay a slice's size (a tied
    262,144-word embedding is 1-1.4 billion elements)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - _f32(cfg.b1) ** _f32(step)
    bc2 = 1 - _f32(cfg.b2) ** _f32(step)
    mdt = getattr(torch, cfg.moment_dtype)

    def leaf(p, g, m, v, decay):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        mhat = m32 / bc1
        if isinstance(v, dict):                      # factored second moment
            g2 = g * g + 1e-30
            vr = cfg.b2 * v["vr"] + (1 - cfg.b2) * g2.mean(-1)
            vc = cfg.b2 * v["vc"] + (1 - cfg.b2) * g2.mean(-2)
            vhat = (vr[..., None] * vc[..., None, :]
                    / torch.clamp(vr.mean(-1)[..., None, None], min=1e-30)) / bc2
            new_v = {"vr": vr, "vc": vc}
        else:
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
            vhat = v32 / bc2
            new_v = v32.to(mdt)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:                                    # decoupled decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m32.to(mdt), new_v

    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        decay = p.dim() + bool(stacked is not None and stacked(n)) >= 2
        args = (grads[n], state["m"][n], state["v"][n])
        rows = _row_slices(p, args[2])
        if rows is None:
            new_p[n], new_m[n], new_v[n] = leaf(p, *args, decay)
            continue
        outs = (torch.empty_like(p), torch.empty_like(p, dtype=mdt), torch.empty_like(p, dtype=mdt))
        for r in rows:
            for out, x in zip(outs, leaf(p[r], *(a[r] for a in args), decay)):
                out[r] = x
        new_p[n], new_m[n], new_v[n] = outs
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm, "lr": lr}
