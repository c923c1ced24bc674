"""Fine-grained Mixture-of-Experts (DeepSeek family).

Counterpart of ``repro/models/moe.py`` on one device: the router, the
capacity-drop policy and the reference's ``moe_apply_gspmd`` (capacity
buckets, three batched expert products, gather and gate). The reference
runs that form whenever it has no mesh, whatever ``ep_mode`` says; its
``moe_apply_shard_map`` (expert parallelism over an ``all_to_all``) waits
for the LM mesh glue (ROADMAP.md Queue 1 item 13). Training runs the same
form under autograd and adds its load-balance loss (``Model.loss_fn``).

No Pallas kernel sits on this path in the reference, so the expert
products stay ``torch.bmm``. Two choices keep the port's routing the
reference's on every input, ties included:

* top-k by a stable descending sort: ``jax.lax.top_k`` puts the lower
  expert index first among equal probabilities, and ``torch.topk`` on
  CUDA promises no order (bf16 router logits tie often);
* bucket slots by a stable sort of the expert ids (token order within an
  expert, the GShard drop policy), and the kept (token, expert) pairs
  copied into their distinct slots by one indexed write: no accumulate,
  so nothing depends on the order of atomics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import _dense_init, init_mlp, mlp_apply


def init_moe(gen, cfg: ArchConfig, device) -> dict:
    """Router, ``[E, ...]`` expert weights and the shared experts' MLP. The
    expert weights are cast to ``cfg.param_dtype`` one by one as they are
    drawn, so deepseek-v3's 45 GB of f32 experts never exist at once."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    pdt = getattr(torch, cfg.param_dtype)
    p = {
        "router": _dense_init(gen, (D, E), device),
        "experts": {
            "w1": _dense_init(gen, (E, D, Fe), device).to(pdt),
            "w2": _dense_init(gen, (E, Fe, D), device).to(pdt),
        },
    }
    if cfg.act in ("swiglu", "geglu"):
        p["experts"]["w3"] = _dense_init(gen, (E, D, Fe), device).to(pdt)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, D, Fe * cfg.n_shared_experts, cfg.act, device)
    return p


def _expert_ffn(pe, x: torch.Tensor, act: str) -> torch.Tensor:
    """x [E, T, D] batched over experts."""
    h = torch.bmm(x, pe["w1"].to(x.dtype))
    if act == "swiglu":
        h = F.silu(h) * torch.bmm(x, pe["w3"].to(x.dtype))
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * torch.bmm(x, pe["w3"].to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, pe["w2"].to(x.dtype))


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest per row, the lower index first
    among equals (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(p, x2d: torch.Tensor, cfg: ArchConfig):
    """Top-K routing with normalized softmax gates.

    Returns (idx [T, K], gate [T, K] in x's dtype, aux_loss scalar). The
    Switch-style load-balance loss is a training quantity (``loss_fn`` adds
    0.01 x its sum over layers); serving drops it.
    """
    logits = (x2d @ p["router"].to(x2d.dtype)).float()                # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, cfg.experts_per_token)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    T, E = probs.shape
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / (T * cfg.experts_per_token)
    aux = E * torch.sum(probs.mean(0) * ce)
    return idx, gate.to(x2d.dtype), aux


def _capacity(T: int, cfg: ArchConfig) -> int:
    cap = int(T * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(cap, 4)


def _dispatch_indices(idx: torch.Tensor, cfg: ArchConfig, T: int, cap: int):
    """Position of each (token, k) assignment within its expert's bucket.

    Returns (pos [T, K], keep [T, K]): deterministic capacity drop by
    token order (GShard policy), from one stable sort.
    """
    K = cfg.experts_per_token
    flat_e = idx.reshape(-1)                                           # [T*K]
    sorted_e, order = torch.sort(flat_e, stable=True)                 # group by expert
    counts = torch.bincount(flat_e, minlength=cfg.n_experts)
    seg_start = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * K, device=idx.device) - seg_start[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = pos < cap
    return pos.reshape(T, K), keep.reshape(T, K)


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig):
    """The reference's ``moe_apply_gspmd``: tokens into ``[E, cap, D]``
    buckets, the experts, back by gather and gate. Returns (y, aux)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    idx, gate, aux = _route(p, x2d, cfg)
    cap = _capacity(T, cfg)
    pos, keep = _dispatch_indices(idx, cfg, T, cap)

    e_flat, p_flat, k_flat = idx.reshape(-1), pos.reshape(-1), keep.reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    buckets = x2d.new_zeros((E, cap, D))
    buckets[e_flat[k_flat], p_flat[k_flat]] = x2d[tok[k_flat]]       # distinct slots: a copy

    out_buckets = _expert_ffn(p["experts"], buckets, cfg.act)          # [E, cap, D]
    del buckets
    gathered = out_buckets[e_flat, p_flat.clamp(max=cap - 1)]          # [T*K, D]
    gathered.masked_fill_(~k_flat[:, None], 0.0)                       # dropped: 0
    w = torch.where(keep, gate, torch.zeros((), dtype=gate.dtype, device=gate.device))
    y = (gathered.view(T, K, D) * w[..., None]).sum(1)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x2d, cfg.act)
    return y.reshape(B, S, D), aux
