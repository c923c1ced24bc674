"""Fine-grained Mixture-of-Experts (DeepSeek family).

Counterpart of ``repro/models/moe.py``: the router, the capacity-drop
policy, the reference's ``moe_apply_gspmd`` (``moe_apply``: capacity
buckets, three batched expert products, gather and gate) and its
``moe_apply_shard_map`` (expert parallelism: the same buckets exchanged
over ``launch.mesh.Mesh.all_to_all``, each rank running its slab of the
experts). Without a mesh the gspmd form runs, whatever ``ep_mode`` says,
as in the reference; on a mesh ``blocks.block_apply`` runs the exchange,
the tokens split over the data axes where the reference's ``shard_map``
splits them and whole on every rank otherwise (the gspmd form's function).
Training runs either form under autograd and adds its load-balance loss
(``Model.loss_fn``).

No Pallas kernel sits on this path in the reference, so the expert
products stay ``torch.bmm``. Two choices keep the port's routing the
reference's on every input, ties included:

* top-k by a stable descending sort: ``jax.lax.top_k`` puts the lower
  expert index first among equal probabilities, and ``torch.topk`` on
  CUDA promises no order (bf16 router logits tie often);
* bucket slots by a stable sort of the expert ids (token order within an
  expert, the GShard drop policy), and the kept (token, expert) pairs
  copied into their distinct slots by one indexed write: no accumulate,
  so nothing depends on the order of atomics (the dropped ones land in a
  spare row that is cut off: no shape depends on the data, so the dry
  run's fake tensors follow it).
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
    flat = idx.reshape(-1)
    ce = probs.new_zeros(E).index_add_(0, flat, probs.new_ones(flat.shape)) / (T * cfg.experts_per_token)
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
    counts = flat_e.new_zeros(cfg.n_experts).index_add_(0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * K, device=idx.device) - seg_start[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = pos < cap
    return pos.reshape(T, K), keep.reshape(T, K)


def _dispatch(p, x: torch.Tensor, cfg: ArchConfig):
    """Route the tokens of x [B, S, D] and copy them into ``[E, cap, D]``
    buckets (capacity from these tokens). Returns (buckets, the combine's
    arguments)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    x2d = x.reshape(-1, x.shape[-1])
    T = x2d.shape[0]
    idx, gate, aux = _route(p, x2d, cfg)
    cap = _capacity(T, cfg)
    pos, keep = _dispatch_indices(idx, cfg, T, cap)
    e_flat, p_flat, k_flat = idx.reshape(-1), pos.reshape(-1), keep.reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    D = x2d.shape[1]
    # kept pairs into their distinct slots (a copy); dropped ones into a spare row, cut off
    flat = x2d.new_zeros((E * cap + 1, D))
    flat[torch.where(k_flat, e_flat * cap + p_flat, E * cap)] = x2d[tok]
    return flat[:E * cap].view(E, cap, D), (x, x2d, e_flat, p_flat, keep, gate, aux)


def _combine(p, out_buckets: torch.Tensor, cfg: ArchConfig, x, x2d, e_flat, p_flat, keep, gate, aux):
    """Gather each (token, k)'s expert output back, gate it, add the shared
    experts. Returns (y [B, S, D], aux)."""
    T, K = keep.shape
    D = x2d.shape[1]
    cap = out_buckets.shape[1]
    gathered = out_buckets[e_flat, p_flat.clamp(max=cap - 1)]          # [T*K, D]
    gathered.masked_fill_(~keep.reshape(-1)[:, None], 0.0)              # dropped: 0
    w = torch.where(keep, gate, torch.zeros((), dtype=gate.dtype, device=gate.device))
    y = (gathered.view(T, K, D) * w[..., None]).sum(1)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x2d, cfg.act)
    return y.reshape(x.shape), aux


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig):
    """The reference's ``moe_apply_gspmd``: tokens into ``[E, cap, D]``
    buckets, the experts, back by gather and gate. Returns (y, aux)."""
    buckets, rest = _dispatch(p, x, cfg)
    out_buckets = _expert_ffn(p["experts"], buckets, cfg.act)          # [E, cap, D]
    del buckets
    return _combine(p, out_buckets, cfg, *rest)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def moe_apply_shard_map(p, x: torch.Tensor, cfg: ArchConfig, *, mesh, expert_axis: str = "model"):
    """The reference's ``moe_apply_shard_map`` on this rank's local tensors
    (inside ``blocks._moe_shard_map``'s ``local_map``): x [B_loc, S, D] the
    local tokens, ``p["experts"]`` this rank's slab [E / P, ...] of the
    experts (P the ranks of ``expert_axis``). Routes the local tokens,
    fills ``[E, cap, D]`` buckets (capacity from the local token count),
    sends expert e's bucket to the rank that holds e (``mesh.all_to_all``),
    runs the local experts on ``[E / P, P cap, D]``, sends the outputs back
    and gathers and gates them. Returns (y, aux), aux of the local tokens.

    Every rank of ``expert_axis`` in a data shard holds the same tokens, so
    the experts compute P copies of them (the reference's exchange, as it
    is); under autograd each copy's share of an expert's gradient is
    1 / P, so the slab's gradient is one copy's."""
    buckets, rest = _dispatch(p, x, cfg)
    E, cap, D = buckets.shape
    P = mesh.size(expert_axis)
    e_loc = E // P
    recv = mesh.all_to_all(buckets.reshape(P, e_loc, cap, D), expert_axis)   # [P (source), e_loc, cap, D]
    recv = recv.transpose(0, 1).reshape(e_loc, P * cap, D)
    experts = p["experts"]
    if torch.is_grad_enabled() and P > 1:
        experts = {k: _ScaleGrad.apply(w, 1.0 / P) for k, w in experts.items()}
    out_loc = _expert_ffn(experts, recv, cfg.act)                         # [e_loc, P cap, D]
    back = out_loc.reshape(e_loc, P, cap, D).transpose(0, 1).contiguous()
    out_buckets = mesh.all_to_all(back, expert_axis).reshape(E, cap, D)
    return _combine(p, out_buckets, cfg, *rest)
