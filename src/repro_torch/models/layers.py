"""Model primitives: norms, rotary embeddings, MLPs, GQA attention.

Counterpart of ``repro/models/layers.py``. ``init_*`` builds nested
dicts of tensors (the reference's param pytree, one layer at a time);
``ParamTree`` registers such a dict as an ``nn.Module`` so that the
state dict keys are the pytree paths (``attn.wq``, ``ln1.scale``) and
the ``*_apply`` functions read ``p["wq"]`` as the reference does.

Prefill attention runs the hand-written CUDA kernel
(``kernels/flash_attention``) where the reference keeps an einsum;
``gqa_attend`` (in the kernel's ``ref.py``) is the plain version, used
by ``use_kernels=False`` and on the CPU. The unmasked attentions (an
encoder's self-attention, cross-attention over vision embeddings or an
encoder's output, any Lq and Lk) take the same kernel with
``causal=False``. Decode attends one query against the cache in plain
torch (``grouped_attend_one``; cross-attention ``gqa_attend``), as the
reference does.

Training (``attention_train``, and the unmasked attentions under
autograd) takes the same entry point: with grad enabled,
``flash_attention`` runs ``FlashAttentionFn``, the forward kernel with
its log-sum-exp and the hand-written backward kernel, where the
reference differentiates its einsums; ``use_kernels=False`` runs
``gqa_attend`` under autograd.

On a mesh (``mesh``, a ``launch.mesh.Mesh``, with DTensor activations) the
training attentions take their layout from ``seq_shard_qkv``: where the head
count does not divide the ``model`` axis, queries are sharded on the
sequence over it and k, v replicated (the reference's context-parallel
layout); otherwise heads stay sharded as the ``wq`` / ``wk`` specs put them.
Either way the attention runs on this rank's local shards under
``local_map`` (``_attend_on_mesh``): the kernel, or ``gqa_attend``, at the
query offset of this rank's shard.

Serving on a mesh (``serving.make_serve_fns``): prefill runs the same
``_attend_on_mesh`` and builds its cache on each rank's rows
(``_rows_local``). Decode reads caches placed by ``training.cache_specs``
(batch over the data axes, the length over ``model``): ``cache_write``
writes the new token only into the length shard that holds its slot (every
shard rewrites itself under "where"), and ``_decode_on_mesh`` attends. With
``cfg.flash_decode`` the caches are pinned to that layout
(``_pin_cache_layout``, the reference's rule) and each length shard runs the
softmax over its keys and keeps its log-sum-exp; two all-reduces over the
length's mesh dims (the largest log-sum-exp, then the weighted outputs and
their weights) combine them, the LSE combine GSPMD derives for the
reference. Without it the cache's length is gathered (its heads split where
they divide) and the plain softmax runs on each rank's batch rows.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import MASKED, MaskSpec, gqa_attend


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict keys become submodules
    and parameters, and ``p["name"]`` / ``"name" in p`` read them."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            else:
                self.register_parameter(name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _dense_init(gen, shape, device, scale=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    return torch.randn(shape, generator=gen, device=device).mul_(scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, hd] (hd even), positions broadcastable to [..., S].
    Rotate-half convention: the two halves of hd, not interleaved pairs."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = positions[..., :, None].float() * freqs                      # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                                 # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, f: int, act: str, device) -> dict:
    p = {"w1": _dense_init(gen, (d, f), device), "w2": _dense_init(gen, (f, d), device)}
    if act in ("swiglu", "geglu"):
        p["w3"] = _dense_init(gen, (d, f), device)
    return p


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w1"].to(x.dtype)
    if act == "swiglu":
        h = F.silu(h) * (x @ p["w3"].to(x.dtype))
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"].to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")           # jax.nn.gelu is the tanh form
    return batch_layout(h @ p["w2"].to(x.dtype))


def batch_layout(y: torch.Tensor) -> torch.Tensor:
    """A DTensor activation [B, S, ...] (a sublayer's output) brought to the
    residual stream's layout: the batch split as it is, every other mesh dim
    replicated (a tensor-parallel product's partial sums all-reduced, its
    split columns gathered), and its gradient brought to that layout too
    (the residual stream's gradient arrives as partial sums over ``model``;
    fed on as such, DTensor runs the backward's product on a weight
    gathered over ``model``: the whole product on every rank). A plain
    tensor is returned unchanged."""
    if not _is_dtensor(y):
        return y
    _, _, Replicate, Shard, _ = _dtensor_api()
    pl = [q if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in y.placements]
    if pl != list(y.placements):
        y = y.redistribute(y.device_mesh, pl)
    if y.requires_grad:
        y.register_hook(lambda g: g if list(g.placements) == pl else g.redistribute(g.device_mesh, pl))
    return y


# ---------------------------------------------------------------------------
# Attention (GQA, optional bias / qk-norm / window)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ArchConfig, device) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": _dense_init(gen, (D, H, hd), device),
        "wk": _dense_init(gen, (D, KV, hd), device),
        "wv": _dense_init(gen, (D, KV, hd), device),
        "wo": _dense_init(gen, (H, hd, D), device, scale=(H * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), device=device)
        p["bk"] = torch.zeros((KV, hd), device=device)
        p["bv"] = torch.zeros((KV, hd), device=device)
    if cfg.qk_norm:
        p["qnorm"] = init_rmsnorm(hd, device)
        p["knorm"] = init_rmsnorm(hd, device)
    return p


def _seq_split(x) -> bool:
    """A DTensor whose sequence (dim 1) is split over some mesh dim."""
    return _is_dtensor(x) and any(type(q).__name__ == "Shard" and q.dim == 1 for q in x.placements)


def local_rows(fn, x, *ws):
    """``fn(x, *ws)`` for a DTensor x [B, S, ...] and weights ``ws``, on each
    rank's rows under ``local_map``: the weights gathered whole, the output
    placed as x, each weight's gradient a partial sum over every mesh dim
    that splits x (a dim that replicates x computes the whole op on each of
    its ranks). For what DTensor's own rules cannot follow: a matmul over a
    sequence split (its flatten of (B, S)), heads that a column split would
    cut, the SSD layer's causal conv."""
    _, Partial, Replicate, Shard, local_map = _dtensor_api()
    mesh, pl = x.device_mesh, list(x.placements)
    rep = [Replicate()] * mesh.ndim
    grad = [Partial() if isinstance(o, Shard) else Replicate() for o in pl]
    return local_map(fn, out_placements=(pl,), in_placements=(pl,) + (rep,) * len(ws),
                     in_grad_placements=(pl,) + (grad,) * len(ws), device_mesh=mesh)(
        x, *(w.redistribute(mesh, rep) for w in ws))


def _uneven_heads(x, w, nh: int) -> bool:
    """A mesh dim that replicates DTensors x and w and whose size does not
    divide ``nh`` heads."""
    if not (_is_dtensor(x) and _is_dtensor(w)):
        return False
    return any(type(px).__name__ == "Replicate" and type(pw).__name__ == "Replicate" and nh % x.device_mesh.size(i)
               for i, (px, pw) in enumerate(zip(x.placements, w.placements)))


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul; contiguous [B, S, heads, hd].

    DTensor x [B, S, D] against a weight replicated over a mesh dim whose
    size does not divide the head count: DTensor would split the product's
    columns there, which no view into heads can follow. So the product runs
    on each rank's rows (``local_rows``), x first split on the sequence
    over that dim where S divides it (whisper's 1500 frames do not: their
    heads are then computed whole on every rank of that dim, as GSPMD
    replicates them)."""
    D, nh, hd = w.shape

    def proj(a, b):
        return (a @ b.reshape(D, nh * hd).to(a.dtype)).view(*a.shape[:-1], nh, hd)

    if _is_dtensor(x) and _is_dtensor(w) and x.dim() == 3:
        _, _, Replicate, Shard, _ = _dtensor_api()
        mesh, pl, local = x.device_mesh, list(x.placements), False
        for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
            n = mesh.size(i)
            if isinstance(px, Replicate) and isinstance(pw, Replicate) and nh % n:
                local = True
                if x.shape[1] % n == 0 and not any(isinstance(o, Shard) and o.dim == 1 for o in pl):
                    pl[i] = Shard(1)
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
        if local or _seq_split(x):
            return local_rows(proj, x, w)
    return proj(x, w)


def _qkv(p, x: torch.Tensor, cfg: ArchConfig):
    return (_q_only(p, x), *_kv_for_cross(p, x, cfg))


def _q_only(p, x: torch.Tensor) -> torch.Tensor:
    """The query projection: bias and ``qnorm``, no RoPE."""
    q = _proj_heads(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if "qnorm" in p:
        q = rmsnorm(p["qnorm"], q)
    return q


def _kv_for_cross(p, src: torch.Tensor, cfg: ArchConfig):
    """k, v [B, T, KV, hd] from the source [B, T, D] (``x`` itself in
    self-attention): bias and ``knorm``, no RoPE."""
    k, v = _proj_heads(src, p["wk"]), _proj_heads(src, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(src.dtype)
        v = v + p["bv"].to(src.dtype)
    if "knorm" in p:
        k = rmsnorm(p["knorm"], k)
    return k, v


def decode_mask(pos: int, s_max: int, window: int = 0, device=None, prefix: int = 0) -> torch.Tensor:
    """[1, 1, S_max] bool for a single new token at position ``pos``.

    ``prefix`` positions (meta tokens) stay visible regardless of window.
    """
    kpos = torch.arange(s_max, device=device)[None, None, :]
    m = kpos <= pos
    if window > 0:
        m &= kpos > pos - window
    if prefix > 0:
        m |= kpos < prefix
    return m


def attn_out(p, o: torch.Tensor) -> torch.Tensor:
    """o [B, S, H, hd] -> [B, S, D]. A DTensor o split on the sequence, or
    whose heads do not divide a mesh dim that replicates it and ``wo``,
    projects each rank's rows (``local_rows``: DTensor's gradient of the
    flattened heads would split their columns unevenly); a DTensor output
    is brought to the residual stream's layout (``batch_layout``), which the
    layer's MLP, sharded over ``model``, reads."""
    H, hd, D = p["wo"].shape

    def out(a, w):
        return a.reshape(*a.shape[:-2], H * hd) @ w.reshape(H * hd, D).to(a.dtype)

    if _seq_split(o) or _uneven_heads(o, p["wo"], H):
        return batch_layout(local_rows(out, o, p["wo"]))
    return batch_layout(out(o, p["wo"]))


LOGITS_BYTES = 1 << 30   # f32 logits one query block of the plain attention may hold


def _auto_q_chunk(sq: int, sk: int = 0, rows: int = 0) -> int:
    """Chunk queries once [Sq, Sk] logits would dominate memory: the
    reference's rule (512 queries past 8192), and on one device also once
    the f32 logits of ``rows`` (batch x heads) such matrices would pass
    ``LOGITS_BYTES``: then the largest halving of Sq that fits (deepseek-v3's
    128 heads at batch 8 and 2048 tokens hold 17 GB unchunked). Exact:
    every block still sees all keys."""
    if sq > 8192:
        return 512
    qc = sq
    while qc % 2 == 0 and rows * qc * sk * 4 > LOGITS_BYTES:
        qc //= 2
    return qc if qc < sq else 0


def roll_to_window(k: torch.Tensor, window: int) -> torch.Tensor:
    """Compress a full prefill KV [B, S, ...] into a rolling buffer
    [B, W, ...] where position p lives at slot p % W."""
    S = k.shape[1]
    if S < window:
        pad = [0, 0] * (k.dim() - 2) + [0, window - S]
        return F.pad(k, pad)
    last = k[:, S - window:]
    return torch.roll(last, shifts=(S - window) % window, dims=1)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _dtensor_api():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    return DTensor, Partial, Replicate, Shard, local_map


def _batch_placements(mesh, batch: int, tp: str):
    """Per mesh dim: the batch dim (0) over every axis but ``tp`` where it
    divides their product (the reference's ``dp or None``), else replicated."""
    _, _, Replicate, Shard, _ = _dtensor_api()
    dp = [a for a in mesh.axis_names if a != tp]
    n = 1
    for a in dp:
        n *= mesh.shape[a]
    return [Shard(0) if a in dp and batch % n == 0 else Replicate() for a in mesh.axis_names]


def seq_shard_qkv(q, k, v, mesh, n_heads: int, tp: str = "model", enabled: bool = True):
    """Context-parallel attention layout for head counts that do not divide
    TP (smollm 9 H, qwen and whisper 20 H, hymba 25 H on tp = 16): q [B, S,
    H, hd] sharded on the sequence over ``tp`` and k, v replicated over it,
    the batch over the other axes where it divides (the reference's
    ``seq_shard_qkv``). Returns (q, k, v, sharded): unchanged and False
    without a mesh or DTensor inputs, when disabled, when the heads divide
    TP (the ``wq`` / ``wk`` specs shard heads) or when S does not divide."""
    DTensor, _, Replicate, Shard, _ = _dtensor_api()
    if mesh is None or not enabled or tp not in mesh.axis_names or not isinstance(q, DTensor):
        return q, k, v, False
    tp_size = mesh.shape[tp]
    if n_heads % tp_size == 0 or q.shape[1] % tp_size != 0:
        return q, k, v, False
    bq = _batch_placements(mesh, q.shape[0], tp)
    q = q.redistribute(mesh.device_mesh, [Shard(1) if a == tp else b for a, b in zip(mesh.axis_names, bq)])
    kv = [Replicate() if a == tp else b for a, b in zip(mesh.axis_names, bq)]
    return q, k.redistribute(mesh.device_mesh, kv), v.redistribute(mesh.device_mesh, kv), True


def _local_attend(q, k, v, *, causal: bool, window: int, prefix: int, offset: int, use_kernels: bool,
                  r: int, seq_sharded: bool, n_heads: int, n_kv: int):
    """One rank's attention on its local shards (inside ``local_map``). A
    sequence shard's queries start at ``offset + r S_local``; a shard of
    the query heads against replicated k, v reads only its groups' KV heads."""
    B, Sl, Hl, _ = q.shape
    if seq_sharded:
        offset = offset + r * Sl
    elif Hl < n_heads and k.shape[2] == n_kv:
        G = n_heads // n_kv
        h0 = r * Hl
        k0, k1 = h0 // G, (h0 + Hl - 1) // G + 1
        if k1 - k0 > 1 and (Hl != (k1 - k0) * G or h0 % G):    # whole groups, or one KV head
            raise ValueError(f"{Hl} query heads a shard do not pair with KV heads {k0}..{k1 - 1}")
        k, v = k[:, :, k0:k1], v[:, :, k0:k1]
    if use_kernels:
        return flash_attention(q, k, v, causal=causal, window=window, prefix=prefix, offset=offset)
    spec = MaskSpec(causal=causal, window=window, offset=offset, prefix=prefix) if causal or window else None
    return gqa_attend(q, k, v, mask_spec=spec, q_chunk=_auto_q_chunk(Sl, k.shape[1], B * Hl))


def _attend_on_mesh(q, k, v, mesh, *, causal: bool, window: int = 0, prefix: int = 0,
                    offset: int = 0, use_kernels: bool, seq_shard: bool, tp: str = "model"):
    """Attention of DTensor q, k, v on ``mesh`` through ``local_map``, with
    explicit placements: ``seq_shard_qkv``'s layout when ``seq_shard`` (and
    it applies), else heads sharded over ``tp`` where the counts divide it
    and replicated where not. k, v's gradients are partial sums over ``tp``
    when each rank's queries see all of them."""
    _, Partial, Replicate, Shard, local_map = _dtensor_api()
    H, KV = q.shape[2], k.shape[2]
    q, k, v, seq_sharded = seq_shard_qkv(q, k, v, mesh, H, tp, seq_shard)
    names, dm = mesh.axis_names, mesh.device_mesh
    if not seq_sharded:
        bq = _batch_placements(mesh, q.shape[0], tp)
        tp_size = mesh.shape.get(tp, 1)
        heads = H % tp_size == 0
        qp = [(Shard(2) if heads else Replicate()) if a == tp else b for a, b in zip(names, bq)]
        kvp = [(Shard(2) if heads and KV % tp_size == 0 else Replicate()) if a == tp else b
               for a, b in zip(names, bq)]
        q = q.redistribute(dm, qp)
        k, v = k.redistribute(dm, kvp), v.redistribute(dm, kvp)
    qp, kvp = list(q.placements), list(k.placements)
    q_split = any(isinstance(pq, Shard) and not isinstance(pk, Shard)
                  for a, pq, pk in zip(names, qp, kvp) if a == tp)
    kv_grad = [Partial() if a == tp and q_split else pk for a, pk in zip(names, kvp)]
    r = mesh.coords.get(tp, 0)
    fn = functools.partial(_local_attend, causal=causal, window=window, prefix=prefix, offset=offset,
                           use_kernels=use_kernels, r=r, seq_sharded=seq_sharded, n_heads=H, n_kv=KV)
    return local_map(fn, out_placements=(qp,), in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad), device_mesh=dm)(q, k, v)


def _attend_causal(p, x, positions, cfg: ArchConfig, window: int, theta: float, use_kernels: bool,
                   meta: Optional[torch.Tensor], mesh=None):
    """Causal (windowed) self-attention of ``x`` [B, S, D]: (o [B, S, H,
    hd], k, v). ``meta`` [M, D] (hymba, the reference's ``_self_attn`` M
    branch): M learned tokens in front of the keys at positions 0..M-1,
    the queries at positions M.., every query sees them (``prefix=M``);
    k and v then cover all M + S positions."""
    B, S, _ = x.shape
    M = 0 if meta is None else meta.shape[0]
    if M:
        x = torch.cat([meta.to(x.dtype)[None].expand(B, M, -1), x], dim=1)
        positions = torch.arange(M + S, device=x.device)
    q, k, v = _qkv(p, x, cfg)
    q = rope_apply(q[:, M:], positions[M:], theta)
    k = rope_apply(k, positions, theta)
    if mesh is not None and _is_dtensor(q):
        o = _attend_on_mesh(q, k, v, mesh, causal=True, window=window, prefix=M, offset=M,
                            use_kernels=use_kernels, seq_shard=cfg.seq_shard_attn)
    elif use_kernels:
        o = flash_attention(q, k, v, causal=True, window=window, prefix=M)
    else:
        o = gqa_attend(q, k, v, mask_spec=MaskSpec(causal=True, window=window, offset=M, prefix=M),
                       q_chunk=_auto_q_chunk(S, M + S, B * cfg.n_heads))
    return o, k, v


def attention_prefill(p, x, positions, cfg: ArchConfig, *, window: int = 0,
                      theta: Optional[float] = None, s_max: Optional[int] = None,
                      use_kernels: bool = True, meta: Optional[torch.Tensor] = None, mesh=None):
    """Full-sequence causal attention; also returns the KV cache.

    Full-attention layers pad the cache to ``s_max``; windowed layers
    return a rolling buffer of length ``window`` (position p at slot p % W).
    Hymba's ``meta`` tokens (``_attend_causal``) are kept in front of the
    cache: ``k[:, :M]`` then the rolling window, or the cache padded to
    ``s_max + M``. On a ``mesh`` (DTensor activations) the attention runs
    through ``_attend_on_mesh`` and the cache is built on each rank's rows.
    """
    theta = cfg.rope_theta if theta is None else theta
    S = x.shape[1]
    M = 0 if meta is None else meta.shape[0]
    o, k, v = _attend_causal(p, x, positions, cfg, window, theta, use_kernels, meta, mesh)
    if window > 0:
        def to_cache(a):
            return torch.cat([a[:, :M], roll_to_window(a[:, M:], window)], dim=1)
    else:
        pad = (s_max or S) - S

        def to_cache(a):
            return F.pad(a, (0, 0, 0, 0, 0, pad)) if pad else a
    return attn_out(p, o), {"k": _rows_local(to_cache, k), "v": _rows_local(to_cache, v)}


def _rows_local(fn, t: torch.Tensor) -> torch.Tensor:
    """``fn(t)`` for an ``fn`` that changes only dim 1 (a cache's length):
    on a DTensor, dim 1 gathered where it is split and ``fn`` run on each
    rank's shard under ``local_map``, the other placements kept."""
    if not _is_dtensor(t):
        return fn(t)
    _, _, Replicate, Shard, local_map = _dtensor_api()
    pl = [Replicate() if isinstance(q, Shard) and q.dim == 1 else q for q in t.placements]
    t = t.redistribute(t.device_mesh, pl)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,), device_mesh=t.device_mesh)(t)


def _global_offset(t) -> tuple:
    """Where a DTensor's local shard starts in its global tensor, per dim:
    each ``Shard(d)`` splits what the mesh dims before it left of dim d into
    chunks of ``ceil(size / n)``, in mesh-dim order (DTensor's layout)."""
    _, _, _, Shard, _ = _dtensor_api()
    coord = t.device_mesh.get_coordinate()
    size, off = list(t.shape), [0] * t.dim()
    for i, q in enumerate(t.placements):
        if isinstance(q, Shard):
            d, n = q.dim % t.dim(), t.device_mesh.size(i)
            chunk = -(-size[d] // n)
            off[d] += coord[i] * chunk
            size[d] = max(0, min(chunk, size[d] - coord[i] * chunk))
    return tuple(off)


def _pin_cache_layout(arr: torch.Tensor, mesh, length_axis: int = 1) -> torch.Tensor:
    """flash-decode: a DTensor cache placed as [batch over the data axes
    where it divides, the length over ``model``] (the reference's rule), so
    the softmax runs on each length shard instead of a gathered cache. A
    no-op off a mesh, without a ``model`` axis, or where the length does not
    divide it."""
    if mesh is None or "model" not in mesh.axis_names or not _is_dtensor(arr):
        return arr
    if arr.shape[length_axis] % mesh.shape["model"]:
        return arr
    _, _, Replicate, Shard, _ = _dtensor_api()
    dp = [a for a in mesh.axis_names if a != "model"]
    dp_total = 1
    for a in dp:
        dp_total *= mesh.shape[a]
    b = arr.shape[0] % dp_total == 0 and arr.shape[0] >= dp_total
    pl = [Shard(length_axis) if a == "model" else (Shard(0) if b else Replicate()) for a in mesh.axis_names]
    return arr if list(arr.placements) == pl else arr.redistribute(mesh.device_mesh, pl)


def _decode_on_mesh(qs, kvs, visible, flash: bool, scores=None, weigh=None, rows=None, weights=(),
                    kv_heads: Optional[int] = None):
    """One query's attention over DTensor caches ``kvs`` ([B, L, ...] each,
    placed alike) whose length may be split over some mesh dims; the
    queries ``qs`` ([B, 1, ...] each) are brought to the caches' batch
    layout and ``weights`` replicated. ``visible(kpos)`` -> bool
    [len(kpos)] (None: every key). ``scores(*qs, *kvs, *weights)`` -> f32
    logits [..., L], ``weigh(p, *kvs, *weights)`` -> p @ V [B, 1, H, d] and
    ``rows(t)`` a per-query reduction of the logits' layout [..., 1] as
    [B, 1, H, 1] (default: ``grouped_attend_one``'s grouped GQA forms).

    With ``flash`` and a split length, each rank runs the softmax over its
    shard of keys: o_i = softmax(l_i) V_i and lse_i = logsumexp(l_i); the
    max M of the lse_i is all-reduced over the length's mesh dims, then
    [w_i o_i, w_i] with w_i = exp(lse_i - M) (one tensor), and out =
    sum w_i o_i / sum w_i: flash decoding's LSE combine. Over one shard
    w = 1 and out is the plain softmax's, bit for bit. Otherwise the length
    is gathered and the softmax runs whole on each rank's batch rows; where
    ``kv_heads`` (the caches' dim 2 and the queries', grouped) divide the
    mesh dims that split the length, the heads are split over them instead
    (the length's split traded for the heads': one all-to-all)."""
    _, Partial, Replicate, Shard, local_map = _dtensor_api()
    scores, weigh, rows = scores or _grouped_scores, weigh or _grouped_weigh, rows or _grouped_rows
    dm = kvs[0].device_mesh
    cp = list(kvs[0].placements)
    bp = [c if isinstance(c, Shard) and c.dim == 0 else Replicate() for c in cp]
    ldims = [i for i, c in enumerate(cp) if isinstance(c, Shard) and c.dim == 1]
    qp = bp
    if not flash or not ldims:
        cp, n = list(bp), 1
        for i in ldims if kv_heads else ():
            if kv_heads % (n * dm.size(i)) == 0:
                cp[i], n = Shard(2), n * dm.size(i)
        qp, ldims = cp, []
    kvs = [t.redistribute(dm, cp) for t in kvs]
    qs = [t.redistribute(dm, qp) for t in qs]
    rep = [Replicate()] * dm.ndim
    weights = [w.redistribute(dm, rep) for w in weights]
    nq = len(qs)
    off, Ll = _global_offset(kvs[0])[1], kvs[0].to_local().shape[1]
    mask = None if visible is None else visible(torch.arange(off, off + Ll, device=qs[0].device))

    def attend(*a):
        lg = scores(*a)
        if mask is not None:
            lg = torch.where(mask.reshape((1,) * (lg.dim() - 1) + (Ll,)), lg, MASKED)
        return lg, weigh(torch.softmax(lg, dim=-1), *a[nq:])

    in_pl = (*[qp] * nq, *[cp] * len(kvs), *[rep] * len(weights))
    if not ldims:
        return local_map(lambda *a: attend(*a)[1].to(a[0].dtype), out_placements=(qp,), in_placements=in_pl,
                         device_mesh=dm)(*qs, *kvs, *weights)

    # each shard's [o_i, lse_i] rides as a partial value (never reduced as it is)
    part = [Partial() if i in ldims else b for i, b in enumerate(bp)]
    o_lse, m = local_map(lambda *a: lse_part(*attend(*a), rows), out_placements=(
        part, [Partial("max") if i in ldims else b for i, b in enumerate(bp)]),
        in_placements=in_pl, device_mesh=dm)(*qs, *kvs, *weights)
    m = m.redistribute(dm, bp)                           # all-reduce 1: the max of the lse
    num = local_map(lse_weigh, out_placements=(part,), in_placements=(part, bp), device_mesh=dm)(o_lse, m)
    num = num.redistribute(dm, bp)                       # all-reduce 2: sum w_i o_i and sum w_i
    return lse_finish(num, qs[0].dtype)


def lse_part(lg: torch.Tensor, o: torch.Tensor, rows=None):
    """One length shard's part of flash decoding's LSE combine: from its
    masked logits ``lg`` and its softmax output ``o`` (``_decode_on_mesh``'s
    forms), ``([o_i, lse_i], lse_i)``, lse_i = logsumexp(lg) per query row."""
    lse = (rows or _grouped_rows)(torch.logsumexp(lg, dim=-1, keepdim=True))
    return torch.cat([o, lse], dim=-1), lse


def lse_weigh(o_lse: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``[w_i o_i, w_i]``, w_i = exp(lse_i - M), of one shard's ``[o_i,
    lse_i]`` and the shards' max lse ``m``; the sum over shards is the
    combine's numerator and denominator."""
    w = torch.exp(o_lse[..., -1:] - m)
    return torch.cat([w * o_lse[..., :-1], w], dim=-1)


def lse_finish(num: torch.Tensor, dtype) -> torch.Tensor:
    """The combined output, sum w_i o_i / sum w_i, from the summed ``lse_weigh``."""
    return (num[..., :-1] / num[..., -1:]).to(dtype)


def _grouped_scores(q, k, v):
    """f32 logits [B, KV, G, 1, L] of q [B, 1, H, hd] over k [B, L, KV, hd]."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * (hd ** -0.5)


def _grouped_weigh(e, k, v):
    """e [B, KV, G, 1, L] @ v [B, L, KV, d] -> [B, 1, H, d] f32."""
    B, KV, G, Sq, _ = e.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", e, v.float())
    return out.reshape(B, Sq, KV * G, v.shape[-1])


def _grouped_rows(t):
    """t [B, KV, G, 1, 1] (a reduction of the grouped logits over L) as [B, 1, H, 1]."""
    B, KV, G, Sq, _ = t.shape
    return t.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * G, 1)


def attention_train(p, x, positions, cfg: ArchConfig, *, window: int = 0,
                    theta: Optional[float] = None, use_kernels: bool = True,
                    meta: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Full-sequence causal (windowed) self-attention without a cache: the
    training forward (the reference's ``attention_train`` without
    ``cross_src``, and its ``_self_attn`` M branch with hymba's ``meta``;
    cross-attention trains through ``cross_attention_prefill``).
    Differentiable on both paths; ``meta`` gets its gradient through k and v.
    On a ``mesh`` it runs ``seq_shard_qkv``'s layout (``_attend_on_mesh``)."""
    theta = cfg.rope_theta if theta is None else theta
    return attn_out(p, _attend_causal(p, x, positions, cfg, window, theta, use_kernels, meta, mesh)[0])


def _attend_unmasked(q, k, v, use_kernels: bool, mesh=None, seq_shard: bool = False) -> torch.Tensor:
    """Every query sees every key, any Lq and Lk: the kernel with
    ``causal=False``, or the plain version chunked by ``_auto_q_chunk``.
    On a ``mesh`` (DTensor inputs) through ``_attend_on_mesh``, with
    ``seq_shard_qkv``'s layout when ``seq_shard``."""
    if mesh is not None and _is_dtensor(q):
        return _attend_on_mesh(q, k, v, mesh, causal=False, use_kernels=use_kernels,
                               seq_shard=seq_shard)
    if use_kernels:
        return flash_attention(q, k, v, causal=False)
    B, Sq, H, _ = q.shape
    return gqa_attend(q, k, v, q_chunk=_auto_q_chunk(Sq, k.shape[1], B * H))


def encoder_attention(p, x, cfg: ArchConfig, *, use_kernels: bool = True, mesh=None) -> torch.Tensor:
    """Bidirectional self-attention of an encoder layer (the reference's
    ``enc`` block): no mask, no RoPE, no cache; on a mesh no sequence
    sharding, as in the reference."""
    q, k, v = _qkv(p, x, cfg)
    return attn_out(p, _attend_unmasked(q, k, v, use_kernels, mesh))


def cross_attention_prefill(p, x, src, cfg: ArchConfig, *, use_kernels: bool = True, mesh=None):
    """Queries from x [B, S, D], keys and values from the source [B, T, D]
    (vision embeddings or the encoder's output), no mask; returns (out,
    the cache {"k", "v"} [B, T, KV, hd], which decode reads unchanged).
    On a mesh the queries take ``seq_shard_qkv``'s layout, as in the
    reference's cross branch of ``attention_train``."""
    q = _q_only(p, x)
    k, v = _kv_for_cross(p, src, cfg)
    o = _attend_unmasked(q, k, v, use_kernels, mesh, seq_shard=cfg.seq_shard_attn)
    return attn_out(p, o), {"k": k, "v": v}


def cross_attention_decode(p, x, cache: dict, *, mesh=None, flash: bool = False):
    """One-token cross-attention over the cached source k/v, no mask;
    returns (out, the same cache). On a ``mesh`` (DTensor caches, the
    length split as ``cache_specs`` puts it) through ``_decode_on_mesh``."""
    q = _q_only(p, x)
    if mesh is not None and _is_dtensor(cache["k"]):
        o = _decode_on_mesh((q,), (cache["k"], cache["v"]), None, flash, kv_heads=cache["k"].shape[2])
    else:
        o = gqa_attend(q, cache["k"], cache["v"])
    return attn_out(p, o), cache


def attention_decode(p, x, pos: int, cache: dict, cfg: ArchConfig, *, window: int = 0,
                     theta: Optional[float] = None, prefix: int = 0, mesh=None):
    """One-token step. x [B, 1, D]; ``pos`` a Python int.

    Full-attention cache: k/v [B, S_max, KV, hd], written at ``pos``.
    Windowed cache:       k/v [B, W, KV, hd] rolling, written at pos % W.
    ``prefix`` meta tokens occupy [0, prefix) of a (prefix + W) buffer,
    and ``pos`` then counts them.
    The cache is updated in place (the reference returns a new array; an
    in-place write saves a copy of the whole cache per layer and token)
    and returned. On a ``mesh`` (DTensor caches) the attention runs through
    ``_decode_on_mesh``, under ``cfg.flash_decode`` on caches pinned to
    ``_pin_cache_layout``'s layout.
    """
    theta = cfg.rope_theta if theta is None else theta
    q, k_new, v_new = _qkv(p, x, cfg)
    at = torch.tensor([[pos]], device=x.device)
    q = rope_apply(q, at, theta)
    k_new = rope_apply(k_new, at, theta)
    L = cache["k"].shape[1]
    if window > 0:
        # rolling buffer: every resident slot is inside the window; mask
        # only the slots not filled yet (and keep the meta prefix visible)
        slot = prefix + (pos - prefix) % window
        kpos = torch.arange(L, device=x.device)[None, None, :]
        mask = (kpos < prefix) | (kpos <= pos)
    else:
        slot = pos
        mask = decode_mask(pos, L, 0, x.device, prefix)
    k = cache_write(cache["k"], k_new, slot, cfg.decode_cache_update)
    v = cache_write(cache["v"], v_new, slot, cfg.decode_cache_update)
    if mesh is not None and _is_dtensor(k):
        if cfg.flash_decode:
            k, v = _pin_cache_layout(k, mesh), _pin_cache_layout(v, mesh)
        o = _decode_on_mesh((q,), (k, v), lambda kp: (kp < prefix) | (kp <= pos), cfg.flash_decode,
                            kv_heads=k.shape[2])
    else:
        o = grouped_attend_one(q, k, v, mask=mask)
    return attn_out(p, o), {"k": k, "v": v}


def grouped_attend_one(q, k, v, *, mask):
    """Single-token GQA without repeating KV heads (grouped einsums)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * (hd ** -0.5)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, MASKED)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def cache_write(cache: torch.Tensor, new: torch.Tensor, slot: int, mode: str) -> torch.Tensor:
    """Write ``new`` [B, 1, ...] into ``cache`` [B, L, ...] at ``slot``, in place.

    "dus" writes the slice; "where" rewrites the cache through a mask, the
    reference's sharding-friendly form. On one device both are one write.
    A DTensor cache whose length is split: ``new`` is brought to the cache's
    other placements and written into the local shard, under "dus" only by
    the rank whose shard holds ``slot``, under "where" by every rank.
    """
    new = new.to(cache.dtype)
    if _is_dtensor(cache):
        _, _, Replicate, Shard, _ = _dtensor_api()
        pl = [Replicate() if isinstance(q, Shard) and q.dim == 1 else q for q in cache.placements]
        local, new = cache.to_local(), new.redistribute(cache.device_mesh, pl).to_local()
        s, L = slot - _global_offset(cache)[1], local.shape[1]
        if mode == "where":
            sel = (torch.arange(L, device=local.device) == s).reshape((1, L) + (1,) * (local.dim() - 2))
            local.copy_(torch.where(sel, new, local))
        elif 0 <= s < L:
            local[:, s:s + 1] = new
        return cache
    if mode == "where":
        L = cache.shape[1]
        sel = (torch.arange(L, device=cache.device) == slot).reshape((1, L) + (1,) * (cache.dim() - 2))
        return cache.copy_(torch.where(sel, new, cache))
    cache[:, slot:slot + 1] = new
    return cache


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d: int, device) -> dict:
    return {"table": _dense_init(gen, (vocab, d), device, scale=0.02)}


def embed(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """``table[tokens]`` as ``F.embedding``, which a vocab-sharded DTensor
    table runs without gathering the vocab: a DTensor table is first
    gathered over every other sharding (FSDP's width), so each rank looks
    its own tokens up in its slice of the vocab."""
    return F.embedding(tokens, _vocab_sharded(p["table"])).to(dtype)


def _vocab_sharded(table: torch.Tensor) -> torch.Tensor:
    """A DTensor table [V, D] with every sharding but the vocab's gathered
    (FSDP's all-gather of the width); a plain tensor unchanged."""
    if not _is_dtensor(table):
        return table
    _, _, Replicate, Shard, _ = _dtensor_api()
    pl = [q if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in table.placements]
    return table.redistribute(table.device_mesh, pl)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """x @ tableᵀ. With DTensors, vocab-parallel under ``local_map``: the
    table gathered over its width (``_vocab_sharded``), x over everything
    but its batch, and each rank's logits [B, S, its slice of V] placed
    split on the vocab (x's gradient a partial sum over the vocab's mesh
    dims). DTensor's own choice for this product can gather the whole
    logits, and its backward can split the sequence, which the product's
    flatten cannot follow."""
    if not _is_dtensor(x):
        return x @ p["table"].to(x.dtype).T
    _, Partial, Replicate, Shard, local_map = _dtensor_api()
    table = _vocab_sharded(p["table"])
    mesh = table.device_mesh
    xp = [q if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in x.placements]
    tp = list(table.placements)
    out = [Shard(x.dim() - 1) if isinstance(t, Shard) else q for q, t in zip(xp, tp)]
    x_grad = [Partial() if isinstance(t, Shard) else q for q, t in zip(xp, tp)]
    t_grad = [t if isinstance(t, Shard) else (Partial() if isinstance(q, Shard) else Replicate())
              for q, t in zip(xp, tp)]
    return local_map(lambda a, w: a @ w.to(a.dtype).T, out_placements=(out,), in_placements=(xp, tp),
                     in_grad_placements=(x_grad, t_grad), device_mesh=mesh)(x.redistribute(mesh, xp), table)


def sinusoidal_positions(s: int, d: int, device=None) -> torch.Tensor:
    """[s, d] f32 absolute positions (whisper's): sines of the angles, then cosines."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_at(pos: int, d: int, device=None) -> torch.Tensor:
    """[d] f32: ``sinusoidal_positions`` at the one position ``pos``."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), device=device) / (10_000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
