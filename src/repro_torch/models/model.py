"""Model assembly: embed, layers, final norm; the training loss, prefill and greedy decode.

Counterpart of ``repro/models/model.py``. The reference stacks each
stage's layers on a group axis and drives them with ``lax.scan``; here a
``Model`` is an ``nn.Module`` holding one ``nn.ModuleList`` of layers
and runs them in a plain loop. Its state dict names are the reference's
pytree paths with the stage/group axes flattened into a layer index
(``layers.{i}.attn.wq``; hymba's meta tokens are ``meta``; whisper's
encoder is ``enc_layers.{i}`` and ``enc_norm``, kept out of ``layers`` as
the reference's ``build_stages`` keeps ``enc`` out of its stages;
``convert.lm_params_from_numpy`` carries the reference's params across).
Caches are one dict per layer (hybrid: ``{"attn": ..., "ssm": ...}``;
dec: ``{"self": ..., "cross": ...}``), with the shapes of the reference's
``cache_struct`` minus its group axis.

The modality frontends are stubs, as in the reference: a ``vlm`` config
takes patch embeddings ``extras["vision_embeds"]`` [B, vision_tokens, D]
and an ``encdec`` config frame embeddings ``extras["frames"]`` [B, T, D].

On a mesh (``mesh``, a ``launch.mesh.Mesh``; parameters made DTensors by
``training.make_sharded_train_step`` or ``serving.make_serve_fns``) the
training forward, prefill and decode pin the residual stream to the batch
layout before each layer (``_constrain``, the reference's) and hand the
mesh to every layer (``Ctx.mesh``), and the vocab-sharded logits'
log-sum-exp and target logits run vocab-parallel on each rank's slice
(``_logsumexp``, ``_target_logits``).

``loss_fn(batch)`` is the reference's next-token loss (cross-entropy,
z-loss, 0.01 x the MoE aux loss) under autograd; the parameters take
gradients once ``training.init_state`` sets ``requires_grad``, while
``prefill`` and ``decode_step`` run under ``no_grad``. ``cfg.remat``
("none", "dots", "full") sets per-layer recomputation as the reference's
``jax.checkpoint`` policies do (``_remat``).
"""
from __future__ import annotations

import functools
from typing import List

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn,
)

from ..configs.base import ArchConfig, _layer_kinds
from ..device import as_tensor, resolve_device
from .blocks import ATTN_KINDS, Ctx, block_apply, block_init, check_kind
from .layers import (
    ParamTree, embed, init_embedding, init_rmsnorm, rmsnorm, sinusoidal_at, sinusoidal_positions,
    unembed,
)
from .mamba import _dims


class Model(nn.Module):
    """One architecture's parameters and its serving entry points.

    ``use_kernels`` mirrors the reference ops' ``use_pallas``: with
    ``False`` the plain PyTorch versions run on the card too; on the CPU
    the plain versions always run. Parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.
    """

    def __init__(self, cfg: ArchConfig, device=None, *, mesh=None, use_kernels: bool = True, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.use_kernels = use_kernels
        kinds = _layer_kinds(cfg)
        for kind in kinds:
            check_kind(kind)
        self.kinds: List[str] = [k for k in kinds if k != "enc"]
        n_enc = len(kinds) - len(self.kinds)
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev)
        if gen is not None:
            gen.manual_seed(seed)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.embed = ParamTree(init_embedding(gen, cfg.vocab_size, cfg.d_model, dev))
        if not cfg.tie_embeddings:
            self.unembed = ParamTree(init_embedding(gen, cfg.vocab_size, cfg.d_model, dev))
        if cfg.meta_tokens:
            self.meta = nn.Parameter(torch.randn((cfg.meta_tokens, cfg.d_model), generator=gen, device=dev)
                                     .mul_(0.02), requires_grad=False)
        self.layers = nn.ModuleList(ParamTree(block_init(k, gen, cfg, dev)) for k in self.kinds)
        if n_enc:
            self.enc_layers = nn.ModuleList(ParamTree(block_init("enc", gen, cfg, dev)) for _ in range(n_enc))
            self.enc_norm = ParamTree(init_rmsnorm(cfg.d_model, dev))
        self.final_norm = ParamTree(init_rmsnorm(cfg.d_model, dev))
        if cfg.param_dtype != "float32":
            self.to(getattr(torch, cfg.param_dtype))

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def _constrain(self, x: torch.Tensor) -> torch.Tensor:
        """Pin activations to [batch over the axes but ``model``, the rest
        replicated] (the reference's ``_constrain``): without it an
        activation keeps the layout of the op that made it (the embedding's
        vocab- or width-sharded table), and the layers after it would run on
        a batch replicated over the data axes. Only on a mesh, on DTensor
        activations whose batch divides those axes' product; where it does not
        (decode at batch 1), a partial sum (the vocab-sharded embedding's) is
        still reduced."""
        from .layers import _batch_placements, _is_dtensor

        if self.mesh is None or not _is_dtensor(x) or x.dim() < 2:
            return x
        pl = _batch_placements(self.mesh, x.shape[0], "model")
        if not any(type(p).__name__ == "Shard" for p in pl):
            pl = [q if q.is_shard() or q.is_replicate() else r for q, r in zip(x.placements, pl)]
        return x.redistribute(self.mesh.device_mesh, pl)

    def _embed_in(self, tokens: torch.Tensor, pos=None) -> torch.Tensor:
        x = self._constrain(embed(self.embed, tokens, self.compute_dtype))
        if self.cfg.rope_theta <= 0:     # whisper: sinusoidal absolute positions
            D = self.cfg.d_model
            if pos is None:
                sin = sinusoidal_positions(tokens.shape[1], D, x.device)
            else:
                sin = sinusoidal_at(pos, D, x.device)
            x = x + sin.to(x.dtype)
        return x

    def _encode(self, frames: torch.Tensor, mode: str = "prefill") -> torch.Tensor:
        """Whisper's encoder on stub frame embeddings [B, T, D]: sinusoids,
        the ``enc`` layers (bidirectional), ``enc_norm``. In "train" it runs
        under autograd, without recomputation as in the reference."""
        x = frames.to(self.compute_dtype)
        x = x + sinusoidal_positions(x.shape[1], self.cfg.d_model, x.device).to(x.dtype)
        ctx = Ctx(cfg=self.cfg, mode=mode, use_kernels=self.use_kernels, mesh=self.mesh)
        for p in self.enc_layers:
            x = self._constrain(x)
            x, _, _ = block_apply("enc", p, x, ctx)
        return rmsnorm(self.enc_norm, x)

    def _cross_src(self, extras, mode: str = "prefill"):
        """What the ``cross`` / ``dec`` layers attend to: the vision
        embeddings (``vlm``) or the encoder's output (``encdec``); None for
        the other families. Raises ``ValueError`` when the input is missing."""
        key = {"vlm": "vision_embeds", "encdec": "frames"}.get(self.cfg.family)
        if key is None:
            return None
        if not extras or extras.get(key) is None:
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) needs extras[{key!r}] [B, T, d_model]")
        src = as_tensor(extras[key], self.device, self.compute_dtype)
        return self._encode(src, mode) if key == "frames" else src

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(self.final_norm, x)
        return unembed(self.embed if self.cfg.tie_embeddings else self.unembed, x)

    def _remat(self, kind: str, p, ctx: Ctx):
        """One layer's train-mode forward x -> (x, aux), recomputed in the
        backward as ``cfg.remat`` says (the reference's ``_remat``): "none"
        keeps every activation; "full" keeps only the layer's input
        (``torch.utils.checkpoint``, non-reentrant); "dots" also keeps the
        outputs of the matrix products without batch dims (``aten.mm``: the
        projections and MLPs), as ``dots_with_no_batch_dims_saveable`` does,
        and recomputes the rest (attention, norms, the MoE experts'
        batched products). Gradients are the same either way."""
        def fn(x):
            x, _, aux = block_apply(kind, p, x, ctx)
            return x, aux

        if self.cfg.remat == "none":
            return fn
        context_fn = _dots_saveable if self.cfg.remat == "dots" else noop_context_fn
        return lambda x: checkpoint(fn, x, use_reentrant=False, context_fn=context_fn)

    def loss_fn(self, batch):
        """Next-token cross-entropy (+ z-loss + 0.01 x MoE aux) of ``batch``:
        ``tokens`` / ``targets`` [B, S] (targets < 0 are not counted), plus
        ``frames`` (encdec) or ``vision_embeds`` (vlm). Returns (total,
        {"ce", "zloss", "aux"}), as the reference's ``Model.loss_fn``."""
        tokens = as_tensor(batch["tokens"], self.device, torch.long)
        targets = as_tensor(batch["targets"], self.device, torch.long)
        S = tokens.shape[1]
        ctx = Ctx(cfg=self.cfg, mode="train", positions=torch.arange(S, device=self.device),
                  use_kernels=self.use_kernels, meta=getattr(self, "meta", None),
                  cross_src=self._cross_src(batch, "train"), mesh=self.mesh)
        x = self._embed_in(tokens)
        aux = torch.zeros((), device=self.device)
        for kind, p in zip(self.kinds, self.layers):
            x, a = self._remat(kind, p, ctx)(self._constrain(x))
            aux = aux + a
        logits = self._logits(x).float()

        mask = (targets >= 0).float()
        lse = _logsumexp(logits)                                      # [B, S, 1]
        ce = (lse - _target_logits(logits, targets.clamp_min(0)[..., None]))[..., 0]
        lse = lse[..., 0]
        ntok = mask.sum().clamp_min(1.0)
        loss = (ce * mask).sum() / ntok
        zloss = 1e-4 * ((lse * mask) ** 2).sum() / ntok
        total = loss + zloss + 0.01 * aux
        return total, {"ce": loss, "zloss": zloss, "aux": aux}

    @torch.no_grad()
    def prefill(self, tokens, extras=None, *, s_max: int):
        """Run the prompt [B, S]; returns (last-token logits [B, V], caches).
        ``extras``: ``{"vision_embeds": ...}`` (vlm) or ``{"frames": ...}``
        (encdec), as the reference's ``Model.prefill`` takes them."""
        tokens = as_tensor(tokens, self.device, torch.long)
        S = tokens.shape[1]
        if s_max < S:
            raise ValueError(f"s_max={s_max} < prompt length {S}")
        ctx = Ctx(cfg=self.cfg, mode="prefill", positions=torch.arange(S, device=self.device),
                  s_max=s_max, use_kernels=self.use_kernels, meta=getattr(self, "meta", None),
                  cross_src=self._cross_src(extras), mesh=self.mesh)
        x = self._embed_in(tokens)
        caches = []
        for kind, p in zip(self.kinds, self.layers):
            x, c, _ = block_apply(kind, p, self._constrain(x), ctx)
            caches.append(c)
        return self._logits(x[:, -1:, :])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, caches, token, pos: int):
        """One token [B] for the whole batch at position ``pos``; returns
        (logits [B, V], caches). Attention caches are updated in place;
        cross-attention caches are read only."""
        token = as_tensor(token, self.device, torch.long)
        ctx = Ctx(cfg=self.cfg, mode="decode", pos=int(pos), mesh=self.mesh)
        x = self._embed_in(token[:, None], pos=int(pos))
        new_caches = []
        for kind, p, c in zip(self.kinds, self.layers, caches):
            x, c, _ = block_apply(kind, p, self._constrain(x), ctx, c)
            new_caches.append(c)
        return self._logits(x)[:, 0], new_caches

    def cache_struct(self, batch_size: int, s_max: int):
        """Zero caches, one dict per layer: the reference's ``cache_struct``
        shapes and dtypes without the group axis."""
        cfg, dev = self.cfg, self.device
        dt = self.compute_dtype

        def attn_cache(length):
            shape = (batch_size, length, cfg.n_kv_heads, cfg.hd)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}

        def layer_cache(kind):
            if kind == "local":                  # rolling window buffer
                return attn_cache(min(cfg.local_window, s_max) or s_max)
            if kind in ATTN_KINDS:
                return attn_cache(s_max)
            if kind == "moe":
                if cfg.use_mla:                  # the compressed latent and the shared rope key
                    return {"ckv": torch.zeros((batch_size, s_max, cfg.kv_lora_rank), dtype=dt, device=dev),
                            "krope": torch.zeros((batch_size, s_max, cfg.qk_rope_dim), dtype=dt, device=dev)}
                return attn_cache(s_max)
            if kind == "cross":                  # the vision embeddings' k/v
                return attn_cache(cfg.vision_tokens)
            if kind == "dec":                    # its own tokens, then the encoder's frames
                return {"self": attn_cache(s_max), "cross": attn_cache(cfg.encoder_frames)}
            if kind == "hybrid":                 # meta prefix + rolling window buffer
                M, W = cfg.meta_tokens, cfg.local_window
                return {"attn": attn_cache(M + min(W, s_max) if W else s_max + M),
                        "ssm": layer_cache("ssm")}
            d_inner, H, P, N = _dims(cfg, cfg.d_model)
            return {
                "conv": torch.zeros((batch_size, cfg.conv_width - 1, d_inner + 2 * N), dtype=dt, device=dev),
                "h": torch.zeros((batch_size, H, N, P), dtype=torch.float32, device=dev),
            }

        return [layer_cache(k) for k in self.kinds]


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1, keepdim=True)`` as max, exp, sum and log
    (bitwise ``logsumexp`` on the CPU); the max is a constant of the
    gradient (its terms cancel). On DTensor logits split on the vocab the
    max and the sum run on each rank's slice under ``local_map`` and are
    reduced as [B, S, 1] partials: DTensor's own ``logsumexp`` gathers the
    logits, and its rules for the explicit form move their gradient
    between dims by all-to-all."""
    vdims = _vocab_dims(x)
    if not vdims:
        m = x.detach().amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        return torch.log(torch.sum(torch.exp(x - m), dim=-1, keepdim=True)) + m
    from .layers import _dtensor_api

    _, Partial, Replicate, _, local_map = _dtensor_api()
    mesh, lp = x.device_mesh, list(x.placements)
    rp = [Replicate() if i in vdims else q for i, q in enumerate(lp)]
    part = lambda op: [Partial(op) if i in vdims else q for i, q in enumerate(lp)]  # noqa: E731
    m = local_map(lambda a: a.amax(dim=-1, keepdim=True), out_placements=(part("max"),),
                  in_placements=(lp,), in_grad_placements=(lp,), device_mesh=mesh)(x.detach())
    m = m.redistribute(mesh, rp)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    s = local_map(lambda a, mm: torch.sum(torch.exp(a - mm), dim=-1, keepdim=True),
                  out_placements=(part("sum"),), in_placements=(lp, rp), in_grad_placements=(lp, rp),
                  device_mesh=mesh)(x, m)
    return torch.log(s.redistribute(mesh, rp)) + m


def _vocab_dims(x) -> list:
    """The mesh dims a DTensor's last dim (the vocab) is split over; [] for a
    plain tensor."""
    from .layers import _is_dtensor

    if not _is_dtensor(x):
        return []
    return [i for i, q in enumerate(x.placements) if type(q).__name__ == "Shard" and q.dim == x.dim() - 1]


def _target_logits(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(logits, -1, idx)`` [B, S, 1]. On DTensor logits split on
    the vocab, vocab-parallel under ``local_map``: each rank reads the
    targets in its slice (others 0) and the result is a partial sum over the
    vocab's mesh dims. (DTensor's own gather backward builds zeros of the
    whole logits on every rank.)"""
    vdims = _vocab_dims(logits)
    if not vdims:
        return torch.gather(logits, -1, idx)
    from .layers import _dtensor_api

    _, Partial, Replicate, _, local_map = _dtensor_api()
    mesh, lp = logits.device_mesh, list(logits.placements)
    ip = [Replicate() if i in vdims else q for i, q in enumerate(lp)]
    out = [Partial() if i in vdims else q for i, q in enumerate(lp)]

    def local(lg, ix):
        n = lg.shape[-1]
        r = 0
        for i in vdims:                           # this rank's vocab slice, in mesh order
            r = r * mesh.size(i) + mesh.get_local_rank(i)
        ix = ix - r * n
        inside = (ix >= 0) & (ix < n)
        return torch.gather(lg, -1, ix.clamp(0, n - 1)) * inside

    return local_map(local, out_placements=(out,), in_placements=(lp, ip), in_grad_placements=(lp, ip),
                     device_mesh=mesh)(logits, idx.redistribute(mesh, ip))


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default else CheckpointPolicy.PREFER_RECOMPUTE


_dots_saveable = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def build_model(cfg: ArchConfig, device=None, *, mesh=None, use_kernels: bool = True, seed: int = 0) -> Model:
    """A ``Model`` on ``device`` (``None``: the card; raises without one).
    ``mesh`` (a ``launch.mesh.Mesh``): its training forward pins activations
    and lays out attention for that mesh once its parameters are DTensors
    (``training.make_sharded_train_step``); without DTensors it runs as on
    one device."""
    return Model(cfg, device, mesh=mesh, use_kernels=use_kernels, seed=seed)
