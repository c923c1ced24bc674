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

    def __init__(self, cfg: ArchConfig, device=None, *, use_kernels: bool = True, seed: int = 0):
        super().__init__()
        self.cfg = cfg
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

    def _embed_in(self, tokens: torch.Tensor, pos=None) -> torch.Tensor:
        x = embed(self.embed, tokens, self.compute_dtype)
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
        ctx = Ctx(cfg=self.cfg, mode=mode, use_kernels=self.use_kernels)
        for p in self.enc_layers:
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
                  cross_src=self._cross_src(batch, "train"))
        x = self._embed_in(tokens)
        aux = torch.zeros((), device=self.device)
        for kind, p in zip(self.kinds, self.layers):
            x, a = self._remat(kind, p, ctx)(x)
            aux = aux + a
        logits = self._logits(x).float()

        mask = (targets >= 0).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt_logit = torch.gather(logits, -1, targets.clamp_min(0)[..., None])[..., 0]
        ntok = mask.sum().clamp_min(1.0)
        loss = ((lse - tgt_logit) * mask).sum() / ntok
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
                  cross_src=self._cross_src(extras))
        x = self._embed_in(tokens)
        caches = []
        for kind, p in zip(self.kinds, self.layers):
            x, c, _ = block_apply(kind, p, x, ctx)
            caches.append(c)
        return self._logits(x[:, -1:, :])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, caches, token, pos: int):
        """One token [B] for the whole batch at position ``pos``; returns
        (logits [B, V], caches). Attention caches are updated in place;
        cross-attention caches are read only."""
        token = as_tensor(token, self.device, torch.long)
        ctx = Ctx(cfg=self.cfg, mode="decode", pos=int(pos))
        x = self._embed_in(token[:, None], pos=int(pos))
        new_caches = []
        for kind, p, c in zip(self.kinds, self.layers, caches):
            x, c, _ = block_apply(kind, p, x, ctx, c)
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


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default else CheckpointPolicy.PREFER_RECOMPUTE


_dots_saveable = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def build_model(cfg: ArchConfig, device=None, use_kernels: bool = True, seed: int = 0) -> Model:
    """A ``Model`` on ``device`` (``None``: the card; raises without one)."""
    return Model(cfg, device, use_kernels=use_kernels, seed=seed)
