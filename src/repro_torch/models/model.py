"""Model assembly: embed, layers, final norm; prefill and greedy decode.

Counterpart of ``repro/models/model.py``. The reference stacks each
stage's layers on a group axis and drives them with ``lax.scan``; here a
``Model`` is an ``nn.Module`` holding one ``nn.ModuleList`` of layers
and runs them in a plain loop. Its state dict names are the reference's
pytree paths with the stage/group axes flattened into a layer index
(``layers.{i}.attn.wq``; hymba's meta tokens are ``meta``;
``convert.lm_params_from_numpy`` carries the reference's params across).
Caches are one dict per layer (hybrid: ``{"attn": ..., "ssm": ...}``),
with the shapes of the reference's ``cache_struct`` minus its group axis.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..configs.base import ArchConfig, _layer_kinds
from ..device import as_tensor, resolve_device
from .blocks import ATTN_KINDS, Ctx, block_apply, block_init, check_kind
from .layers import ParamTree, embed, init_embedding, init_rmsnorm, rmsnorm, unembed
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
        self.kinds: List[str] = _layer_kinds(cfg)
        for kind in self.kinds:
            check_kind(kind)   # cross-attention and sinusoidal positions (enc/dec) raise here
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
        self.final_norm = ParamTree(init_rmsnorm(cfg.d_model, dev))
        if cfg.param_dtype != "float32":
            self.to(getattr(torch, cfg.param_dtype))

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def _embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed(self.embed, tokens, self.compute_dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(self.final_norm, x)
        return unembed(self.embed if self.cfg.tie_embeddings else self.unembed, x)

    @torch.no_grad()
    def prefill(self, tokens, *, s_max: int):
        """Run the prompt [B, S]; returns (last-token logits [B, V], caches)."""
        tokens = as_tensor(tokens, self.device, torch.long)
        S = tokens.shape[1]
        if s_max < S:
            raise ValueError(f"s_max={s_max} < prompt length {S}")
        ctx = Ctx(cfg=self.cfg, mode="prefill", positions=torch.arange(S, device=self.device),
                  s_max=s_max, use_kernels=self.use_kernels, meta=getattr(self, "meta", None))
        x = self._embed_in(tokens)
        caches = []
        for kind, p in zip(self.kinds, self.layers):
            x, c = block_apply(kind, p, x, ctx)
            caches.append(c)
        return self._logits(x[:, -1:, :])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, caches, token, pos: int):
        """One token [B] for the whole batch at position ``pos``; returns
        (logits [B, V], caches). Attention caches are updated in place."""
        token = as_tensor(token, self.device, torch.long)
        ctx = Ctx(cfg=self.cfg, mode="decode", pos=int(pos))
        x = self._embed_in(token[:, None])
        new_caches = []
        for kind, p, c in zip(self.kinds, self.layers, caches):
            x, c = block_apply(kind, p, x, ctx, c)
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


def build_model(cfg: ArchConfig, device=None, use_kernels: bool = True, seed: int = 0) -> Model:
    """A ``Model`` on ``device`` (``None``: the card; raises without one)."""
    return Model(cfg, device, use_kernels=use_kernels, seed=seed)
