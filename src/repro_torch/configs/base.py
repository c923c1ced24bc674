"""Architecture config + registry (copy of ``repro/configs/base.py``).

``ArchConfig`` is the reference's field for field, with its defaults,
so a config moves between the packages unchanged
(``ArchConfig(**dataclasses.asdict(jax_cfg))``). The registry holds all
ten of the reference's configurations: smollm-135m and qwen1.5-4b
(``dense``), gemma3-12b and gemma3-27b (``local`` / ``global``),
mamba2-780m (``ssm``), hymba-1.5b (``hybrid``), deepseek-moe-16b and
deepseek-v3-671b (``moe``, the latter with MLA), whisper-large-v3
(``enc`` / ``dec``) and llama-3.2-vision-90b (``dense`` / ``cross``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // n_heads

    # --- attention variants -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # gemma3: different theta on global layers
    local_window: int = 0            # sliding-window size for local layers
    pattern: Tuple[str, ...] = ()    # repeating layer cycle, e.g. 5x local + global
    tie_embeddings: bool = False
    act: str = "swiglu"              # swiglu | geglu | gelu

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0          # leading dense layers before MoE stack
    dense_d_ff: int = 0              # d_ff of those dense layers
    capacity_factor: float = 1.25
    ep_mode: str = "shard_map"       # shard_map (explicit a2a) | gspmd

    # --- MLA (deepseek-v3) ---------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid ----------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    meta_tokens: int = 0             # hymba: learnable prefix tokens

    # --- encoder-decoder / vlm -------------------------------------------------
    encoder_layers: int = 0
    encoder_frames: int = 1500       # whisper stub frontend output length
    cross_attn_every: int = 0        # llama-vision: every Nth layer cross-attends
    vision_tokens: int = 0           # stubbed patch-embedding count

    # --- training knobs ----------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    factored_second_moment: bool = False   # Adafactor-style v (XXL configs)
    remat: str = "dots"              # none | dots | full
    seq_shard_attn: bool = True      # context-parallel attn when H % tp != 0
    # "dus": dynamic_update_slice (natural, but GSPMD fully rematerializes
    # a length-sharded cache to apply it); "where": masked elementwise
    # rewrite — fully local under length sharding (§Perf).
    decode_cache_update: str = "dus"
    # flash-decode: pin K/V to the length-sharded cache layout so decode
    # attention computes per-shard softmax partials (GSPMD inserts the
    # small LSE all-reduces) instead of all-gathering the cache (§Perf).
    flash_decode: bool = False
    sub_quadratic: bool = False      # eligible for long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Approximate total parameter count (for roofline MODEL_FLOPS)."""
        D, V = self.d_model, self.vocab_size
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in _layer_kinds(self):
            total += _layer_params(self, kind)
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed-in experts)."""
        D, V = self.d_model, self.vocab_size
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in _layer_kinds(self):
            total += _layer_params(self, kind, active_only=True)
        return total


def _attn_params(cfg: ArchConfig) -> int:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.use_mla:
        qk = cfg.qk_rope_dim + cfg.qk_nope_dim
        p = D * cfg.q_lora_rank + cfg.q_lora_rank * H * qk           # q path
        p += D * (cfg.kv_lora_rank + cfg.qk_rope_dim)                # kv down
        p += cfg.kv_lora_rank * H * (cfg.qk_nope_dim + cfg.v_head_dim)
        p += H * cfg.v_head_dim * D                                  # out
        return p
    return D * H * hd + 2 * D * KV * hd + H * hd * D


def _mlp_params(D: int, F: int, act: str) -> int:
    return D * F * (3 if act in ("swiglu", "geglu") else 2)


def _ssm_params(cfg: ArchConfig, d_in: int) -> int:
    d_inner = cfg.ssm_expand * d_in
    H = max(d_inner // cfg.ssm_head_dim, 1)
    N = cfg.ssm_state
    p = d_in * (2 * d_inner + 2 * N + H)          # in_proj (z, x, B, C, dt)
    p += cfg.conv_width * (d_inner + 2 * N)       # conv
    p += d_inner * d_in                           # out_proj
    p += 2 * H                                    # A_log, D skip
    return p


def _layer_kinds(cfg: ArchConfig):
    """One kind string per layer, expanded from the arch family/pattern."""
    kinds = []
    if cfg.family == "encdec":
        kinds += ["enc"] * cfg.encoder_layers
        kinds += ["dec"] * cfg.n_layers
        return kinds
    for i in range(cfg.n_layers):
        if cfg.family == "vlm" and cfg.cross_attn_every and (
            (i + 1) % cfg.cross_attn_every == 0
        ):
            kinds.append("cross")
        elif cfg.family == "ssm":
            kinds.append("ssm")
        elif cfg.family == "hybrid":
            kinds.append("hybrid")
        elif cfg.n_experts and i >= cfg.n_dense_layers:
            kinds.append("moe")
        elif cfg.pattern:
            kinds.append(cfg.pattern[i % len(cfg.pattern)])
        else:
            kinds.append("dense")
    return kinds


def _layer_params(cfg: ArchConfig, kind: str, active_only: bool = False) -> int:
    D = cfg.d_model
    attn = _attn_params(cfg)
    if kind in ("dense", "local", "global"):
        ff = cfg.dense_d_ff if (cfg.n_experts and cfg.dense_d_ff) else cfg.d_ff
        return attn + _mlp_params(D, ff, cfg.act)
    if kind == "moe":
        n_routed = cfg.experts_per_token if active_only else cfg.n_experts
        p = attn + n_routed * _mlp_params(D, cfg.moe_d_ff, cfg.act)
        p += cfg.n_shared_experts * _mlp_params(D, cfg.moe_d_ff, cfg.act)
        p += D * cfg.n_experts                    # router
        return p
    if kind == "ssm":
        return _ssm_params(cfg, D) + _mlp_params(D, cfg.d_ff, cfg.act) if cfg.d_ff else _ssm_params(cfg, D)
    if kind == "hybrid":
        return attn + _ssm_params(cfg, D) + _mlp_params(D, cfg.d_ff, cfg.act)
    if kind == "cross":
        return attn + _mlp_params(D, cfg.d_ff, cfg.act)
    if kind in ("enc", "dec"):
        p = attn + _mlp_params(D, cfg.d_ff, cfg.act)
        if kind == "dec":
            p += attn                             # cross-attention
        return p
    raise ValueError(kind)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r} (registered: {sorted(_REGISTRY)})")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all():
    from . import (  # noqa: F401
        deepseek_moe_16b, deepseek_v3_671b, gemma3_12b, gemma3_27b, hymba_1_5b,
        llama_3_2_vision_90b, mamba2_780m, qwen1_5_4b, smollm_135m, whisper_large_v3,
    )


# ---------------------------------------------------------------------------
# Input shapes (assigned; one set shared by all LM archs)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}
