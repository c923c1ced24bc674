"""Port parity: ``repro_torch.models.layers`` and the attention kernel's
plain versions against ``repro.models.layers`` and
``repro.kernels.flash_attention`` (the Pallas kernel in interpret mode).

Inputs come from a numpy seed and go to both sides; f32 throughout.
Layer functions agree to atol 1e-5; the attention plain versions to
2e-5, the reference kernel sweep's own tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import attention_pallas_call
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import layers as jl
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import MaskSpec, attention_ref, gqa_attend
from repro_torch.models import layers as tl

from conftest import reduce_cfg

RNG = np.random.default_rng(61)


def _n(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


def _close(want, got, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def test_rmsnorm_and_rope():
    x = _n(2, 5, 3, 16)
    p = {"scale": _n(16)}
    _close(jl.rmsnorm(_j(p), jnp.asarray(x)), tl.rmsnorm(_t(p), torch.from_numpy(x)))
    pos = np.arange(5)
    _close(jl.rope_apply(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
           tl.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0))
    # one decode position, as attention_decode passes it
    _close(jl.rope_apply(jnp.asarray(x[:, :1]), jnp.asarray([[37]]), 500_000.0),
           tl.rope_apply(torch.from_numpy(x[:, :1]), torch.tensor([[37]]), 500_000.0))
    assert tl.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), 0.0) is not None


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(act):
    x = _n(2, 4, 16)
    p = {"w1": _n(16, 24, scale=0.25), "w2": _n(24, 16, scale=0.2), "w3": _n(16, 24, scale=0.25)}
    _close(jl.mlp_apply(_j(p), jnp.asarray(x), act), tl.mlp_apply(_t(p), torch.from_numpy(x), act))


@pytest.mark.parametrize("H,KV,Sq,Sk,window,offset,q_chunk", [
    (4, 2, 16, 16, 0, 0, 0),
    (4, 4, 16, 16, 5, 0, 0),
    (6, 2, 7, 19, 0, 12, 0),
    (4, 1, 32, 32, 8, 0, 8),
])
def test_gqa_attend(H, KV, Sq, Sk, window, offset, q_chunk):
    q, k, v = _n(2, Sq, H, 16), _n(2, Sk, KV, 16), _n(2, Sk, KV, 16)
    want = jl.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         mask_spec=jl.MaskSpec(window=window, offset=offset), q_chunk=q_chunk)
    got = tl.gqa_attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        mask_spec=tl.MaskSpec(window=window, offset=offset), q_chunk=q_chunk)
    _close(want, got)
    m = jl.MaskSpec(causal=True, window=3, offset=4).block(2, 5, 11)
    np.testing.assert_array_equal(np.asarray(m), tl.MaskSpec(True, 3, 4).block(2, 5, 11).numpy())


@pytest.mark.parametrize("B,H,KV,Lq,Lk,D,causal,window", [
    (2, 4, 4, 256, 256, 64, True, 0),
    (1, 4, 2, 128, 384, 64, True, 0),      # Lq < Lk, GQA
    (1, 6, 2, 256, 256, 32, True, 128),    # window, GQA 3:1
    (1, 2, 1, 128, 256, 64, False, 0),
])
def test_flash_plain_matches_pallas_kernel(B, H, KV, Lq, Lk, D, causal, window):
    q, k, v = _n(B, Lq, H, D), _n(B, Lk, KV, D), _n(B, Lk, KV, D)
    got = gqa_attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     mask_spec=MaskSpec(causal=causal, window=window, offset=Lk - Lq)).numpy()
    cpu = flash_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    causal=causal, window=window).numpy()
    np.testing.assert_array_equal(got, cpu)            # the wrapper's CPU path is the plain version
    G = H // KV
    bh = lambda a, g: np.moveaxis(np.repeat(a, g, axis=2), 2, 1).reshape(B * H, a.shape[1], D)
    qj, kj, vj = bh(q, 1), bh(k, G), bh(v, G)
    want = attention_pallas_call(jnp.asarray(qj), jnp.asarray(kj), jnp.asarray(vj), causal=causal,
                                 window=window, interpret=True)
    got_bh = np.moveaxis(got, 2, 1).reshape(B * H, Lq, D)
    _close(want, got_bh, atol=2e-5)
    _close(j_attention_ref(jnp.asarray(qj), jnp.asarray(kj), jnp.asarray(vj), causal=causal, window=window),
           got_bh, atol=2e-5)
    _close(j_attention_ref(jnp.asarray(qj), jnp.asarray(kj), jnp.asarray(vj), causal=causal, window=window),
           attention_ref(torch.from_numpy(qj), torch.from_numpy(kj), torch.from_numpy(vj),
                         causal=causal, window=window), atol=2e-5)


@pytest.mark.parametrize("hd,H,KV,Sq,Sk,window,prefix", [
    (24, 4, 2, 16, 20, 6, 4),      # hymba's shape in small: meta prefix, ends aligned, window
    (40, 6, 3, 18, 18, 0, 5),      # a prefix past the causal edge of the first queries
    (24, 2, 2, 9, 30, 0, 0),
])
def test_gqa_attend_prefix_and_odd_head_dims(hd, H, KV, Sq, Sk, window, prefix):
    """Head dims that are no power of two (gemma3's 240 and 168, deepseek-v3's
    dense 56, reduced) and a prefix of always-visible keys, against the
    reference's MaskSpec; the kernel wrapper's CPU path is the plain version."""
    q, k, v = _n(2, Sq, H, hd), _n(2, Sk, KV, hd), _n(2, Sk, KV, hd)
    spec = dict(causal=True, window=window, offset=Sk - Sq, prefix=prefix)
    want = jl.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_spec=jl.MaskSpec(**spec))
    got = tl.gqa_attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        mask_spec=tl.MaskSpec(**spec))
    _close(want, got)
    cpu = flash_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    causal=True, window=window, prefix=prefix)
    np.testing.assert_array_equal(got.numpy(), cpu.numpy())
    np.testing.assert_array_equal(np.asarray(jl.MaskSpec(**spec).block(3, 7, Sk)),
                                  tl.MaskSpec(**spec).block(3, 7, Sk).numpy())
    G = H // KV
    bh = lambda a, g: np.moveaxis(np.repeat(a, g, axis=2), 2, 1).reshape(2 * H, a.shape[1], hd)
    _close(np.moveaxis(got.numpy(), 2, 1).reshape(2 * H, Sq, hd),
           attention_ref(torch.from_numpy(bh(q, 1)), torch.from_numpy(bh(k, G)), torch.from_numpy(bh(v, G)),
                         causal=True, window=window, prefix=prefix), atol=2e-5)


def test_auto_q_chunk_is_exact():
    """The memory rule chunks deepseek-v3's 128 heads at batch 8 into blocks
    of 128 queries; a chunked plain attention equals the whole one."""
    assert tl._auto_q_chunk(2048, 2048, 8 * 128) == 128
    assert tl._auto_q_chunk(2048, 2048, 8 * 9) == 1024
    assert tl._auto_q_chunk(20, 20, 8) == 0 and tl._auto_q_chunk(16384) == 512
    q, k, v = _n(2, 32, 4, 8), _n(2, 40, 2, 8), _n(2, 40, 2, 8)
    spec = tl.MaskSpec(causal=True, window=9, offset=8, prefix=3)
    whole = tl.gqa_attend(*map(torch.from_numpy, (q, k, v)), mask_spec=spec)
    chunked = tl.gqa_attend(*map(torch.from_numpy, (q, k, v)), mask_spec=spec, q_chunk=8)
    _close(whole, chunked, atol=1e-6)


def test_flash_wrapper_checks():
    q, k = torch.zeros(1, 9, 4, 8), torch.zeros(1, 5, 2, 8)
    with pytest.raises(ValueError, match="Lq <= Lk"):
        flash_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="H % KV"):
        flash_ops.flash_attention(torch.zeros(1, 4, 3, 8), k, k)
    n0 = flash_ops.launches
    flash_ops.flash_attention(q, k, k, causal=False)   # unmasked: any lengths, CPU: no launch
    assert flash_ops.launches == n0


def _attn_params(cfg):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": _n(D, H, hd, scale=D ** -0.5), "wk": _n(D, KV, hd, scale=D ** -0.5),
            "wv": _n(D, KV, hd, scale=D ** -0.5), "wo": _n(H, hd, D, scale=(H * hd) ** -0.5),
            "bq": _n(H, hd, scale=0.1), "bk": _n(KV, hd, scale=0.1), "bv": _n(KV, hd, scale=0.1),
            "qnorm": {"scale": 1 + _n(hd, scale=0.1)}, "knorm": {"scale": 1 + _n(hd, scale=0.1)}}


@pytest.mark.parametrize("window", [0, 6])
def test_attention_with_meta_prefix(window):
    """Hymba's attention: M meta tokens in front of the keys and the cache,
    decode at pos + M, against the reference's ``_self_attn`` (kind hybrid)."""
    from repro.configs import get_config
    from repro.models import blocks as jb
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import blocks as tb

    cfg = reduce_cfg(get_config("hymba-1.5b"), local_window=window, qkv_bias=True)
    tcfg = ArchConfig(**dataclasses.asdict(cfg))
    p = {k: v for k, v in _attn_params(cfg).items() if k not in ("qnorm", "knorm")}
    M, S, s_max = cfg.meta_tokens, 10, 14
    meta, x = _n(M, cfg.d_model), _n(2, S, cfg.d_model)
    jctx = jb.Ctx(cfg=cfg, mode="prefill", positions=jnp.arange(S), s_max=s_max, meta=jnp.asarray(meta))
    oj, cj = jb._self_attn(_j(p), jnp.asarray(x), jctx, "hybrid")
    for use_kernels in (True, False):
        tctx = tb.Ctx(cfg=tcfg, mode="prefill", positions=torch.arange(S), s_max=s_max,
                      use_kernels=use_kernels, meta=torch.from_numpy(meta))
        ot, ct = tb._self_attn(_t(p), torch.from_numpy(x), tctx, "hybrid")
        _close(oj, ot)
        for name in ("k", "v"):
            _close(cj[name], ct[name])
    xd = _n(2, 1, cfg.d_model)
    for step in range(3):
        oj, cj = jb._self_attn(_j(p), jnp.asarray(xd), jb.Ctx(cfg=cfg, mode="decode", pos=jnp.int32(S + step)),
                               "hybrid", cj)
        ot, ct = tb._self_attn(_t(p), torch.from_numpy(xd), tb.Ctx(cfg=tcfg, mode="decode", pos=S + step),
                               "hybrid", ct)
        _close(oj, ot)
        for name in ("k", "v"):
            _close(cj[name], ct[name])


@pytest.mark.parametrize("window,mode", [(0, "dus"), (0, "where"), (6, "dus"), (6, "where")])
def test_attention_prefill_and_decode(window, mode):
    from repro.configs import get_config

    cfg = reduce_cfg(get_config("smollm-135m"), qkv_bias=True, qk_norm=True, decode_cache_update=mode)
    p = _attn_params(cfg)
    S, s_max = 10, 14
    x = _n(2, S, cfg.d_model)
    pos = np.arange(S)
    oj, cj = jl.attention_prefill(_j(p), jnp.asarray(x), jnp.asarray(pos), cfg, window=window, s_max=s_max)
    for use_kernels in (True, False):
        ot, ct = tl.attention_prefill(_t(p), torch.from_numpy(x), torch.from_numpy(pos), cfg,
                                      window=window, s_max=s_max, use_kernels=use_kernels)
        _close(oj, ot)
        for name in ("k", "v"):
            _close(cj[name], ct[name])
    xd = _n(2, 1, cfg.d_model)
    for step in range(3):
        oj, cj = jl.attention_decode(_j(p), jnp.asarray(xd), jnp.int32(S + step), cj, cfg, window=window)
        ot, ct = tl.attention_decode(_t(p), torch.from_numpy(xd), S + step, ct, cfg, window=window)
        _close(oj, ot)
        for name in ("k", "v"):
            _close(cj[name], ct[name])


def test_cache_write_roll_and_grouped_attend():
    cache, new = _n(2, 7, 2, 4), _n(2, 1, 2, 4)
    for mode in ("dus", "where"):
        want = jl.cache_write(jnp.asarray(cache), jnp.asarray(new), 3, mode)
        got = tl.cache_write(torch.from_numpy(cache.copy()), torch.from_numpy(new), 3, mode)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for S, W in ((5, 8), (8, 8), (13, 8)):
        k = _n(2, S, 2, 4)
        np.testing.assert_array_equal(np.asarray(jl.roll_to_window(jnp.asarray(k), W)),
                                      tl.roll_to_window(torch.from_numpy(k), W).numpy())
    q, k, v = _n(2, 1, 6, 8), _n(2, 9, 2, 8), _n(2, 9, 2, 8)
    mask = np.array(jl.decode_mask(jnp.int32(5), 9, 3))
    np.testing.assert_array_equal(mask, tl.decode_mask(5, 9, 3).numpy())
    np.testing.assert_array_equal(np.array(jl.decode_mask(jnp.int32(6), 9, 2, 3)),
                                  tl.decode_mask(6, 9, 2, prefix=3).numpy())
    _close(jl.grouped_attend_one(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask)),
           tl.grouped_attend_one(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 mask=torch.from_numpy(mask)))


def test_embed_unembed_tied():
    p = {"table": _n(50, 16, scale=0.02)}
    tok = RNG.integers(0, 50, (2, 5))
    xj = jl.embed(_j(p), jnp.asarray(tok), jnp.float32)
    xt = tl.embed(_t(p), torch.from_numpy(tok), torch.float32)
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
    _close(jl.unembed(_j(p), xj), tl.unembed(_t(p), xt))
