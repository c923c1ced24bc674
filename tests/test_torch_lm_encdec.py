"""Port parity: the encoder-decoder and cross-attention LM kinds (``enc``,
``dec``, ``cross``) against ``repro.models.Model`` and
``repro.serving.serve_step.greedy_generate`` on reduced configs
(``conftest.reduce_cfg``), the reference's params carried across by
``convert.lm_params_from_numpy``:

* whisper-large-v3: 2 ``enc`` + 4 ``dec`` layers over 16 stub frames,
  sinusoidal positions, no RoPE;
* llama-3.2-vision-90b: ``[dense, cross] x 2`` over 8 stub vision tokens.

The reference initialises llama-vision's ``xgate`` to zeros, and
``tanh(0) = 0`` would hide every cross-attention from the logits, so the
reference's ``xgate`` leaves are set from the seed to values in [0.5, 1.5]
before the params are carried across. Logits and caches agree within 1e-5
of their scale (largest magnitude) in f32; greedy tokens are identical.
The frames and patch embeddings are 0.1 x N(0, 1), as
``tests/test_models_smoke.py`` makes them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention.ops import flash_attention as j_flash_attention
from repro.models import build_model as j_build_model
from repro.models import layers as jl
from repro.serving.serve_step import greedy_generate as j_greedy
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import Model, build_model
from repro_torch.models import layers as tl
from repro_torch.serving.serve_step import greedy_generate

from conftest import reduce_cfg

ARCHS = ["whisper-large-v3", "llama-3.2-vision-90b"]
B, S, S_MAX, STEPS = 2, 20, 32, 6


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-9)


def _leaves(tree, path=""):
    """(path, leaf) of a nested dict of arrays, in key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}.{key}")
    else:
        yield path, tree


def _flat_cache(jcache):
    """The reference's per-stage caches ([n_groups, ...] leaves) as one nested dict per layer."""
    out = []
    for stage in jcache:
        n_groups = np.shape(jax.tree.leaves(stage)[0])[0]
        for g in range(n_groups):
            for j in range(len(stage)):
                out.append(jax.tree.map(lambda a: np.asarray(a)[g], stage[f"l{j}"]))
    return out


def _caches_close(arch, jcache, tcache):
    flat = _flat_cache(jcache)
    assert len(flat) == len(tcache)
    for fj, ft in zip(flat, tcache):
        lj, lt = list(_leaves(fj)), list(_leaves(ft))
        assert [n for n, _ in lj] == [n for n, _ in lt], arch
        for (name, a), (_, b) in zip(lj, lt):
            assert a.shape == tuple(b.shape), (arch, name)
            assert _rel(a, b.float()) < 1e-5, (arch, name)


def _extras(r, seed=7):
    """The stub frontend's output for a reduced config, 0.1 x N(0, 1)."""
    rng = np.random.default_rng(seed)
    if r.family == "vlm":
        return {"vision_embeds": (rng.standard_normal((B, r.vision_tokens, r.d_model)) * 0.1).astype(np.float32)}
    return {"frames": (rng.standard_normal((B, r.encoder_frames, r.d_model)) * 0.1).astype(np.float32)}


def _open_gates(params, seed=11):
    """Every ``xgate`` leaf of the reference's params set from the seed, in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    for stage in params["stages"]:
        for slot in stage.values():
            if "xgate" in slot:
                slot["xgate"] = jnp.asarray(rng.uniform(0.5, 1.5, slot["xgate"].shape), jnp.float32)
    return params


def _pair(arch):
    r = reduce_cfg(j_get_config(arch))
    jm = j_build_model(r)
    params = _open_gates(jm.init(jax.random.PRNGKey(3)))
    cfg = ArchConfig(**dataclasses.asdict(r))
    tm = build_model(cfg, "cpu")
    tm.load_state_dict(lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    return r, jm, params, tm


@pytest.fixture(scope="module", params=ARCHS)
def encdec(request):
    """One reduced arch on both sides; the reference's prefill, three
    decode steps, greedy tokens and zero caches, each compiled once."""
    r, jm, params, tm = _pair(request.param)
    extras = _extras(r)
    jx = {k: jnp.asarray(v) for k, v in extras.items()}
    toks = np.random.default_rng(5).integers(0, r.vocab_size, (B, S + 3)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t, e: jm.prefill(p, t, e, s_max=S_MAX))(params, jnp.asarray(toks[:, :S]), jx)
    want = {"prefill": (np.asarray(logits), jax.tree.map(np.asarray, cache)), "decode": []}
    decode = jax.jit(jm.decode_step)
    for i in range(3):
        logits, cache = decode(params, cache, jnp.asarray(toks[:, S + i]), jnp.int32(S + i))
        want["decode"].append(np.asarray(logits))
    want["decoded_cache"] = jax.tree.map(np.asarray, cache)
    want["greedy"] = np.asarray(j_greedy(jm, params, jnp.asarray(toks[:, :S]), jx, steps=STEPS, s_max=S_MAX))
    want["cache_struct"] = _flat_cache(jm.cache_struct(B, S_MAX))
    return request.param, jm, params, tm, toks, extras, want


def test_prefill_and_decode_match_reference(encdec):
    arch, _, _, tm, toks, extras, want = encdec
    logits, cache = tm.prefill(toks[:, :S], extras, s_max=S_MAX)
    assert _rel(want["prefill"][0], logits) < 1e-5, arch
    _caches_close(arch, want["prefill"][1], cache)
    for i in range(3):
        logits, cache = tm.decode_step(cache, toks[:, S + i], S + i)
        assert _rel(want["decode"][i], logits) < 1e-5, (arch, i)
    _caches_close(arch, want["decoded_cache"], cache)


def test_greedy_generate_matches_reference(encdec):
    arch, _, _, tm, toks, extras, want = encdec
    got = greedy_generate(tm, toks[:, :S], extras, steps=STEPS, s_max=S_MAX)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want["greedy"], got.numpy(), err_msg=arch)


def test_teacher_forced_decode_matches_full_prefill(encdec):
    """Three decode steps after a prefill of S tokens give the logits of a
    prefill of S + 3 (sinusoidal positions at ``pos`` for whisper)."""
    arch, _, _, tm, toks, extras, _ = encdec
    lg_full, _ = tm.prefill(toks[:, :S + 3], extras, s_max=S_MAX)
    lg, cache = tm.prefill(toks[:, :S], extras, s_max=S_MAX)
    for i in range(3):
        lg, cache = tm.decode_step(cache, toks[:, S + i], S + i)
    assert _rel(lg_full, lg) < 5e-4, arch


def test_cache_struct_matches_reference(encdec):
    arch, _, _, tm, toks, extras, want = encdec
    got = tm.cache_struct(B, S_MAX)
    _, prefilled = tm.prefill(toks[:, :S], extras, s_max=S_MAX)
    assert len(want["cache_struct"]) == len(got) == len(prefilled) == tm.cfg.n_layers
    for fj, ft, fp in zip(want["cache_struct"], got, prefilled):
        lj, lt, lp = list(_leaves(fj)), list(_leaves(ft)), list(_leaves(fp))
        assert [n for n, _ in lj] == [n for n, _ in lt] == [n for n, _ in lp], arch
        for (name, a), (_, t), (_, p) in zip(lj, lt, lp):
            assert a.shape == tuple(t.shape) == tuple(p.shape), (arch, name)
            assert str(a.dtype) == str(t.dtype).removeprefix("torch."), (arch, name)
            assert t.dtype == p.dtype and not t.any()


def test_cross_attention_reaches_the_logits(encdec):
    """Other vision embeddings or frames give other logits: the gates are
    open, so a wrong cross-attention could not hide behind tanh(0)."""
    arch, _, _, tm, toks, extras, want = encdec
    other = {k: v[::-1].copy() for k, v in extras.items()}      # the batch's sources swapped
    lg, _ = tm.prefill(toks[:, :S], other, s_max=S_MAX)
    assert _rel(want["prefill"][0], lg) > 1e-3, arch


def test_kernel_switch_is_plain_on_cpu(encdec):
    """On the CPU the unmasked kernel calls run the plain version: ``use_kernels``
    True and False give the same logits and caches, bitwise."""
    arch, _, _, tm, toks, extras, _ = encdec
    plain = Model(tm.cfg, "cpu", use_kernels=False)
    plain.load_state_dict(tm.state_dict())
    la, ca = tm.prefill(toks[:, :S], extras, s_max=S_MAX)
    lb, cb = plain.prefill(toks[:, :S], extras, s_max=S_MAX)
    assert torch.equal(la, lb), arch
    for fa, fb in zip(ca, cb):
        for (name, a), (_, b) in zip(_leaves(fa), _leaves(fb)):
            assert torch.equal(a, b), (arch, name)


def test_prefill_needs_its_extras(encdec):
    arch, _, _, tm, toks, _, _ = encdec
    key = "vision_embeds" if tm.cfg.family == "vlm" else "frames"
    with pytest.raises(ValueError, match=key):
        tm.prefill(toks[:, :S], s_max=S_MAX)
    with pytest.raises(ValueError, match=key):
        greedy_generate(tm, toks[:, :S], {}, steps=2, s_max=S_MAX)


def test_encoder_matches_reference():
    """Whisper's encoder alone (sinusoids, the ``enc`` layers, ``enc_norm``)
    against the reference's ``Model._encode``."""
    r, jm, params, tm = _pair("whisper-large-v3")
    frames = _extras(r, seed=13)["frames"]
    want = jax.jit(jm._encode)(params, jnp.asarray(frames))
    got = tm._encode(torch.from_numpy(frames))
    assert tuple(got.shape) == (B, r.encoder_frames, r.d_model)
    assert _rel(want, got) < 1e-5


@pytest.mark.parametrize("s,d,pos", [(16, 128, 7), (448, 1280, 447), (1500, 64, 1234)])
def test_sinusoids_match_reference(s, d, pos):
    """XLA's and torch's f32 ``10000 ** x`` differ in the last bit at some
    x, which moves the angle at position p by up to p x 2^-23 (relative
    1 ulp); sin and cos move by no more, plus their own rounding."""
    want = np.asarray(jl.sinusoidal_positions(s, d))
    got = tl.sinusoidal_positions(s, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=(s - 1) * 2.0 ** -23 + 2e-7)
    at = tl.sinusoidal_at(pos, d)
    want_at = np.asarray(jl.sinusoidal_at(jnp.int32(pos), d))
    np.testing.assert_allclose(at.numpy(), want_at, rtol=0, atol=pos * 2.0 ** -23 + 2e-7)
    if pos < s:
        np.testing.assert_array_equal(at.numpy(), got.numpy()[pos])


def test_lm_params_from_numpy_carries_the_encoder():
    """``enc_stages`` become ``enc_layers.{i}`` and ``enc_norm`` stays
    ``enc_norm.scale``; a missing encoder leaf raises ``KeyError``, a
    shape mismatch ``ValueError``, each naming the leaf."""
    r = reduce_cfg(j_get_config("whisper-large-v3"))
    params = jax.tree.map(np.asarray, j_build_model(r).init(jax.random.PRNGKey(0)))
    cfg = ArchConfig(**dataclasses.asdict(r))
    sd = lm_params_from_numpy(params, cfg)
    assert set(sd) == set(Model(cfg, "meta").state_dict())
    enc = params["enc_stages"][0]["l0"]
    for i in range(r.encoder_layers):
        np.testing.assert_array_equal(sd[f"enc_layers.{i}.attn.wq"].numpy(), enc["attn"]["wq"][i])
        np.testing.assert_array_equal(sd[f"enc_layers.{i}.mlp.w2"].numpy(), enc["mlp"]["w2"][i])
    np.testing.assert_array_equal(sd["enc_norm.scale"].numpy(), params["enc_norm"]["scale"])
    dec = params["stages"][0]["l0"]
    np.testing.assert_array_equal(sd[f"layers.{r.n_layers - 1}.xattn.wk"].numpy(), dec["xattn"]["wk"][-1])
    bad = jax.tree.map(lambda a: a, params)
    del bad["enc_stages"][0]["l0"]["ln2"]
    with pytest.raises(KeyError, match="enc_layers.0.ln2.scale"):
        lm_params_from_numpy(bad, cfg)
    bad = jax.tree.map(lambda a: a, params)
    del bad["enc_norm"]
    with pytest.raises(KeyError, match="enc_norm.scale"):
        lm_params_from_numpy(bad, cfg)
    bad = jax.tree.map(lambda a: a, params)
    bad["enc_stages"][0]["l0"]["attn"]["wv"] = bad["enc_stages"][0]["l0"]["attn"]["wv"][..., :-1]
    with pytest.raises(ValueError, match=r"enc_stages\[0\]\.l0\.attn\.wv\[0\]"):
        lm_params_from_numpy(bad, cfg)


@pytest.mark.parametrize("H,KV,Lq,Lk", [(4, 2, 256, 128), (4, 4, 128, 384)])
def test_flash_attention_unmasked_matches_pallas_kernel(H, KV, Lq, Lk):
    """The port's ``flash_attention(causal=False)`` on the CPU, more queries
    than keys and fewer, against the reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(23)
    D = 64
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, Lq, H, D), (2, Lk, KV, D), (2, Lk, KV, D)))
    got = flash_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False)
    assert tuple(got.shape) == (2, Lq, H, D)
    heads = lambda a: np.moveaxis(np.repeat(a, H // a.shape[2], axis=2), 2, 1)     # [B, H, L, D]
    want = j_flash_attention(jnp.asarray(heads(q)), jnp.asarray(heads(k)), jnp.asarray(heads(v)),
                             causal=False, interpret=True)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 2, 1), np.asarray(want), rtol=0, atol=2e-5)
