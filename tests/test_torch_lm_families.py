"""Port parity: the decoder-only LM families that the port added after
smollm-135m and mamba2-780m, against ``repro.models.Model`` and
``repro.serving.serve_step.greedy_generate`` on reduced configs
(``conftest.reduce_cfg``), the reference's params carried across by
``convert.lm_params_from_numpy``:

* hymba-1.5b: ``hybrid`` (meta tokens in front of the keys, windowed
  attention beside the Mamba heads, the gated sum);
* deepseek-moe-16b: ``moe`` (64 routed experts reduced to 8, shared
  experts) after one dense layer;
* deepseek-v3-671b: ``moe`` with MLA after a dense layer, bf16 params;
* qwen1.5-4b: ``dense`` with the QKV bias.

Logits and caches agree within 1e-5 of their scale (largest magnitude)
in f32 compute; greedy tokens are identical. The MoE router is also held
where it is hardest: capacity drops (``capacity_factor=1.0``) against
the reference's ``moe_apply_gspmd``, and a router of all-zero weights,
where every probability ties and ``jax.lax.top_k`` picks experts
``0..K-1``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.serving.serve_step import greedy_generate as j_greedy
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model
from repro_torch.models import moe as t_moe
from repro_torch.serving.serve_step import greedy_generate

from conftest import reduce_cfg

ARCHS = ["hymba-1.5b", "deepseek-moe-16b", "deepseek-v3-671b", "qwen1.5-4b"]
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


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """One reduced arch on both sides; the reference's prefill, three
    decode steps and greedy tokens, each compiled once."""
    r = reduce_cfg(j_get_config(request.param))
    jm = j_build_model(r)
    params = jm.init(jax.random.PRNGKey(3))
    cfg = ArchConfig(**dataclasses.asdict(r))
    tm = build_model(cfg, "cpu")
    tm.load_state_dict(lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    toks = np.random.default_rng(5).integers(0, r.vocab_size, (B, S + 3)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: jm.prefill(p, t, {}, s_max=S_MAX))(params, jnp.asarray(toks[:, :S]))
    want = {"prefill": (np.asarray(logits), jax.tree.map(np.asarray, cache)), "decode": []}
    decode = jax.jit(jm.decode_step)
    for i in range(3):
        logits, cache = decode(params, cache, jnp.asarray(toks[:, S + i]), jnp.int32(S + i))
        want["decode"].append(np.asarray(logits))
    want["decoded_cache"] = jax.tree.map(np.asarray, cache)
    want["greedy"] = np.asarray(j_greedy(jm, params, jnp.asarray(toks[:, :S]), steps=STEPS, s_max=S_MAX))
    want["cache_struct"] = _flat_cache(jm.cache_struct(B, S_MAX))
    return request.param, tm, toks, want


def test_prefill_and_decode_match_reference(family):
    arch, tm, toks, want = family
    logits, cache = tm.prefill(toks[:, :S], s_max=S_MAX)
    assert _rel(want["prefill"][0], logits) < 1e-5, arch
    _caches_close(arch, want["prefill"][1], cache)
    for i in range(3):
        logits, cache = tm.decode_step(cache, toks[:, S + i], S + i)
        assert _rel(want["decode"][i], logits) < 1e-5, (arch, i)
    _caches_close(arch, want["decoded_cache"], cache)


def test_greedy_generate_matches_reference(family):
    arch, tm, toks, want = family
    got = greedy_generate(tm, toks[:, :S], steps=STEPS, s_max=S_MAX)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want["greedy"], got.numpy(), err_msg=arch)


def test_cache_struct_matches_reference(family):
    arch, tm, toks, want = family
    got = tm.cache_struct(B, S_MAX)
    _, prefilled = tm.prefill(toks[:, :S], s_max=S_MAX)
    for fj, ft, fp in zip(want["cache_struct"], got, prefilled):
        lj, lt, lp = list(_leaves(fj)), list(_leaves(ft)), list(_leaves(fp))
        assert [n for n, _ in lj] == [n for n, _ in lt] == [n for n, _ in lp], arch
        for (name, a), (_, t), (_, p) in zip(lj, lt, lp):
            assert a.shape == tuple(t.shape) == tuple(p.shape), (arch, name)
            assert str(a.dtype) == str(t.dtype).removeprefix("torch."), (arch, name)
            assert t.dtype == p.dtype and not t.any()


def _moe_pair(arch, **over):
    """A reduced MoE config on both sides with the reference's params."""
    r = reduce_cfg(j_get_config(arch), **over)
    jp = j_moe.init_moe(jax.random.PRNGKey(11), r)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    return r, jp, tp


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_moe_drops_match_reference(arch):
    """capacity_factor 1.0: every expert's bucket overflows somewhere, and
    the drops (token order within an expert) are the reference's."""
    r, jp, tp = _moe_pair(arch, capacity_factor=1.0)
    cfg = ArchConfig(**dataclasses.asdict(r))
    x = np.random.default_rng(17).standard_normal((3, 16, r.d_model)).astype(np.float32)
    T = x.shape[0] * x.shape[1]
    y_j, aux_j = j_moe.moe_apply_gspmd(jp, jnp.asarray(x), r)
    y_t, aux_t = t_moe.moe_apply(tp, torch.from_numpy(x), cfg)
    assert _rel(y_j, y_t) < 1e-5
    assert abs(float(aux_j) - float(aux_t)) < 1e-5
    idx_j, _, _ = j_moe._route(jp, jnp.asarray(x.reshape(T, -1)), r)
    idx_t, _, _ = t_moe._route(tp, torch.from_numpy(x.reshape(T, -1)), cfg)
    np.testing.assert_array_equal(np.asarray(idx_j), idx_t.numpy())
    cap = t_moe._capacity(T, cfg)
    assert cap == j_moe._capacity(T, r)
    pos_j, keep_j = j_moe._dispatch_indices(idx_j, r, T, cap)
    pos_t, keep_t = t_moe._dispatch_indices(idx_t, cfg, T, cap)
    np.testing.assert_array_equal(np.asarray(pos_j), pos_t.numpy())
    np.testing.assert_array_equal(np.asarray(keep_j), keep_t.numpy())
    assert 0 < int((~keep_t).sum()) < keep_t.numel()     # some assignments dropped, not all


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_router_ties_pick_the_lowest_experts(arch):
    """All-zero router weights: every probability is 1/E, and the experts
    picked are 0..K-1 for every token, as ``jax.lax.top_k`` picks them."""
    r, jp, tp = _moe_pair(arch)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    cfg = ArchConfig(**dataclasses.asdict(r))
    x = np.random.default_rng(19).standard_normal((24, r.d_model)).astype(np.float32)
    idx_j, gate_j, _ = j_moe._route(jp, jnp.asarray(x), r)
    idx_t, gate_t, _ = t_moe._route(tp, torch.from_numpy(x), cfg)
    want = np.broadcast_to(np.arange(r.experts_per_token), (24, r.experts_per_token))
    np.testing.assert_array_equal(np.asarray(idx_j), want)
    np.testing.assert_array_equal(idx_t.numpy(), want)
    np.testing.assert_allclose(gate_t.numpy(), np.asarray(gate_j), rtol=0, atol=1e-7)
    # the same on the whole-token path, through the buckets
    y_j, _ = j_moe.moe_apply_gspmd(jp, jnp.asarray(x[None]), r)
    y_t, _ = t_moe.moe_apply(tp, torch.from_numpy(x[None]), cfg)
    assert _rel(y_j, y_t) < 1e-5
