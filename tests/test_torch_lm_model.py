"""Port parity: the LM serving path of ``repro_torch`` (``Model.prefill``,
``decode_step``, ``greedy_generate``) against ``repro.models.Model`` and
``repro.serving.serve_step.greedy_generate`` on reduced configs, with the
reference's params carried across by ``convert.lm_params_from_numpy``.

Logits and caches agree within 1e-5 of their scale (largest magnitude)
in f32; greedy tokens are identical. gemma3-12b (reduced: 5 local + 1
global per cycle, window 8) covers the local/global kinds and rolling
caches; the families added later are in ``test_torch_lm_families.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serving.serve_step import greedy_generate as j_greedy
from repro_torch.configs import all_configs, get_config
from repro_torch.configs.base import ArchConfig, _layer_kinds
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import Model, build_model
from repro_torch.serving.serve_step import greedy_generate

from conftest import reduce_cfg

ARCHS = ["smollm-135m", "mamba2-780m", "gemma3-12b"]
B, S, S_MAX = 2, 20, 32


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-9)


def _flat_cache(jcache):
    """The reference's per-stage caches ([n_groups, ...] leaves) as one dict per layer."""
    out = []
    for stage in jcache:
        n_groups = np.shape(jax.tree.leaves(stage)[0])[0]
        for g in range(n_groups):
            for j in range(len(stage)):
                out.append(jax.tree.map(lambda a: np.asarray(a)[g], stage[f"l{j}"]))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    r = reduce_cfg(j_get_config(request.param))
    jm = j_build_model(r)
    params = jm.init(jax.random.PRNGKey(3))
    cfg = ArchConfig(**dataclasses.asdict(r))
    tm = build_model(cfg, "cpu")
    tm.load_state_dict(lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    toks = np.random.default_rng(5).integers(0, r.vocab_size, (B, S + 8)).astype(np.int32)
    return request.param, jm, params, tm, toks


def test_prefill_and_decode_match_reference(pair):
    arch, jm, params, tm, toks = pair
    lj, cj = jm.prefill(params, jnp.asarray(toks[:, :S]), {}, s_max=S_MAX)
    lt, ct = tm.prefill(toks[:, :S], s_max=S_MAX)
    assert _rel(lj, lt) < 1e-5, arch
    flat = _flat_cache(cj)
    assert len(flat) == len(ct) == tm.cfg.n_layers
    for fj, ft in zip(flat, ct):
        for name in fj:
            assert fj[name].shape == tuple(ft[name].shape), (arch, name)
            assert _rel(fj[name], ft[name]) < 1e-5, (arch, name)
    for i in range(3):
        lj, cj = jm.decode_step(params, cj, jnp.asarray(toks[:, S + i]), jnp.int32(S + i))
        lt, ct = tm.decode_step(ct, toks[:, S + i], S + i)
        assert _rel(lj, lt) < 1e-5, (arch, i)
    for fj, ft in zip(_flat_cache(cj), ct):
        for name in fj:
            assert _rel(fj[name], ft[name]) < 1e-5, (arch, name)


def test_greedy_generate_matches_reference(pair):
    arch, jm, params, tm, toks = pair
    want = np.asarray(j_greedy(jm, params, jnp.asarray(toks[:, :S]), steps=8, s_max=S_MAX))
    got = greedy_generate(tm, toks[:, :S], steps=8, s_max=S_MAX)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


def test_teacher_forced_decode_matches_full_prefill(pair):
    """The check of tests/test_models_smoke.py::test_decode_matches_full_forward, on the port."""
    arch, _, _, tm, toks = pair
    lg_full, _ = tm.prefill(toks[:, :S + 3], s_max=S_MAX)
    lg, cache = tm.prefill(toks[:, :S], s_max=S_MAX)
    for i in range(3):
        lg, cache = tm.decode_step(cache, toks[:, S + i], S + i)
    assert _rel(lg_full, lg) < 5e-4, arch


def test_cache_struct_matches_reference(pair):
    arch, jm, _, tm, toks = pair
    want = _flat_cache(jm.cache_struct(B, S_MAX))
    got = tm.cache_struct(B, S_MAX)
    _, prefilled = tm.prefill(toks[:, :S], s_max=S_MAX)
    for fj, ft, fp in zip(want, got, prefilled):
        assert set(fj) == set(ft) == set(fp)
        for name in fj:
            assert fj[name].shape == tuple(ft[name].shape) == tuple(fp[name].shape), (arch, name)
            assert str(fj[name].dtype) == str(ft[name].dtype).removeprefix("torch."), (arch, name)
            assert ft[name].dtype == fp[name].dtype and not ft[name].any()


def test_kernel_switch_is_plain_on_cpu(pair):
    """On the CPU the kernel wrappers run the plain versions themselves:
    ``use_kernels`` True and False give the same logits and caches, bitwise."""
    arch, _, _, tm, toks = pair
    plain = Model(tm.cfg, "cpu", use_kernels=False)
    plain.load_state_dict(tm.state_dict())
    la, ca = tm.prefill(toks[:, :S], s_max=S_MAX)
    lb, cb = plain.prefill(toks[:, :S], s_max=S_MAX)
    assert torch.equal(la, lb), arch
    for fa, fb in zip(ca, cb):
        for name in fa:
            assert torch.equal(fa[name], fb[name]), (arch, name)


def test_lm_params_from_numpy_errors():
    r = reduce_cfg(j_get_config("smollm-135m"))
    params = jax.tree.map(np.asarray, j_build_model(r).init(jax.random.PRNGKey(0)))
    cfg = ArchConfig(**dataclasses.asdict(r))
    bad = jax.tree.map(lambda a: a, params)
    bad["stages"][0]["l0"]["attn"]["wq"] = bad["stages"][0]["l0"]["attn"]["wq"][..., :-1]
    with pytest.raises(ValueError, match=r"stages\[0\]\.l0\.attn\.wq\[0\]"):
        lm_params_from_numpy(bad, cfg)
    bad = jax.tree.map(lambda a: a, params)
    del bad["stages"][0]["l0"]["mlp"]["w3"]
    with pytest.raises(KeyError, match="layers.0.mlp.w3"):
        lm_params_from_numpy(bad, cfg)
    bad = jax.tree.map(lambda a: a, params)
    bad["meta"] = np.zeros((4, r.d_model), np.float32)
    with pytest.raises(KeyError, match="unexpected leaf meta"):
        lm_params_from_numpy(bad, cfg)


def test_registry_and_unported_kinds():
    """Every config of the reference is registered, equal to the reference's
    field for field and in its parameter counts, and every layer kind is
    ported: ``Model`` builds each reduced config on the CPU. An unknown
    name raises ``KeyError``."""
    names = sorted(j_all_configs())
    assert len(names) == 10 and sorted(all_configs()) == names
    for arch in names:
        assert get_config(arch) == ArchConfig(**dataclasses.asdict(j_get_config(arch))), arch
        assert get_config(arch).param_count() == j_get_config(arch).param_count(), arch
        assert get_config(arch).active_param_count() == j_get_config(arch).active_param_count(), arch
        cfg = ArchConfig(**dataclasses.asdict(reduce_cfg(j_get_config(arch))))
        model = Model(cfg, "cpu")
        assert len(model.layers) + len(getattr(model, "enc_layers", ())) == len(_layer_kinds(cfg)), arch
    with pytest.raises(KeyError, match="no-such-model"):
        get_config("no-such-model")
