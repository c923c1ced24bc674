"""Port parity: the SSD scan's backward and the ``ssm`` / ``hybrid``
training layers against ``repro`` on the CPU.

* ``ref.ssd_chunked_bwd`` (the backward kernel's plain version, written
  out step by step) against ``jax.vjp`` of ``repro.models.mamba._ssd_chunked``
  and against ``torch.autograd`` of ``ssd_chunked``, at small shapes with
  one chunk, several, and one longer than the sequence: each gradient
  within 1e-4 of its largest magnitude (f32);
* ``SSDScanFn`` on CPU tensors: its two plain halves, bitwise
  ``ssd_chunked`` and ``ssd_chunked_bwd``, no kernel counted;
* ``mamba_train`` (both paths) against the reference's ``mamba_train``
  under ``jax.value_and_grad``: the output within 1e-5 and every
  gradient (params and input) within 1e-4 of its scale;
* hymba's ``attention_train(meta=...)`` (both paths) against the
  reference's ``blocks._self_attn`` meta-token branch in "train" mode,
  ``meta`` included in the gradients;
* a reference training state of reduced mamba2-780m and hymba-1.5b after
  one step carried by ``convert.lm_train_state_from_numpy`` (``meta``,
  ``a_log``, ``dt_bias``, ``d_skip``, the conv, the gates and their AdamW
  moments) steps on as the reference's second step does;
* the wrapper's input checks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import blocks as jb
from repro.models import layers as jl
from repro.models import build_model as j_build_model
from repro.models import mamba as jm
from repro.training import optimizer as jopt
from repro.training.train_step import init_state as j_init_state
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_numpy, lm_train_state_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_chunked_bwd
from repro_torch.models import build_model
from repro_torch.models import mamba as tm
from repro_torch.models.layers import attention_train
from repro_torch.training import AdamWConfig, init_state, make_train_step

from conftest import reduce_cfg

RNG = np.random.default_rng(25)


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-30)


def _inputs(B, L, H, P, N):
    x = RNG.standard_normal((B, L, H, P)).astype(np.float32)
    loga = (-np.abs(RNG.standard_normal((B, L, H))) * 0.4).astype(np.float32)
    b = (RNG.standard_normal((B, L, N)) * 0.3).astype(np.float32)
    c = (RNG.standard_normal((B, L, N)) * 0.3).astype(np.float32)
    dy = RNG.standard_normal((B, L, H, P)).astype(np.float32)
    return x, loga, b, c, dy


@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 64),        # one chunk
    (2, 96, 3, 8, 16, 32),        # three chunks, more heads than batch rows
    (1, 128, 2, 32, 16, 16),      # eight short chunks
    (2, 48, 1, 16, 4, 128),       # the chunk longer than the sequence: min(chunk, L)
])
def test_ssd_chunked_bwd_matches_jax_vjp_and_autograd(B, L, H, P, N, chunk):
    x, loga, b, c, dy = _inputs(B, L, H, P, N)
    Q = min(chunk, L)
    h0 = jnp.zeros((B, H, N, P), jnp.float32)
    vjp = jax.jit(lambda dy, *a: jax.vjp(lambda *a: jm._ssd_chunked(*a, h0, Q)[0], *a)[1](dy))
    want = vjp(*map(jnp.asarray, (dy, x, loga, b, c)))
    got = ssd_chunked_bwd(*map(torch.from_numpy, (x, loga, b, c, dy)), Q)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, loga, b, c)]
    auto = torch.autograd.grad(ssd_chunked(*ins, None, Q)[0], ins, torch.from_numpy(dy))
    for name, w, g, a in zip(("dx", "dloga", "db", "dc"), want, got, auto):
        assert g.shape == a.shape and g.dtype == torch.float32, name
        assert _rel(w, g) <= 1e-4, (name, _rel(w, g))
        assert _rel(a, g) <= 1e-4, (name, _rel(a, g))


def test_ssd_scan_fn_on_the_cpu():
    """CPU tensors take the two plain halves, bitwise; no kernel is counted."""
    x, loga, b, c, dy = map(torch.from_numpy, _inputs(2, 64, 2, 16, 8))
    counts = (ssd_ops.launches, ssd_ops.launches_bwd, ssd_ops.launches_bwd_bf16, ssd_ops.launches_bwd_f32)
    ins = [t.clone().requires_grad_(True) for t in (x, loga, b, c)]
    y = ssd_ops.SSDScanFn.apply(*ins, 32)
    assert torch.equal(y, ssd_chunked(x, loga, b, c, None, 32)[0])
    got = torch.autograd.grad(y, ins, dy)
    for g, w in zip(got, ssd_chunked_bwd(x, loga, b, c, dy, 32)):
        assert torch.equal(g, w)
    assert torch.equal(ssd_ops.ssd_scan_bwd(x, loga, b, c, dy, chunk=32)[0], got[0])
    with torch.no_grad():
        assert torch.equal(ssd_ops.SSDScanFn.apply(x, loga, b, c, 32), y.detach())
    assert (ssd_ops.launches, ssd_ops.launches_bwd, ssd_ops.launches_bwd_bf16, ssd_ops.launches_bwd_f32) == counts


@pytest.fixture(scope="module")
def mamba_case():
    """A reduced mamba2 block: its params (non-zero biases), input,
    cotangent, and the reference's output and gradients."""
    cfg = reduce_cfg(j_get_config("mamba2-780m"))
    jp = jm.init_mamba(jax.random.PRNGKey(4), cfg)
    jp = dict(jp, conv_b=jnp.asarray(RNG.normal(0, 0.1, jp["conv_b"].shape).astype(np.float32)),
              dt_bias=jnp.asarray(RNG.normal(0, 0.5, jp["dt_bias"].shape).astype(np.float32)),
              d_skip=jnp.asarray(RNG.uniform(0.5, 1.5, jp["d_skip"].shape).astype(np.float32)),
              norm={"scale": jnp.asarray(RNG.uniform(0.5, 1.5, jp["norm"]["scale"].shape).astype(np.float32))})
    x = (RNG.standard_normal((2, 32, cfg.d_model)) * 0.5).astype(np.float32)
    cot = RNG.standard_normal((2, 32, cfg.d_model)).astype(np.float32)

    def loss(p, x):
        out = jm.mamba_train(p, x, cfg, chunk=16)
        return jnp.sum(out * cot), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    return cfg, jax.tree.map(np.asarray, jp), x, cot, np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mamba_train_matches_reference(mamba_case, use_kernels):
    cfg, jp, x, cot, jout, jgp, jgx = mamba_case
    leaves = {("norm.scale" if k == "norm" else k): torch.from_numpy(np.array(v["scale"] if k == "norm" else v))
              .requires_grad_(True) for k, v in jp.items()}
    p = {k: v for k, v in leaves.items() if k != "norm.scale"}
    p["norm"] = {"scale": leaves["norm.scale"]}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.mamba_train(p, xt, ArchConfig(**dataclasses.asdict(cfg)), chunk=16, use_kernels=use_kernels)
    assert _rel(jout, out.detach()) <= 1e-5
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [xt, *leaves.values()])
    assert _rel(jgx, grads[0]) <= 1e-4
    for name, g in zip(leaves, grads[1:]):
        want = jgp["norm"]["scale"] if name == "norm.scale" else jgp[name]
        assert _rel(want, g) <= 1e-4, name


@pytest.fixture(scope="module")
def hymba_case():
    """A reduced hymba layer's attention params, input, meta tokens,
    cotangent, and the reference's meta-token branch in "train" mode."""
    r = reduce_cfg(j_get_config("hymba-1.5b"))
    B, S, M = 2, 24, r.meta_tokens
    jp = jax.tree.map(np.asarray, jl.init_attention(jax.random.PRNGKey(5), r))
    x = (RNG.standard_normal((B, S, r.d_model)) * 0.5).astype(np.float32)
    meta = RNG.standard_normal((M, r.d_model)).astype(np.float32)
    cot = RNG.standard_normal((B, S, r.d_model)).astype(np.float32)

    def loss(p, x, meta):
        out, cache = jb._self_attn(p, x, jb.Ctx(cfg=r, mode="train", positions=jnp.arange(S), meta=meta), "hybrid")
        assert cache is None
        return jnp.sum(out * cot), out

    (_, out), jg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(meta))
    return r, jp, x, meta, cot, np.asarray(out), jax.tree.map(np.asarray, jg)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_hymba_attention_train_with_meta_matches_reference(hymba_case, use_kernels):
    """The meta tokens lead the keys (positions 0..M-1), every query sees
    them, the window covers the rest; gradients reach ``meta`` through k, v."""
    r, jp, x, meta, cot, jout, jg = hymba_case
    cfg = ArchConfig(**dataclasses.asdict(r))
    S = x.shape[1]
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
    xt, mt = (torch.from_numpy(a).requires_grad_(True) for a in (x, meta))
    out = attention_train(tp, xt, torch.arange(S), cfg, window=cfg.local_window, use_kernels=use_kernels, meta=mt)
    assert _rel(jout, out.detach()) <= 1e-5
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [*tp.values(), xt, mt])
    for name, g in zip(tp, grads):
        assert _rel(jg[0][name], g) <= 1e-4, name
    assert _rel(jg[1], grads[-2]) <= 1e-4 and _rel(jg[2], grads[-1]) <= 1e-4
    assert float(grads[-1].abs().max()) > 0


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_train_state_of_ssm_and_hybrid_carried_across(arch):
    """The reference's state after one step (params and AdamW moments of
    every leaf: ``meta``, ``a_log``, ``dt_bias``, ``d_skip``, ``conv_w``,
    the gates) carried across steps on as the reference's second step."""
    r = reduce_cfg(j_get_config(arch), n_layers=1)
    cfg = ArchConfig(**dataclasses.asdict(r))
    jmodel = j_build_model(r)
    opt = dict(lr=1e-3, warmup_steps=1, decay_steps=20)
    pipe = TokenPipeline(vocab_size=r.vocab_size, seq_len=16, n_docs=16, seed=4)
    batches = list(pipe.batches(4, 2, n_micro=2))
    jstep = jax.jit(j_make_train_step(jmodel, jopt.AdamWConfig(**opt)))
    js = j_init_state(jmodel, jax.random.PRNGKey(2), jopt.AdamWConfig(**opt))
    js1, _ = jstep(js, {k: jnp.asarray(v) for k, v in batches[0].items()})
    js2, jm2 = jstep(js1, {k: jnp.asarray(v) for k, v in batches[1].items()})
    js1, js2 = jax.tree.map(np.asarray, js1), jax.tree.map(np.asarray, js2)

    state = lm_train_state_from_numpy(js1.params, js1.opt, js1.step, cfg)
    names = set(state.params)
    want_leaves = {"layers.0.ssm.a_log", "layers.0.ssm.dt_bias", "layers.0.ssm.d_skip", "layers.0.ssm.conv_w"}
    if arch == "hymba-1.5b":
        want_leaves |= {"meta", "layers.0.gate_attn", "layers.0.gate_ssm"}
    assert want_leaves <= names and set(state.opt["m"]) == names
    model = build_model(cfg, "cpu")
    init_state(model, AdamWConfig(**opt))
    state, m = make_train_step(model, AdamWConfig(**opt))(state, batches[1])
    assert float(m["loss"]) == pytest.approx(float(jm2["loss"]), rel=1e-5)
    want = lm_train_state_from_numpy(js2.params, js2.opt, js2.step, cfg)
    assert state.step == want.step == 2
    for n in names:
        assert _rel(want.params[n], state.params[n]) <= 1e-4, n
        assert _rel(want.opt["m"][n], state.opt["m"][n]) <= 1e-4, n
        assert _rel(want.opt["v"][n], state.opt["v"][n]) <= 1e-4, n


def test_wrapper_input_checks():
    x, loga, b, c, dy = map(torch.from_numpy, _inputs(1, 64, 2, 16, 8))
    n0 = ssd_ops.launches_bwd
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_scan_bwd(x, loga, b, c, dy[:, :32])
    with pytest.raises(ValueError, match="want x"):
        ssd_ops.ssd_scan_bwd(x, loga[..., :1], b, c, dy)
    with pytest.raises(ValueError, match="want x"):
        ssd_ops.ssd_scan_bwd(x, loga, b, c[..., :4], dy)
    with pytest.raises(ValueError, match="does not pair"):
        ssd_ops.ssd_scan_bwd(x, loga, b[:, :32], c[:, :32], dy)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ops.ssd_scan_bwd(x, loga, b, c, dy, chunk=48)
    assert ssd_ops.launches_bwd == n0
