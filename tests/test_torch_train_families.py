"""Port parity: ``Model.loss_fn`` and every gradient leaf against
``jax.value_and_grad(repro.models.Model.loss_fn)`` for the LM kinds that
train (``dense``, ``local`` / ``global``, ``moe`` with and without MLA,
``cross``, ``enc`` / ``dec``, ``ssm``, ``hybrid``), on reduced configs
(``conftest.reduce_cfg``) with the reference's params carried across by
``convert.lm_params_from_numpy``: smollm-135m, gemma3-12b, qwen1.5-4b,
deepseek-moe-16b, deepseek-v3-671b, whisper-large-v3 (frames), mamba2-780m,
hymba-1.5b (meta tokens in front of the keys) and llama-3.2-vision-90b
(vision embeddings, its
``xgate`` set from the seed to [0.5, 1.5]: the reference's zeros would hide
every cross-attention, as in ``tests/test_torch_lm_encdec.py``).

The batch masks three targets (< 0) to exercise the reference's ``ntok``.
f32 compute: the loss within 1e-5 (relative), each gradient leaf within
1e-4 of the reference leaf's largest magnitude. deepseek-v3's bf16 params
have bf16 gradients on both sides, held within one bf16 rounding (2^-7 of
the leaf's scale), and once more with f32 params at 1e-4. Both kernel
paths (the kernels' ``FlashAttentionFn`` and ``SSDScanFn``, their plain
halves on the CPU, and ``use_kernels=False``, ``gqa_attend`` and
``ssd_chunked`` under autograd) and every ``remat`` mode give the same
gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model

from conftest import reduce_cfg

ARCHS = ["smollm-135m", "gemma3-12b", "qwen1.5-4b", "deepseek-moe-16b", "deepseek-v3-671b",
         "deepseek-v3-671b/f32", "whisper-large-v3", "llama-3.2-vision-90b", "mamba2-780m", "hymba-1.5b"]
B, S = 2, 16


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-30)


def _open_gates(params, seed=9):
    rng = np.random.default_rng(seed)
    for stage in params["stages"]:
        for layer in stage.values():
            if "xgate" in layer:
                layer["xgate"] = jnp.asarray(rng.uniform(0.5, 1.5, np.shape(layer["xgate"])).astype(np.float32))
    return params


def _batch(r, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, r.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, :3] = -1
    if r.family == "encdec":
        batch["frames"] = (0.1 * rng.standard_normal((B, r.encoder_frames, r.d_model))).astype(np.float32)
    if r.family == "vlm":
        batch["vision_embeds"] = (0.1 * rng.standard_normal((B, r.vision_tokens, r.d_model))).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """One reduced arch: the reference's loss and gradients (carried to the
    port's names), the port's config and params, and the batch."""
    arch, _, f32 = request.param.partition("/")
    r = reduce_cfg(j_get_config(arch))
    if f32:
        r = dataclasses.replace(r, param_dtype="float32")
    jm = j_build_model(r)
    params = _open_gates(jm.init(jax.random.PRNGKey(3)))
    batch = _batch(r)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = ArchConfig(**dataclasses.asdict(r))
    sd = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    want = {"loss": float(loss), "aux": float(metrics["aux"]),
            "grads": lm_params_from_numpy(jax.tree.map(np.asarray, grads), cfg)}
    return request.param, cfg, sd, batch, want


def _port_grads(cfg, sd, batch, **kw):
    tm = build_model(cfg, "cpu", **kw)
    tm.load_state_dict(sd)
    tm.requires_grad_(True)
    loss, metrics = tm.loss_fn(batch)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()], allow_unused=True)
    return float(loss.detach()), metrics, {n: torch.zeros_like(sd[n]) if g is None else g for n, g in zip(names, grads)}


def test_loss_and_grads_match_reference(family):
    arch, cfg, sd, batch, want = family
    loss, metrics, grads = _port_grads(cfg, sd, batch)
    assert loss == pytest.approx(want["loss"], rel=1e-5), arch
    assert float(metrics["aux"]) == pytest.approx(want["aux"], rel=1e-5, abs=1e-7), arch
    if cfg.n_experts:
        assert float(metrics["aux"]) > 0, arch
    assert set(grads) == set(want["grads"])
    bf16 = cfg.param_dtype == "bfloat16"
    for n, g in grads.items():
        assert g.dtype == sd[n].dtype, (arch, n)
        assert _rel(want["grads"][n].float(), g.float()) <= (2.0 ** -7 if bf16 else 1e-4), (arch, n)


def test_plain_attention_path_matches_reference(family):
    """``use_kernels=False``: attention as ``gqa_attend``, the SSD scan as
    ``ssd_chunked``, under autograd."""
    arch, cfg, sd, batch, want = family
    loss, _, grads = _port_grads(cfg, sd, batch, use_kernels=False)
    assert loss == pytest.approx(want["loss"], rel=1e-5), arch
    bf16 = cfg.param_dtype == "bfloat16"
    for n, g in grads.items():
        assert _rel(want["grads"][n].float(), g.float()) <= (2.0 ** -7 if bf16 else 1e-4), (arch, n)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b", "mamba2-780m", "hymba-1.5b"])
def test_remat_gives_the_same_gradients(arch, remat):
    """Recomputing each layer in the backward ("full"), or all but its
    matrix products ("dots"), changes no gradient bit on the CPU."""
    r = reduce_cfg(j_get_config(arch))
    cfg = ArchConfig(**dataclasses.asdict(r))
    batch = _batch(r, seed=2)
    tm = build_model(cfg, "cpu", seed=4)
    sd = {n: t.clone() for n, t in tm.state_dict().items()}
    l0, _, g0 = _port_grads(cfg, sd, batch)
    l1, _, g1 = _port_grads(dataclasses.replace(cfg, remat=remat), sd, batch)
    assert l0 == l1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), (arch, remat, n)

