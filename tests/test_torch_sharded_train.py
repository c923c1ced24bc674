"""Port parity: ``make_sharded_train_step`` (``repro_torch.training``) on a
gloo world of 4 CPU ranks, a (data 2, model 2) mesh, against
``make_train_step`` in one process and ``repro.training.make_train_step``.

* two variants of the reference's tiny smollm-135m (f32, 2 layers): 4 heads
  over 2 KV heads, which shard on heads over ``model``, and 3 heads over 1,
  which do not divide it and drive ``seq_shard_qkv`` (queries split on the
  sequence, the attention at each shard's query offset); and a tiny
  hymba-1.5b with 3 heads (its 4 meta keys in front of each shard's keys,
  window 8, and the SSD scan's 8 heads split over ``model``); 2 steps of 2
  microbatches of 8 from the reference's initial state
  (``convert.lm_train_state_from_numpy``): losses within 1e-5, every
  gathered leaf (params, m, v) within 1e-4 of its scale. hymba's params
  are held by their moments only: after AdamW's second step the port in
  one process is itself up to 3.3e-4 of a leaf's scale from the reference
  (``meta``: AdamW divides by the root of a second moment built from small
  gradients), while m and v, which carry the gradients, agree within 2e-5;
* the plain attention of one query shard (``_local_attend`` at a shard's
  offset, causal, windowed with a prefix) equals the reference's
  ``gqa_attend`` with that ``MaskSpec`` offset.

The ranks run ``tests/torch_lm_mesh_ranks.py`` (no jax), each world in its
own processes (``launch.mesh.run_world``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models.layers import MaskSpec as JMaskSpec
from repro.models.layers import gqa_attend as j_gqa_attend
from repro.training import optimizer as jopt
from repro.training.train_step import init_state as j_init_state
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_train_state_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import run_world
from repro_torch.models.layers import _local_attend
from repro_torch.training import AdamWConfig, make_train_step

from conftest import reduce_cfg

OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=50)


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-30)


def _np_state(state):
    conv = lambda t: t.detach().float().numpy() if isinstance(t, torch.Tensor) else t  # noqa: E731
    return {"params": {n: conv(t) for n, t in state.params.items()},
            "m": {n: conv(t) for n, t in state.opt["m"].items()},
            "v": {n: conv(t) for n, t in state.opt["v"].items()}}


# variant: (arch, reduced widths, the state's trees held to 1e-4 of their scale)
VARIANTS = {
    "heads_shard": ("smollm-135m", dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                                        head_dim=16), ("params", "m", "v")),
    "seq_shard": ("smollm-135m", dict(n_layers=2, d_model=64, n_heads=3, n_kv_heads=1, d_ff=128, vocab_size=256,
                                      head_dim=16), ("params", "m", "v")),
    "hymba_seq_shard": ("hymba-1.5b", dict(n_layers=2, n_heads=3, n_kv_heads=1, vocab_size=256), ("m", "v")),
}


def _variant(arch, over):
    """The reference's 2 steps, the port's in one process, and the sharded
    world's arguments."""
    r = reduce_cfg(j_get_config(arch), **over)
    cfg = ArchConfig(**dataclasses.asdict(r))
    jm = j_build_model(r)
    jstate = j_init_state(jm, jax.random.PRNGKey(0), jopt.AdamWConfig(**OPT))
    batches = list(TokenPipeline(vocab_size=256, seq_len=16, n_docs=64, seed=2).batches(16, 2, n_micro=2))
    jstep = jax.jit(j_make_train_step(jm, jopt.AdamWConfig(**OPT)))
    js, jlosses = jstate, []
    for b in batches:
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(m["loss"]))
    np_tree = lambda t: jax.tree.map(np.asarray, t)                             # noqa: E731
    start = lambda: lm_train_state_from_numpy(np_tree(jstate.params), np_tree(jstate.opt),  # noqa: E731
                                              jstate.step, cfg)
    want = lm_train_state_from_numpy(np_tree(js.params), np_tree(js.opt), js.step, cfg)

    from repro_torch.models import build_model
    tm = build_model(cfg, "cpu")
    tm.requires_grad_(True)
    step = make_train_step(tm, AdamWConfig(**OPT))
    local, losses = start(), []
    for b in batches:
        local, m = step(local, b)
        losses.append(float(m["loss"]))
    return (jlosses, _np_state(want), losses, _np_state(local)), (cfg, OPT, batches, start())


@pytest.fixture(scope="module")
def runs():
    """Every variant's results; the sharded runs in one world of 4."""
    done = {name: _variant(arch, over) for name, (arch, over, _) in VARIANTS.items()}
    worlds = run_world("torch_lm_mesh_ranks:sharded_runs", 4,
                       args=((2, 2), [args for _, args in done.values()]), timeout_s=300)
    return {name: (*done[name][0], [w[i] for w in worlds]) for i, name in enumerate(done)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_step_matches_one_process_and_reference(runs, variant):
    H, trees = variant, VARIANTS[variant][2]
    jlosses, want, losses, local, world = runs[variant]
    sharded = world[0]
    for other in world[1:]:                       # every rank gathers the same state
        np.testing.assert_array_equal(other["loss"], sharded["loss"])
    for i in range(2):
        assert sharded["loss"][i] == pytest.approx(losses[i], rel=1e-5), i
        assert sharded["loss"][i] == pytest.approx(jlosses[i], rel=1e-5), i
    got = {"params": sharded["params"], "m": sharded["opt"]["m"], "v": sharded["opt"]["v"]}
    for tree in trees:
        for n in local[tree]:
            assert _rel(local[tree][n], got[tree][n]) < 1e-4, (H, tree, n)
            assert _rel(want[tree][n], got[tree][n]) < 1e-4, (H, tree, n)
    assert sharded["step"] == 2


@pytest.mark.parametrize("mask", [dict(causal=True, window=0, prefix=0),
                                  dict(causal=True, window=24, prefix=8)])
def test_query_shard_attention_matches_reference(mask):
    """A rank's shard r of tp queries against the whole keys: offset M + r S / tp."""
    rng = np.random.default_rng(3)
    B, S, tp, H, KV, hd, M = 2, 64, 4, 6, 2, 16, mask["prefix"]
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, M + S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, M + S, KV, hd)).astype(np.float32)
    full = np.asarray(j_gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   mask_spec=JMaskSpec(offset=M, **mask)))
    Sl = S // tp
    for r in range(tp):
        want = np.asarray(j_gqa_attend(jnp.asarray(q[:, r * Sl:(r + 1) * Sl]), jnp.asarray(k), jnp.asarray(v),
                                       mask_spec=JMaskSpec(offset=M + r * Sl, **mask)))
        got = _local_attend(torch.from_numpy(q[:, r * Sl:(r + 1) * Sl]), torch.from_numpy(k),
                            torch.from_numpy(v), offset=M, use_kernels=False, r=r, seq_sharded=True,
                            n_heads=H, n_kv=KV, **mask).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, full[:, r * Sl:(r + 1) * Sl], rtol=1e-5, atol=1e-6)
