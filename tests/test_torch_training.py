"""Port parity: LM training (``repro_torch.training``, ``TokenPipeline``,
``convert.lm_train_state_from_numpy``) against ``repro.training`` and
``repro.data.pipeline`` on the CPU.

* ``adamw_update`` (plain, factored, bf16 moments), ``schedule`` and the
  global-norm clip: the reference's on the same params and gradients, three
  steps, within 1e-6 of each leaf's scale (bf16 moments: one bf16 rounding);
* ``TokenPipeline``: bitwise the reference's corpus, DSI tables and batches;
* three ``make_train_step`` steps with 2 microbatches from the reference's
  params: its losses within 1e-5 and its params within 1e-4 of each leaf's
  scale (a tiny smollm-135m, f32);
* 2 x 8 microbatches = 1 x 16, the loss falls over 25 steps, ``ElasticRunner``
  resumes after a ``SimulatedFailure`` bitwise the uninterrupted run, a
  reference state carried across steps on as the reference does, and a
  state with bf16 and factored moments checkpoints bitwise.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import build_model as j_build_model
from repro.training import optimizer as jopt
from repro.training.train_step import init_state as j_init_state
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_numpy, lm_train_state_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.fault import ElasticRunner, SimulatedFailure
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, TrainState, init_state, make_train_step
from repro_torch.training.optimizer import adamw_init, adamw_update, global_norm, schedule

from conftest import reduce_cfg


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-30)


def _tiny_cfg():
    """The reference test's tiny smollm-135m (tests/test_training.py)."""
    return reduce_cfg(j_get_config("smollm-135m"), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=256, head_dim=16)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("kw", [{}, {"factored": True}, {"moment_dtype": "bfloat16"},
                                {"grad_clip": 0.05, "weight_decay": 0.3}])
def test_adamw_update_matches_reference(kw):
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=10, **kw)
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "b": (16,), "e": (3, 4, 5), "col": (6, 1)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    jp, tp = {n: jnp.asarray(a) for n, a in params.items()}, {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    jcfg, tcfg = jopt.AdamWConfig(**cfg), AdamWConfig(**cfg)
    js, ts = jopt.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    bf16 = kw.get("moment_dtype") == "bfloat16"
    for step in range(3):
        grads = {n: (rng.standard_normal(s) * (step + 1)).astype(np.float32) for n, s in shapes.items()}
        jp, js, jm = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jcfg))(
            jp, {n: jnp.asarray(g) for n, g in grads.items()}, js)
        tp, ts, tm = adamw_update(tp, {n: torch.from_numpy(g) for n, g in grads.items()}, ts, tcfg)
        assert ts["step"] == int(js["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
        for n in shapes:
            assert tp[n].dtype == torch.float32 and _rel(jp[n], tp[n]) < 1e-6, (kw, step, n)
            assert ts["m"][n].dtype == (torch.bfloat16 if bf16 else torch.float32)
            assert _rel(js["m"][n], _np(ts["m"][n])) < (2.0 ** -7 if bf16 else 1e-6), (kw, n)
            jv, tv = js["v"][n], ts["v"][n]
            if isinstance(jv, dict):
                assert set(tv) == {"vr", "vc"}
                for part in ("vr", "vc"):
                    assert _rel(jv[part], tv[part]) < 1e-6, (kw, n, part)
            else:
                assert _rel(jv, _np(tv)) < (2.0 ** -7 if bf16 else 1e-6), (kw, n)
    # the leaves the reference factors: both dims of the last two > 1
    assert {n for n, v in ts["v"].items() if isinstance(v, dict)} == (
        {"w", "e"} if kw.get("factored") else set())


@pytest.mark.parametrize("kw", [{}, {"factored": True}, {"moment_dtype": "bfloat16"}])
def test_adamw_update_in_row_slices_is_bitwise(kw, monkeypatch):
    """A leaf past ``UPDATE_SLICE`` elements updates in row slices with the
    whole leaf's bits (at 6: the [7, 3] leaf 2 rows a slice, the vector of
    11 in slices of 6, the [3, 2, 4] leaf a row a slice); factored leaves
    update whole. Three steps each way."""
    from repro_torch.training import optimizer as topt

    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=10, **kw)
    rng = np.random.default_rng(3)
    shapes = {"w": (7, 3), "b": (11,), "e": (3, 2, 4)}
    start = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for n, s in shapes.items()}
    grads = [{n: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for n, s in shapes.items()}
             for _ in range(3)]

    def run(slice_elems):
        monkeypatch.setattr(topt, "UPDATE_SLICE", slice_elems)
        p, st = dict(start), adamw_init(start, cfg)
        for g in grads:
            p, st, _ = adamw_update(p, g, st, cfg, stacked=lambda n: n == "b")
        return p, st

    monkeypatch.setattr(topt, "UPDATE_SLICE", 6)
    assert len(topt._row_slices(start["w"], start["w"])) == 4
    assert topt._row_slices(start["w"], {"vr": None}) is None
    (pw, sw), (ps, ss) = run(1 << 30), run(6)
    for n in shapes:
        assert torch.equal(pw[n], ps[n]) and torch.equal(sw["m"][n], ss["m"][n]), (kw, n)
        vw, vs = sw["v"][n], ss["v"][n]
        assert all(torch.equal(vw[k], vs[k]) for k in vw) if isinstance(vw, dict) else torch.equal(vw, vs)


def test_schedule_and_clip_match_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250):
        want = float(jopt.schedule(jopt.AdamWConfig(**cfg), jnp.int32(step)))
        assert float(schedule(AdamWConfig(**cfg), step)) == pytest.approx(want, rel=1e-6, abs=1e-12)
    g = {"a": np.full((4, 4), 3.0, np.float32), "b": np.arange(5, dtype=np.float32)}
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    assert float(global_norm({k: torch.from_numpy(v) for k, v in g.items()})) == pytest.approx(want, rel=1e-7)
    # a clipped step: every gradient scaled by clip / norm before the moments
    cfgc = AdamWConfig(lr=1.0, warmup_steps=0, weight_decay=0.0, grad_clip=1.0)
    p = {"a": torch.zeros(4, 4), "b": torch.zeros(5)}
    _, st, m = adamw_update(p, {k: torch.from_numpy(v) for k, v in g.items()}, adamw_init(p, cfgc), cfgc)
    assert float(m["grad_norm"]) == pytest.approx(want)
    torch.testing.assert_close(st["m"]["a"], torch.full((4, 4), 0.1 * 3.0 / want), rtol=1e-6, atol=0)


def test_token_pipeline_bitwise():
    for kw in ({"vocab_size": 64, "seq_len": 8, "n_docs": 32, "seed": 5},
               {"vocab_size": 300, "seq_len": 33, "n_docs": 100, "seed": 1}):
        jp, tp = JTokenPipeline(**kw), TokenPipeline(**kw)
        np.testing.assert_array_equal(jp.corpus, tp.corpus)
        assert tp.corpus.dtype == np.int32
        for epoch in (0, 3):
            np.testing.assert_array_equal(jp.dsi_epoch(epoch, 4, 10), tp.dsi_epoch(epoch, 4, 10))
        row = tp.dsi_epoch(0, 4, 10)[2]
        for key in ("tokens", "targets"):
            np.testing.assert_array_equal(jp.batch(row)[key], tp.batch(row)[key])
        for n_micro in (1, 2):
            for bj, bt in zip(jp.batches(8, 3, epoch=1, n_micro=n_micro), tp.batches(8, 3, epoch=1, n_micro=n_micro)):
                for key in ("tokens", "targets"):
                    assert bt[key].shape == (n_micro, 8 // n_micro, kw["seq_len"])
                    np.testing.assert_array_equal(bj[key], bt[key])


@pytest.fixture(scope="module")
def tiny():
    """The tiny smollm on both sides from the reference's params, and three
    reference train steps (2 microbatches of 8, seq 16) from them."""
    r = _tiny_cfg()
    jm = j_build_model(r)
    opt = dict(lr=1e-3, warmup_steps=2, decay_steps=50)
    jstate = j_init_state(jm, jax.random.PRNGKey(0), jopt.AdamWConfig(**opt))
    pipe = TokenPipeline(vocab_size=r.vocab_size, seq_len=16, n_docs=64, seed=2)
    batches = list(pipe.batches(16, 3, n_micro=2))
    jstep = jax.jit(j_make_train_step(jm, jopt.AdamWConfig(**opt)))
    states, losses, s = [jstate], [], jstate
    for b in batches:
        s, m = jstep(s, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(s)
        losses.append(float(m["loss"]))
    cfg = ArchConfig(**dataclasses.asdict(r))
    return cfg, opt, batches, states, losses


def _port_model(cfg, params):
    tm = build_model(cfg, "cpu")
    tm.load_state_dict(lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    return tm


def test_three_train_steps_match_reference(tiny):
    cfg, opt, batches, jstates, jlosses = tiny
    tm = _port_model(cfg, jstates[0].params)
    state = init_state(tm, AdamWConfig(**opt))
    step = make_train_step(tm, AdamWConfig(**opt))
    for i, b in enumerate(batches):
        state, m = step(state, b)
        assert float(m["loss"]) == pytest.approx(jlosses[i], rel=1e-5), i
        want = lm_params_from_numpy(jax.tree.map(np.asarray, jstates[i + 1].params), cfg)
        for n, t in state.params.items():
            assert _rel(want[n], t) < 1e-4, (i, n)
    assert state.step == 3 and state.opt["step"] == 3


def test_grad_accum_matches_single_batch(tiny):
    """2 microbatches of 8 == 1 microbatch of 16 (f32), the reference's test on the port."""
    cfg, opt, batches, jstates, _ = tiny
    tm = _port_model(cfg, jstates[0].params)
    state = init_state(tm, AdamWConfig(**opt))
    step = make_train_step(tm, AdamWConfig(**opt))
    b2 = batches[0]
    b1 = {k: v.reshape(1, 16, -1) for k, v in b2.items()}
    s1, m1 = step(state, b1)
    s2, m2 = step(state, b2)                 # the same state again: a step leaves it as it was
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for n in s1.params:
        torch.testing.assert_close(s1.params[n], s2.params[n], rtol=1e-4, atol=1e-6)


def test_loss_decreases_end_to_end():
    cfg = ArchConfig(**dataclasses.asdict(_tiny_cfg()))
    tm = build_model(cfg, "cpu", seed=0)
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100)
    state, step = init_state(tm, opt), make_train_step(tm, opt)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32, n_docs=256, seed=0)
    losses = []
    for b in pipe.batches(16, 25, n_micro=2):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_elastic_runner_resumes_bitwise():
    """A failure at step 6 resumes from the step-4 checkpoint (moments, step
    and params restored) and ends bitwise where the uninterrupted run ends."""
    cfg = ArchConfig(**dataclasses.asdict(_tiny_cfg()))
    opt = AdamWConfig(lr=1e-3)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16, n_docs=64, seed=1)
    batches = list(pipe.batches(8, 12, n_micro=1))
    tm = build_model(cfg, "cpu", seed=0)
    step_fn = make_train_step(tm, opt)
    init = init_state(tm, opt)               # a step leaves its input state as it was
    init_fn = lambda: init

    def run(failures):
        def loop(state, start, n_steps, on_step):
            for s in range(start, n_steps):
                if s in failures:
                    failures.remove(s)
                    raise SimulatedFailure("node died")
                state, m = step_fn(state, batches[s])
                on_step(s + 1, state, m)
            return state

        with tempfile.TemporaryDirectory() as d:
            runner = ElasticRunner(CheckpointManager(d, keep=3, save_interval=2), max_restarts=2)
            return runner.run(init_fn, loop, 12)

    state, _, restarts = run({6})
    clean, _, clean_restarts = run(set())
    assert (restarts, clean_restarts) == (1, 0)
    assert state.step == clean.step == 12 and state.opt["step"] == 12
    for n in clean.params:
        assert torch.equal(state.params[n], clean.params[n]), n
        assert torch.equal(state.opt["m"][n], clean.opt["m"][n]) and torch.equal(state.opt["v"][n], clean.opt["v"][n])


def test_train_state_carried_across(tiny):
    """The reference's state after two steps, carried across, steps on as
    the reference's third step does; factored and bf16 moments carry their
    form and values."""
    cfg, opt, batches, jstates, jlosses = tiny
    js = jax.tree.map(np.asarray, jstates[2])
    state = lm_train_state_from_numpy(js.params, js.opt, js.step, cfg)
    assert isinstance(state, TrainState) and state.step == 2 and state.opt["step"] == 2
    m_want = lm_params_from_numpy(js.opt["m"], cfg)
    for n in state.params:
        assert torch.equal(state.opt["m"][n], m_want[n])
    tm = build_model(cfg, "cpu")
    init_state(tm, AdamWConfig(**opt))
    state, m = make_train_step(tm, AdamWConfig(**opt))(state, batches[2])
    assert float(m["loss"]) == pytest.approx(jlosses[2], rel=1e-5)
    want = lm_params_from_numpy(jax.tree.map(np.asarray, jstates[3].params), cfg)
    for n, t in state.params.items():
        assert _rel(want[n], t) < 1e-4, n

    # factored second moments and bf16 moments, one reference step
    r = _tiny_cfg()
    jm = j_build_model(r)
    fcfg = jopt.AdamWConfig(factored=True, moment_dtype="bfloat16", **opt)
    fs = j_init_state(jm, jax.random.PRNGKey(1), fcfg)
    fs, _ = jax.jit(j_make_train_step(jm, fcfg))(fs, {k: jnp.asarray(v) for k, v in batches[0].items()})
    fs = jax.tree.map(np.asarray, fs)
    st = lm_train_state_from_numpy(fs.params, fs.opt, fs.step, cfg)
    wq = fs.opt["v"]["stages"][0]["l0"]["attn"]["wq"]          # [groups, D, H, hd]: factored per layer
    assert st.opt["v"]["layers.1.attn.wq"]["vr"].shape == wq["vr"].shape[1:]
    np.testing.assert_array_equal(st.opt["v"]["layers.1.attn.wq"]["vc"].numpy(), wq["vc"][1])
    assert st.opt["m"]["layers.0.mlp.w1"].dtype == torch.bfloat16
    ln = fs.opt["v"]["stages"][0]["l0"]["ln1"]["scale"]         # [2, D] stacked: factored across layers
    full = ln["vr"][:, None] * ln["vc"][None, :] / ln["vr"].mean()
    np.testing.assert_allclose(st.opt["v"]["layers.1.ln1.scale"].float().numpy(), full[1], rtol=1e-6)
    e = fs.opt["v"]["embed"]["table"]                          # top level: factored as the reference
    np.testing.assert_array_equal(st.opt["v"]["embed.table"]["vr"].numpy(), e["vr"])


def test_bf16_moments_checkpoint_roundtrip():
    """A state with bf16 moments (which numpy lacks: saved as their int16
    bits) and factored ones restores bitwise, in its dtypes."""
    cfg = ArchConfig(**dataclasses.asdict(_tiny_cfg()))
    tm = build_model(cfg, "cpu", seed=0)
    opt = AdamWConfig(moment_dtype="bfloat16", factored=True)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16, n_docs=16, seed=3)
    state, _ = make_train_step(tm, opt)(init_state(tm, opt), next(pipe.batches(4, 1)))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=1, save_interval=1)
        mgr.maybe_save(state, 1)
        restored, step = mgr.restore_latest_valid(init_state(tm, opt))
    assert step == 1 and restored.step == 1 and restored.opt["step"] == 1
    for n in state.params:
        assert torch.equal(restored.params[n], state.params[n])
        m = restored.opt["m"][n]
        assert m.dtype == torch.bfloat16 and torch.equal(m, state.opt["m"][n]), n
        v, want = restored.opt["v"][n], state.opt["v"][n]
        if isinstance(want, dict):
            assert all(torch.equal(v[k], want[k]) for k in ("vr", "vc")), n
        else:
            assert v.dtype == torch.bfloat16 and torch.equal(v, want), n
