"""Port parity: LM serving on a mesh (``repro_torch.serving.make_serve_fns``)
on a gloo world of 4 CPU ranks, a (data 2, model 2) mesh, against the port
in one process: the dense and SSM kinds (the MoE kinds are in
``tests/test_torch_lm_serve_moe.py``, which shares these helpers).

Reduced configs (``conftest.reduce_cfg``, f32), the reference's params
carried across (``convert.lm_params_from_numpy``): smollm-135m with 4 heads
over 2 KV heads (heads that shard over ``model``) and with 3 heads over 1
(``seq_shard_qkv``'s query split in prefill); hymba-1.5b (4 meta tokens,
window 8, the SSD state's heads and the conv's channels over ``model``).
Batch 4, an 8-token prompt, ``s_max`` 16 (the caches' length split over
``model``: the second shard starts empty), then 4 greedy decode steps. Each
config runs ``flash_decode`` off and on and the "dus" and "where" cache
updates (smollm's first in all four pairings, the others as (off, "dus")
and (on, "where")): the greedy tokens equal the port's in one process, every
step's gathered logits and the gathered caches after prefill and after the
last step are within 1e-5 of their scale (the largest magnitude), and
decode leaves the caches where ``cache_specs`` puts them (batch over
``data``, length over ``model``; ``h`` heads and ``conv`` channels over
``model``).

The ranks run ``tests/torch_lm_serve_ranks.py`` (no jax), in one world.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import run_world
from repro_torch.models.model import build_model

from conftest import reduce_cfg

B, S, STEPS, S_MAX = 4, 8, 4, 16
ALL_PAIRS = [dict(flash_decode=f, decode_cache_update=u) for f in (False, True) for u in ("dus", "where")]
TWO = [dict(flash_decode=False, decode_cache_update="dus"), dict(flash_decode=True, decode_cache_update="where")]
SMOLLM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)
CASES = {   # name: (arch, reduce_cfg overrides, variants)
    "smollm_heads": ("smollm-135m", SMOLLM, ALL_PAIRS),
    "smollm_3heads": ("smollm-135m", dict(SMOLLM, n_heads=3, n_kv_heads=1), TWO),
    "hymba": ("hymba-1.5b", dict(vocab_size=256), TWO),
}


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-30)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _case(arch, over):
    r = reduce_cfg(j_get_config(arch), **over)
    params = j_build_model(r).init(jax.random.PRNGKey(0))
    cfg = ArchConfig(**dataclasses.asdict(r))
    state = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    return r, params, cfg, state


def _one_process(cfg, state, prompt):
    """Prefill and greedy decode in one process: logits per step, tokens, caches."""
    m = build_model(cfg, "cpu", seed=0)
    m.load_state_dict(state)
    logits, caches = m.prefill(torch.from_numpy(prompt), s_max=S_MAX)
    out = {"logits": [logits.float().numpy()], "prefill_caches": _np(caches)}
    tok = torch.argmax(logits, -1)
    toks = [tok]
    for i in range(STEPS):
        logits, caches = m.decode_step(caches, tok, S + i)
        out["logits"].append(logits.float().numpy())
        tok = torch.argmax(logits, -1)
        toks.append(tok)
    out["tokens"], out["caches"] = torch.stack(toks, 1).numpy(), _np(caches)
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.detach().float().numpy().copy()        # decode writes the caches in place


def run_cases(cases: dict, moe=None):
    """Each case's single-process run, then every case's meshed runs in one
    world of 4 (and ``moe_shards`` of ``moe``: (case name, x) for a MoE
    case). A case is (arch, ``reduce_cfg`` overrides, variants[, batch]),
    the batch ``B`` unless given. Returns ({name: (r, params, cfg, state, prompt, one-process
    run)}, rank 0's meshed runs in case order, every rank's ``moe_shards``)."""
    rng = np.random.default_rng(5)
    done, runs = {}, []
    for name, (arch, over, variants, *batch) in cases.items():
        r, params, cfg, state = _case(arch, over)
        prompt = rng.integers(0, cfg.vocab_size, (batch[0] if batch else B, S))
        done[name] = (r, params, cfg, state, prompt, _one_process(cfg, state, prompt))
        runs.append((cfg, state, prompt, STEPS, S_MAX, variants))
    moe_args = None if moe is None else (done[moe[0]][2], done[moe[0]][3], moe[1])
    ranks = run_world("torch_lm_serve_ranks:serve_world", 4, args=((2, 2), runs, moe_args),
                      timeout_s=420, collective_timeout_s=120)
    return done, ranks[0][0], [r[1] for r in ranks]


def check_case(cases: dict, done, meshed, case):
    """A case's meshed runs against its single-process run (see the module note)."""
    want, cfg = done[case][5], done[case][2]
    split = done[case][4].shape[0] % 2 == 0          # the batch over data, else the length over both axes
    for variant, got in zip(cases[case][2], meshed[list(cases).index(case)]):
        np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=f"{case} {variant}")
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            assert _rel(w, g) < 1e-5, (case, variant, "logits", i)
        for key in ("prefill_caches", "caches"):
            for (n, w), (_, g) in zip(_leaves(want[key]), _leaves(got[key])):
                assert w.shape == g.shape and _rel(w, g) < 1e-5, (case, variant, key, n)
        for n, pl in _leaves(got["placements"]):
            leaf = n.rsplit(".", 1)[-1]
            want_pl = ("S(0)", "S(2)") if leaf == "conv" else ("S(0)", "S(1)") if split else ("S(1)", "S(1)")
            assert pl == want_pl, (case, variant, n, pl)
        n_moe = sum(k == "moe" for k in build_model(cfg, "meta").kinds) if cfg.n_experts else 0
        assert got["a2a_per_step"] == [2 * n_moe] * STEPS, (case, got["a2a_per_step"])
        assert got["dp_spec"] == ("data",)


@pytest.fixture(scope="module")
def world():
    done, meshed, _ = run_cases(CASES)
    return done, meshed


@pytest.mark.parametrize("case", list(CASES))
def test_meshed_serving_matches_one_process(world, case):
    check_case(CASES, *world, case)
