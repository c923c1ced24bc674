"""Port parity: the MoE kinds served on a mesh (``make_serve_fns``, the
expert-parallel MoE over ``Mesh.all_to_all``) on a gloo world of 4 CPU
ranks, a (data 2, model 2) mesh, against the port in one process and
against ``repro`` (helpers and settings: ``tests/test_torch_lm_serve.py``).

* deepseek-moe-16b with ``ep_mode="shard_map"`` (8 experts, top-2, 2 shared
  experts) and deepseek-v3-671b (MLA and the shard_map MoE after a dense
  layer, bf16 params), ``flash_decode`` off with "dus" and on with "where":
  greedy tokens equal the port's in one process, logits and caches within
  1e-5 of their scale, caches placed by ``cache_specs``, 2 ``all_to_all``
  calls a MoE layer a step; and deepseek-moe-16b at batch 1, which the
  ``data`` axis does not divide: the tokens whole on every rank (capacity
  from the whole batch, the gspmd form's function), the experts still
  split over ``model``, the caches' length over both axes;
* with a capacity that drops tokens (``capacity_factor`` 1: capacity 4 from
  each data shard's 16 tokens), each data shard's MoE output equals the
  reference's ``moe_apply_gspmd`` on that shard's tokens (the reference's
  shard_map semantics), and the whole meshed prefill and decode equal the
  reference's own on 4 host devices (a subprocess that sets its own
  ``XLA_FLAGS``), greedy tokens identical, logits within 1e-5; the port in
  one process (capacity from all 32 tokens) differs.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import moe as j_moe

from test_torch_lm_serve import B, S, S_MAX, STEPS, TWO, _rel, check_case, run_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {   # name: (arch, reduce_cfg overrides, variants)
    "deepseek_moe": ("deepseek-moe-16b", dict(vocab_size=256, ep_mode="shard_map"), TWO),
    "deepseek_v3": ("deepseek-v3-671b", dict(vocab_size=256, ep_mode="shard_map"), TWO),
    "drops": ("deepseek-moe-16b", dict(vocab_size=256, ep_mode="shard_map", capacity_factor=1.0),
              [dict(flash_decode=True, decode_cache_update="where")]),
    "batch1": ("deepseek-moe-16b", dict(vocab_size=256, ep_mode="shard_map"), TWO, 1),
}


@pytest.fixture(scope="module")
def world():
    x = np.random.default_rng(6).standard_normal((B, S, 128)).astype(np.float32)
    done, meshed, moe = run_cases(CASES, moe=("drops", x))
    return done, meshed, moe, x


@pytest.mark.parametrize("case", ["deepseek_moe", "deepseek_v3", "batch1"])
def test_meshed_moe_serving_matches_one_process(world, case):
    check_case(CASES, *world[:2], case)


def test_shard_map_moe_matches_reference_per_shard(world):
    """Capacity from each data shard's tokens: the reference's gspmd form on that shard."""
    done, _, moe, x = world
    r, params = done["drops"][:2]
    assert x.shape[-1] == r.d_model
    stage = next(st for st in params["stages"] if "moe" in st["l0"])
    p = jax.tree.map(lambda a: a[0], stage["l0"]["moe"])
    dropped = False
    for rank in moe:
        d = rank["rows"]
        xs = jnp.asarray(x[d * 2:(d + 1) * 2])
        want, _ = j_moe.moe_apply_gspmd(p, xs, r)
        idx, _, _ = j_moe._route(p, xs.reshape(-1, r.d_model), r)
        T = 2 * S
        _, keep = j_moe._dispatch_indices(idx, r, T, j_moe._capacity(T, r))
        dropped |= not bool(np.asarray(keep).all())
        np.testing.assert_allclose(rank["y_local"], np.asarray(want), rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
        assert rank["a2a"] == 2
    assert dropped, "the capacity drops no token: the case tests nothing"


REF_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
sys.path.insert(0, sys.argv[3])
from conftest import reduce_cfg
from repro.configs import get_config
from repro.models import build_model
over, prompt = json.loads(sys.argv[1]), np.array(json.loads(sys.argv[2]), np.int32)
r = reduce_cfg(get_config("deepseek-moe-16b"), **over)
params = build_model(r).init(jax.random.PRNGKey(0))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
m = build_model(r, mesh)
logits, cache = jax.jit(lambda p, t: m.prefill(p, t, {}, s_max=%d))(params, jnp.asarray(prompt))
decode = jax.jit(m.decode_step)
out, toks = [np.asarray(logits).tolist()], [np.asarray(jnp.argmax(logits, -1))]
for i in range(%d):
    logits, cache = decode(params, cache, jnp.asarray(toks[-1]), jnp.int32(prompt.shape[1] + i))
    out.append(np.asarray(logits).tolist())
    toks.append(np.asarray(jnp.argmax(logits, -1)))
print(json.dumps({"logits": out, "tokens": np.stack(toks, 1).tolist()}))
""" % (S_MAX, STEPS)


def test_meshed_moe_with_drops_matches_reference_mesh(world):
    done, meshed, _, _ = world
    prompt = done["drops"][4]
    got = meshed[list(CASES).index("drops")][0]
    over = dict(CASES["drops"][1], **CASES["drops"][2][0])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(over), json.dumps(prompt.tolist()),
                          os.path.join(ROOT, "tests")], env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    np.testing.assert_array_equal(got["tokens"], np.array(want["tokens"]))
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert _rel(w, g) < 1e-5, ("logits", i)
    one = done["drops"][5]                 # one process: capacity from all 32 tokens, other drops
    assert max(_rel(w, g) for w, g in zip(one["logits"], got["logits"])) > 1e-5
