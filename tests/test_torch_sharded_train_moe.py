"""Port parity: ``make_sharded_train_step`` on a MoE config with
``ep_mode="shard_map"`` (the expert-parallel MoE over ``Mesh.all_to_all``,
each expert slab's gradient one copy's of the P copies its ``model`` ranks
send) on a gloo world of 4 CPU ranks, a (data 2, model 2) mesh, against
the reference's own meshed train step on 4 host devices.

A reduced deepseek-moe-16b (f32; 1 dense + 3 MoE layers, 8 experts, top-2,
2 shared experts) with ``capacity_factor`` 1: each data shard's 64 tokens
of a microbatch fill buckets of 16, so tokens are dropped, and the
capacity comes from the local tokens on both sides. The load-balance loss
is averaged over the data shards. One step of 2 microbatches of 8 from the
reference's initial state: the loss and the gradients' global norm within
1e-5; every gathered moment (m and v, which after one step are the clipped
gradient and its square) within 1e-5 of its scale; the expert weights
within 1e-4. The other weights are held by their moments: AdamW's first
update is about lr x sign(g), and a gradient of ~1e-10 (5e-7 of its
leaf's largest) takes either sign on the two sides (the dense MLP's
``w2`` then lands 5e-4 of its scale apart). The port in one process is not
the reference here: its capacity and its load-balance loss come from the
whole microbatch.

The reference runs in a subprocess that sets its own ``XLA_FLAGS``
(``repro.training.make_sharded_train_step``, jitted, on a (2, 2) mesh of
host devices); the ranks run ``tests/torch_lm_mesh_ranks.py`` (no jax).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_train_state_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import run_world

from conftest import reduce_cfg
from test_torch_sharded_train import OPT, _np_state, _rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVER = dict(vocab_size=256, ep_mode="shard_map", capacity_factor=1.0)
STEPS = 1

REF_SCRIPT = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
sys.path.insert(0, sys.argv[3])
from conftest import reduce_cfg
from repro.configs import get_config
from repro.models import build_model
from repro.training import optimizer as jopt
from repro.training.train_step import init_state, make_sharded_train_step
with open(sys.argv[1], "rb") as f:
    over, opt_kw, batches = pickle.load(f)
r = reduce_cfg(get_config("deepseek-moe-16b"), **over)
opt = jopt.AdamWConfig(**opt_kw)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
m = build_model(r, mesh)
state = init_state(build_model(r), jax.random.PRNGKey(0), opt)
np_tree = lambda t: jax.tree.map(np.asarray, t)
start = (np_tree(state.params), np_tree(state.opt), int(state.step))
step, state_sh, batch_sh = make_sharded_train_step(m, opt, mesh)
state = jax.device_put(state, state_sh)
step = jax.jit(step)
losses, norms = [], []
for b in batches:
    b = {k: jax.device_put(jnp.asarray(v), batch_sh(v)) for k, v in b.items()}
    state, metrics = step(state, b)
    losses.append(float(metrics["loss"]))
    norms.append(float(metrics["grad_norm"]))
with open(sys.argv[2], "wb") as f:
    pickle.dump({"start": start, "end": (np_tree(state.params), np_tree(state.opt), int(state.step)),
                 "loss": losses, "grad_norm": norms}, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's meshed steps (subprocess), then the port's in a world of 4."""
    tmp = tmp_path_factory.mktemp("moe_train")
    batches = list(TokenPipeline(vocab_size=256, seq_len=16, n_docs=64, seed=2).batches(16, 2, n_micro=2))[:STEPS]
    with open(tmp / "args.pkl", "wb") as f:
        pickle.dump((OVER, OPT, batches), f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(tmp / "args.pkl"), str(tmp / "ref.pkl"),
                          os.path.join(ROOT, "tests")], env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    cfg = ArchConfig(**dataclasses.asdict(reduce_cfg(j_get_config("deepseek-moe-16b"), **OVER)))
    start = lm_train_state_from_numpy(*ref["start"], cfg)
    want = _np_state(lm_train_state_from_numpy(*ref["end"], cfg))
    world = run_world("torch_lm_mesh_ranks:sharded_runs", 4, args=((2, 2), [(cfg, OPT, batches, start)]),
                      timeout_s=300)
    return ref, want, [w[0] for w in world]


def test_shard_map_moe_training_matches_reference_mesh(runs):
    ref, want, world = runs
    got = world[0]
    for other in world[1:]:                       # every rank gathers the same state
        np.testing.assert_array_equal(other["loss"], got["loss"])
    assert got["step"] == STEPS
    for i in range(STEPS):
        assert got["loss"][i] == pytest.approx(ref["loss"][i], rel=1e-5), ("loss", i)
        assert got["grad_norm"][i] == pytest.approx(ref["grad_norm"][i], rel=1e-5), ("grad_norm", i)
    state = {"params": got["params"], "m": got["opt"]["m"], "v": got["opt"]["v"]}
    experts = [n for n in want["params"] if ".experts." in n]
    assert len(experts) == 9, experts               # w1, w2, w3 of 3 MoE layers
    for tree in ("m", "v"):
        for n in want[tree]:
            assert _rel(want[tree][n], state[tree][n]) < 1e-5, (tree, n)
    for n in experts:
        assert _rel(want["params"][n], state["params"][n]) < 1e-4, ("params", n)
