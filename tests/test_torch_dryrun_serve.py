"""The port's dry run (``repro_torch.launch.dryrun``) beyond the dense train
cells: serving cells, the expert-parallel MoE's train cell, the PRF cell
and the skipped cells, on a fake 2 x 4 world.

* a reduced prefill cell and a reduced decode cell (a tiny smollm-135m: 4
  heads over ``model`` 4; batch 4 over ``data`` 2, 64 positions) count
  per-device FLOPs within 5% of the reference's ``analyze_compiled`` for
  the same cells on 8 host devices (a subprocess that sets its own
  ``XLA_FLAGS``); ``flash-decode`` keeps the FLOPs and adds the LSE
  combine's two all-reduces a layer;
* a reduced deepseek-moe-16b train cell (``ep_mode="shard_map"``, 2 MoE
  layers, 2 microbatches) counts its all-to-alls: a layer's two exchanges
  in the forward, again in the recomputation (``remat``) and in the
  backward, 6 a layer a microbatch;
* a reduced PRF cell (``ReplicaMesh`` on the CPU) grows ``max_depth``
  levels, and each level's collectives are the closed form of
  ``make_prf_train_fn``'s plane: the histogram combine (an all-reduce over
  ``data``, or with ``prf-rs`` a reduce-scatter), the winners' two
  all-gathers and five masked sums, and the route's sum over ``model``;
  before them the dimension reduction's combine and gather and the root
  counts' sum, after them the OOB walk's ``max_depth`` route sums and its
  two counts;
* ``long_500k`` of a config that is not ``sub_quadratic`` is
  ``SKIP(full-attn)``, as in the reference.

Each test that opens the fake world tears it down.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.core.types import ForestConfig
from repro_torch.launch.dryrun import analyze_cell, analyze_prf_cell, run_cell
from repro_torch.launch.mesh import init_fake_world, make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOLLM = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512)
SHAPES = {"prefill": {"kind": "prefill", "seq_len": 64, "global_batch": 4},
          "decode": {"kind": "decode", "seq_len": 64, "global_batch": 4}}

REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch import dryrun
from repro.roofline.analysis import analyze_compiled
cfg = dataclasses.replace(get_config("smollm-135m"), **json.loads(sys.argv[1]))
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {}
for name, shape in json.loads(sys.argv[2]).items():
    build = {"prefill": dryrun.build_prefill_cell, "decode": dryrun.build_decode_cell}[shape["kind"]]
    fn, args = build(cfg, shape, mesh)
    out[name] = analyze_compiled(fn.lower(*args).compile())["flops"]
print(json.dumps(out))
"""


@pytest.fixture
def mesh_2x4():
    init_fake_world(8)
    yield make_mesh((2, 4), ("data", "model"), device="cpu")
    dist.destroy_process_group()


def test_serving_cells_flops_match_reference(mesh_2x4):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(SMOLLM), json.dumps(SHAPES)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(get_config("smollm-135m"), **SMOLLM)
    got = {name: analyze_cell(cfg, shape, mesh_2x4) for name, shape in SHAPES.items()}
    for name in SHAPES:
        assert got[name]["flops"] == pytest.approx(want[name], rel=0.05), (name, got[name]["flops"], want[name])
        assert got[name]["memory"]["peak_bytes"] > 0 and got[name]["collective_bytes"] > 0
    flash = analyze_cell(cfg, SHAPES["decode"], mesh_2x4, ("flash-decode",))
    assert flash["flops"] == got["decode"]["flops"]
    plain_ar = got["decode"]["collectives"]["all-reduce"]["count"]
    assert flash["collectives"]["all-reduce"]["count"] == plain_ar + 2 * SMOLLM["n_layers"]


def test_moe_train_cell_counts_all_to_all(mesh_2x4):
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
                              head_dim=32, vocab_size=512, n_experts=8, experts_per_token=2, moe_d_ff=64,
                              n_dense_layers=1, dense_d_ff=256)
    assert cfg.ep_mode == "shard_map" and cfg.remat != "none"
    a = analyze_cell(cfg, {"kind": "train", "seq_len": 64, "global_batch": 4}, mesh_2x4)
    n_moe = cfg.n_layers - cfg.n_dense_layers
    assert a["n_micro"] == 2
    assert a["collectives"]["all-to-all"]["count"] == 6 * n_moe * a["n_micro"]


@pytest.mark.parametrize("hist_reduce", ["psum", "psum_scatter"])
def test_prf_cell_levels_and_collectives(mesh_2x4, hist_reduce):
    cfg = ForestConfig(n_trees=8, max_depth=4, n_bins=16, n_classes=4, max_frontier=8, tree_chunk=4,
                       feature_mode="importance", hist_reduce=hist_reduce)
    a = analyze_prf_cell(mesh_2x4, device="cpu", n_samples=4096, n_features=64, config=cfg)
    assert a["levels"] == cfg.max_depth
    calls = [(kind, axes) for kind, axes, _ in a["calls"]]
    rs = hist_reduce == "psum_scatter"
    winners = ("data", "model") if rs else ("model",)
    level = ([("reduce-scatter", ("data",))] if rs else [("all-reduce", ("data",))]) \
        + [("all-gather", winners)] * 2 + [("all-reduce", winners)] * 5 + [("all-reduce", ("model",))]
    setup = [("all-reduce", ("data",)), ("all-gather", ("model",)), ("all-reduce", ("data",))]
    oob = [("all-reduce", ("model",))] * cfg.max_depth + [("all-reduce", ("data",))] * 2
    assert calls == setup + level * cfg.max_depth + oob
    k, Fl, B, C = cfg.n_trees, 64 // 4, cfg.n_bins, cfg.n_classes
    for _, _, shape in a["calls"][len(setup)::len(level)][:cfg.max_depth]:   # each level's combine
        fl_k = (shape[0], shape[1]) if rs else (shape[2], shape[0])   # [k, slots, Fl, B, C]; scatter: Fl first
        assert (*fl_k, *shape[3:]) == (Fl, k, B, C), shape


def test_long_context_of_full_attention_is_skipped():
    for arch in ("smollm-135m", "deepseek-moe-16b"):
        assert not get_config(arch).sub_quadratic
        r = run_cell(arch, "long_500k", False)
        assert r["status"] == "SKIP(full-attn)", r
