"""The port's per-device counter (``repro_torch.roofline.analysis``) and dry
run (``repro_torch.launch.dryrun``) against closed forms and the reference.

* ``count`` of 9 chained [16, 32] @ [32, 32] products: their FLOPs exactly
  (the reference's ``test_real_compiled_module_flops_match_closed_form``)
  and their operand plus result bytes;
* on a fake 2 x 4 mesh, a DTensor product split on its contraction over
  ``model`` and on its rows over ``data`` counts one device's FLOPs (an
  eighth) and, reduced, one all-reduce of its local output (count, operand
  and result bytes, the ring model's wire bytes); a replicated product
  counts its whole FLOPs on every device;
* a reduced train cell (a tiny smollm-135m: 4 heads over ``model`` 4, and
  6 heads, which ``seq_shard_qkv`` splits on the sequence) on a fake 2 x 4
  mesh counts per-device FLOPs within 5% of the reference's
  ``analyze_compiled`` for the same cell on 8 host devices (run in a
  subprocess that sets its own ``XLA_FLAGS``; today equal, and 1.2% under);
* ``make_production_mesh`` on fake worlds of 256 and 512, and its refusal
  of another size; the fake process group's import (a private module of
  torch) is pinned here, so a move fails loudly.

Each test that opens the fake world tears it down.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.launch.dryrun import analyze_cell, model_flops_global
from repro_torch.launch.mesh import init_fake_world, make_mesh, make_production_mesh
from repro_torch.roofline.analysis import count, roofline_terms, wire_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_world():
    yield init_fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


def test_fake_process_group_import_is_pinned():
    from torch.testing._internal.distributed.fake_pg import FakeStore   # noqa: F401


def test_counter_closed_form_chained_products():
    x, w = torch.zeros(16, 32), torch.zeros(32, 32)

    def f():
        y = x
        for _ in range(9):
            y = y @ w
        return y

    a = count(f)
    assert a["flops"] == 2 * 16 * 32 * 32 * 9
    assert a["bytes_accessed"] == 9 * 4 * (16 * 32 + 32 * 32 + 16 * 32)
    assert a["collectives"] == {} and a["collective_bytes"] == 0


def test_counter_counts_local_shards_and_collectives(fake_world):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    fake_world(8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    dm = mesh.device_mesh
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(32, 64), dm, [Shard(0), Shard(1)])
        w = distribute_tensor(torch.empty(64, 128), dm, [Replicate(), Shard(0)])
        a = count(lambda: (x @ w).redistribute(dm, [Shard(0), Replicate()]))
        assert a["flops"] == 2 * 16 * 16 * 128                # [16, 16] @ [16, 128]: one device's eighth
        assert a["collectives"] == {"all-reduce": {"count": 1, "operand_bytes": 16 * 128 * 4,
                                                   "result_bytes": 16 * 128 * 4}}
        assert a["collective_bytes"] == wire_bytes(a["collectives"]) == 2 * 16 * 128 * 4
        xr = distribute_tensor(torch.empty(32, 64), dm, [Replicate(), Replicate()])
        wr = distribute_tensor(torch.empty(64, 128), dm, [Replicate(), Replicate()])
        r = count(lambda: xr @ wr)
        assert r["flops"] == 2 * 32 * 64 * 128                 # replicated: the whole product, every device
        assert r["collectives"] == {}
    t = roofline_terms(a, model_flops_per_device=a["flops"] / 2)
    assert t["useful_flops_ratio"] == pytest.approx(0.5)


def test_production_meshes(fake_world):
    for multi, shape in ((False, {"data": 16, "model": 16}), (True, {"pod": 2, "data": 16, "model": 16})):
        fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        assert mesh.shape == shape
        assert mesh.coords == {a: 0 for a in shape}
    with pytest.raises(ValueError):
        make_production_mesh(device="cpu")                    # a world of 512 is not 16 x 16


REDUCED = {   # heads that divide model 4 (sharded on heads); 6 heads that do not (sequence-sharded)
    "heads_shard": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512),
    "seq_shard": dict(n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512),
}
SHAPE = {"kind": "train", "seq_len": 64, "global_batch": 4}

REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch import dryrun
from repro.roofline.analysis import analyze_compiled
cfg = dataclasses.replace(get_config("smollm-135m"), **json.loads(sys.argv[1]))
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
fn, args = dryrun.build_train_cell(cfg, json.loads(sys.argv[2]), mesh)
a = analyze_compiled(fn.lower(*args).compile())
print(json.dumps({"flops": a["flops"]}))
"""


@pytest.mark.parametrize("layout", list(REDUCED))
def test_reduced_train_cell_flops_match_reference(fake_world, layout):
    """Per-device FLOPs of one reduced cell: the port's count vs the reference's HLO count."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(REDUCED[layout]), json.dumps(SHAPE)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])["flops"]

    fake_world(8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    cfg = dataclasses.replace(get_config("smollm-135m"), **REDUCED[layout])
    a = analyze_cell(cfg, SHAPE, mesh)
    assert a["micro"] == 2 and a["n_micro"] == 2
    assert a["flops"] == pytest.approx(want, rel=0.05), (a["flops"], want)
    assert a["flops"] >= model_flops_global(cfg, SHAPE) / 8      # 6 N D / devices: attention adds to it
    assert a["memory"]["peak_bytes"] > 0 and a["collective_bytes"] > 0
