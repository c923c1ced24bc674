"""Port parity: the LM sharding rules (``repro_torch.training.sharding``) and
``launch.dryrun.model_flops_global`` against ``repro``'s.

* ``param_specs`` of every one of the ten configs on both production meshes
  (16 x 16, 2 x 16 x 16), by default, with ``fsdp=()``, with
  ``uneven_heads`` and with ``fsdp_tables_only``: leaf for leaf the
  reference's ``param_spec`` (shapes from ``jax.eval_shape(model.init)``)
  without its stacked layer axis, the port's leaves named as its state dict
  (``convert._flat_lm`` maps the names);
* ``opt_state_specs`` for plain and factored AdamW: ``m`` as the params,
  ``v`` as the params or ``{"vr": P(), "vc": P()}`` where both factor a
  leaf; where only the reference factors (a stacked per-layer vector, which
  the port keeps whole), the port's ``v`` is placed as its parameter;
* ``placements`` and ``param_shardings``: a spec as DTensor placements in mesh order;
* ``model_flops_global`` for every config and shape.

The meshes are stand-ins (``axis_names`` and the shape), so no device and
no ``XLA_FLAGS`` are needed.
"""
import importlib
import os
import types

import jax
import numpy as np
import pytest

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import all_configs as j_all_configs
from repro.models import build_model as j_build_model
from repro.training import optimizer as jopt
from repro.training import sharding as jsh
from repro_torch.configs.base import ArchConfig, SHAPES, get_config
from repro_torch.convert import _flat_lm
from repro_torch.launch.dryrun import model_flops_global
from repro_torch.models.model import Model
from repro_torch.training import sharding
from repro_torch.training.optimizer import AdamWConfig, adamw_init

MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
OPTIONS = {"default": {}, "no-fsdp": {"fsdp": ()}, "uneven-heads": {"uneven_heads": True},
           "fsdp-tables-only": {"fsdp_tables_only": True}}


def _j_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=np.int8))


def _t_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _ref_shapes(name):
    r = j_all_configs()[name]
    return r, jax.eval_shape(j_build_model(r).init, jax.random.PRNGKey(0))


def _port_specs_of_ref(ref_specs, ref_shapes):
    """{port name: the reference's spec, stacked axis dropped}."""
    tree = {}
    for top, t in ref_specs.items():
        if top in ("stages", "enc_stages"):
            stages = []
            for si, stage in enumerate(t):
                def per_group(s, h):
                    if isinstance(s, dict):
                        return {k: per_group(s[k], h[k]) for k in s}
                    arr = np.empty(h.shape[0], dtype=object)
                    for g in range(h.shape[0]):
                        arr[g] = tuple(s)[1:]
                    return arr
                stages.append(per_group(stage, ref_shapes[top][si]))
            tree[top] = stages
        else:
            tree[top] = jax.tree_util.tree_map(lambda s: tuple(s), t,
                                               is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    flat, _ = _flat_lm(tree)
    return {n: tuple(v) for n, v in flat.items()}


@pytest.fixture(scope="module")
def shapes():
    return {name: _ref_shapes(name) for name in j_all_configs()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(j_all_configs()))
def test_param_specs_match_reference(shapes, arch, mesh):
    import dataclasses

    r, ref_shape = shapes[arch]
    cfg = ArchConfig(**dataclasses.asdict(r))
    params = Model(cfg, "meta").state_dict()
    for opt, kw in OPTIONS.items():
        want = _port_specs_of_ref(jsh.param_specs(ref_shape, _j_mesh(mesh), **kw), ref_shape)
        got = sharding.param_specs(params, _t_mesh(mesh), **kw)
        assert set(got) == set(want), (arch, mesh, opt)
        for n in got:
            assert tuple(got[n]) == want[n], (arch, mesh, opt, n)


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b", "deepseek-v3-671b"])
def test_opt_state_specs_match_reference(shapes, arch, factored):
    import dataclasses

    r, ref_shape = shapes[arch]
    cfg = ArchConfig(**dataclasses.asdict(r))
    jcfg = jopt.AdamWConfig(factored=factored)
    jm = _j_mesh("16x16")
    ref_p = jsh.param_specs(ref_shape, jm)
    ref_opt = jsh.opt_state_specs(jax.eval_shape(lambda p: jopt.adamw_init(p, jcfg), ref_shape), ref_p)
    params = Model(cfg, "meta").state_dict()
    pspecs = sharding.param_specs(params, _t_mesh("16x16"))
    got = sharding.opt_state_specs(adamw_init(params, AdamWConfig(factored=factored)), pspecs)
    assert got["step"] == sharding.P() and tuple(ref_opt["step"]) == ()
    want_m = _port_specs_of_ref(ref_opt["m"], ref_shape)
    assert {n: tuple(s) for n, s in got["m"].items()} == want_m
    # v: a factored leaf is {"vr", "vc"} on the reference's side too
    mark = jax.sharding.PartitionSpec("F", "F")        # a factored leaf (stacked: ("F",))
    vr_ref = _port_specs_of_ref(jax.tree_util.tree_map(
        lambda s: mark if isinstance(s, dict) else s, ref_opt["v"],
        is_leaf=lambda x: isinstance(x, dict) and set(x) == {"vr", "vc"}), ref_shape)
    n_fact = 0
    for n, s in got["v"].items():
        if isinstance(s, dict):
            n_fact += 1
            assert s == {"vr": sharding.P(), "vc": sharding.P()}
            assert "F" in vr_ref[n], n
        elif "F" in vr_ref[n]:               # a stacked vector: the port keeps its v whole,
            assert s == pspecs[n] and params[n].dim() == 1, n    # placed as its parameter
        else:
            assert tuple(s) == vr_ref[n], n
    assert (n_fact > 0) == factored


def test_placements_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _t_mesh("2x16x16")
    P = sharding.P
    assert sharding.placements(P(("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert sharding.placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert sharding.placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.placements(P("data", "data"), mesh)
    # smollm's wq: FSDP over (pod, data) on D; 9 heads do not divide model 16
    assert sharding.param_shardings({"layers.0.attn.wq": (576, 9, 64), "embed.table": (49152, 576)}, mesh) == {
        "layers.0.attn.wq": (Shard(0), Shard(0), Replicate()), "embed.table": (Shard(1), Shard(1), Shard(0))}


def _ref_model_flops():
    """The reference's ``model_flops_global``; its module sets ``XLA_FLAGS``
    on import, which is put back so this process's jax is untouched."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun").model_flops_global
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def test_model_flops_global_matches_reference():
    ref = _ref_model_flops()
    assert set(SHAPES) == set(J_SHAPES)
    for name, r in j_all_configs().items():
        for shape in SHAPES:
            assert model_flops_global(get_config(name), SHAPES[shape]) == ref(r, J_SHAPES[shape]), (name, shape)
