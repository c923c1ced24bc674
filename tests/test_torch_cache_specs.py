"""Port parity: the serving cache placements (``repro_torch.training.sharding``'s
``cache_specs`` / ``cache_shardings``) against ``repro``'s ``cache_specs``.

For each of the ten configs, at ``prefill_32k``, ``decode_32k`` and
``long_500k`` (``batch_sharded`` as the reference's dry run computes it), on
both production meshes (16 x 16, 2 x 16 x 16, the batch over every axis but
``model``): leaf for leaf the reference's spec on
``jax.eval_shape(model.cache_struct(gb, S))`` without its group axis, the
reference's stage / group / cycle slot order flattened into the port's
list of per-layer caches. The meshes are stand-ins (``axis_names`` and the
shape), so no device and no ``XLA_FLAGS`` are needed.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import all_configs as j_all_configs
from repro.models import build_model as j_build_model
from repro.training import sharding as jsh
from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model
from repro_torch.training import sharding

MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SERVING = ("prefill_32k", "decode_32k", "long_500k")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


def _per_layer(ref_specs, ref_shapes):
    """The reference's per-stage specs ([G, ...] leaves) as one nested dict
    per layer, each spec a ``P`` without the group axis."""
    out = []
    for stage, shapes in zip(ref_specs, ref_shapes):
        n_groups = np.shape(jax.tree.leaves(shapes)[0])[0]
        for _ in range(n_groups):
            for j in range(len(stage)):
                out.append(jax.tree.map(lambda s: sharding.P(*tuple(s)[1:]), stage[f"l{j}"],
                                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(j_all_configs()))
def test_cache_specs_match_reference(arch, mesh):
    r = j_all_configs()[arch]
    jm = j_build_model(r)
    shape, axes = MESHES[mesh]
    j_mesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=np.int8))
    t_mesh = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    dp = tuple(a for a in axes if a != "model")
    dp_total = int(np.prod([s for s, a in zip(shape, axes) if a != "model"]))
    model = Model(ArchConfig(**dataclasses.asdict(r)), "meta")
    for name in SERVING:
        gb, S = J_SHAPES[name]["global_batch"], J_SHAPES[name]["seq_len"]
        batch_sharded = J_SHAPES[name]["kind"] == "prefill" or (gb % dp_total == 0 and gb >= dp_total)
        ref_shapes = jax.eval_shape(lambda: jm.cache_struct(gb, S))
        want = _per_layer(jsh.cache_specs(ref_shapes, j_mesh, batch_sharded=batch_sharded, dp_axes=dp),
                          ref_shapes)
        caches = model.cache_struct(gb, S)
        got = sharding.cache_specs(caches, t_mesh, batch_sharded=batch_sharded, dp_axes=dp)
        assert len(got) == len(want), (arch, mesh, name)
        for i, (g, w) in enumerate(zip(got, want)):
            lg, lw = list(_leaves(g)), list(_leaves(w))
            assert [n for n, _ in lg] == [n for n, _ in lw], (arch, mesh, name, i)
            for (n, a), (_, b) in zip(lg, lw):
                assert a == b, (arch, mesh, name, i, n, a, b)
        pls = sharding.cache_shardings(caches[:1], t_mesh, batch_sharded=batch_sharded, dp_axes=dp)
        for (n, spec), (_, pl) in zip(_leaves(got[0]), _leaves(pls[0])):
            assert tuple(pl) == sharding.placements(spec, t_mesh), (arch, name, n)
