"""Rank programs of the meshed LM serving tests (``tests/test_torch_lm_serve.py``).

``repro_torch.launch.mesh.run_world`` starts each rank as its own process
and calls one of these functions there, on the CPU with gloo; this module
imports torch and ``repro_torch`` only. Each returns gathered
numpy arrays.
"""
import dataclasses

import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.serving import make_serve_fns
from repro_torch.training import sharding


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else tree


def _placements(tree):
    if isinstance(tree, dict):
        return {k: _placements(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placements(v) for v in tree]
    return tuple(str(p) for p in tree.placements)


def serve(mesh, cfg, state, prompt, steps: int, s_max: int):
    """``make_serve_fns`` on ``mesh``: the prompt's prefill, then ``steps``
    greedy decode steps; returns the gathered logits of each step, the
    greedy tokens, the caches after prefill and after the last step, their
    placements after decode and the ``all_to_all`` calls a decode step.
    The caches' batch is split over ``data`` where it divides it (the
    reference dry run's ``batch_sharded``)."""
    model = build_model(cfg, "cpu", seed=0)
    model.load_state_dict(state)
    prefill, decode, shardings = make_serve_fns(model, mesh, s_max=s_max,
                                                batch_sharded=prompt.shape[0] % mesh.size("data") == 0)
    logits, caches = prefill(torch.from_numpy(prompt))
    out = {"logits": [logits.full_tensor().numpy()], "prefill_caches": _np_tree(sharding.gather(caches))}
    tok = torch.argmax(torch.from_numpy(out["logits"][0]), -1)
    toks = [tok]
    a2a = []
    for i in range(steps):
        n0 = mesh.all_to_all_calls
        logits, caches = decode(caches, tok, prompt.shape[1] + i)
        a2a.append(mesh.all_to_all_calls - n0)
        out["logits"].append(logits.full_tensor().numpy())
        tok = torch.argmax(torch.from_numpy(out["logits"][-1]), -1)
        toks.append(tok)
    out["tokens"] = torch.stack(toks, 1).numpy()
    out["caches"] = _np_tree(sharding.gather(caches))
    out["placements"] = _placements(caches)
    out["a2a_per_step"] = a2a
    out["dp_spec"] = tuple(shardings["dp_spec"])
    return out


def serve_world(shape, runs, moe=None):
    """For each ``(cfg, state, prompt, steps, s_max, variants)`` of ``runs``:
    ``serve`` once per variant, a dict of config fields (``flash_decode``,
    ``decode_cache_update``, ...) replaced in ``cfg``; then ``moe_shards(*moe)``;
    all in this one world."""
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = [[serve(mesh, dataclasses.replace(cfg, **v), state, prompt, steps, s_max) for v in variants]
           for cfg, state, prompt, steps, s_max, variants in runs]
    return out, (moe_shards(mesh, *moe) if moe else None)


def moe_shards(mesh, cfg, state, x):
    """The shard_map MoE layer (``blocks._moe_shard_map``) of a model's
    first ``moe`` layer on ``x`` [B, S, D] split over ``data``: this rank's
    output rows and aux, and the ``all_to_all`` calls it made."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.blocks import _moe_shard_map

    model = build_model(cfg, "cpu", seed=0)
    model.load_state_dict(state)
    prefill, _, _ = make_serve_fns(model, mesh, s_max=8)           # places the parameters
    i = model.kinds.index("moe")
    p = model.layers[i]["moe"]
    xd = distribute_tensor(torch.from_numpy(x), mesh.device_mesh, [Shard(0), Replicate()])
    n0 = mesh.all_to_all_calls
    with torch.no_grad(), implicit_replication():
        y, aux = _moe_shard_map(p, xd, cfg, mesh)
    return {"y_local": y.to_local().numpy(), "rows": mesh.coords["data"], "aux": float(aux.full_tensor()),
            "a2a": mesh.all_to_all_calls - n0}
