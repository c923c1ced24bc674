"""Serving step factories: batched prefill + decode, with cache placements on
a mesh (counterpart of ``repro/serving/serve_step.py``).

``make_serve_fns`` returns the prefill and decode functions of a model: on
one device plain calls of ``Model.prefill`` and ``Model.decode_step``; on a
mesh the same calls on DTensors (parameters by ``training.param_shardings``,
tokens split over the data axes, caches by ``training.cache_specs``: the
batch over the data axes and the length over ``model`` where they divide;
at batch 1 the length over every axis, the paper's vertical partitioning
applied to the KV positions). Decode's softmax over a split length runs per
shard with an LSE combine under ``cfg.flash_decode`` (``models/layers.py``).
``greedy_generate`` is the reference's greedy loop on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.model import Model


def make_serve_fns(model: Model, mesh=None, *, s_max: int, batch_sharded: bool = True,
                   dp_axes=("data",), **spec_kw):
    """Returns ``(prefill_fn, decode_fn, shardings)`` (the reference's
    signature): ``prefill_fn(tokens, extras=None) -> (logits [B, V],
    caches)`` and ``decode_fn(caches, token [B], pos) -> (logits, caches)``.

    Without a mesh, plain calls of ``model.prefill(s_max=s_max)`` and
    ``model.decode_step``; ``shardings`` is None. On ``mesh`` (a
    ``launch.mesh.Mesh``) the model takes the mesh and its parameters become
    DTensors placed by ``param_shardings`` (``spec_kw``: ``fsdp``,
    ``fsdp_tables_only``, ...); tokens (plain tensors, the same
    on every rank, or DTensors) are split over ``dp_axes`` where the batch
    divides them, else replicated; prefill's caches leave placed by
    ``cache_specs(batch_sharded=...)`` (the reference's prefill
    ``out_shardings``), and decode writes and returns them so. Logits are
    DTensors split on the vocab (``full_tensor()`` gathers them). Both run
    under ``implicit_replication`` and ``no_grad``. ``shardings``:
    ``{"dp_spec": P(dp_axes), "params": {name: placements}, "cache": fn}``,
    ``cache(caches)`` the placements ``cache_specs`` gives such caches."""
    if mesh is None:
        return (lambda tokens, extras=None: model.prefill(tokens, extras, s_max=s_max),
                model.decode_step, None)

    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from ..training.sharding import P, cache_shardings, distribute, param_shardings
    from ..training.train_step import _shard_params

    dp = tuple(dp_axes)
    params = param_shardings(dict(model.named_parameters()), mesh, **spec_kw)
    model.mesh = mesh
    _shard_params(model, params, mesh)

    def cache_pl(caches):
        return cache_shardings(caches, mesh, batch_sharded=batch_sharded, dp_axes=dp)

    def place_tokens(t):
        if isinstance(t, DTensor):
            return t
        t = torch.as_tensor(t).to(mesh.device)
        split = t.shape[0] % mesh.size(dp) == 0
        pl = [Shard(0) if a in dp and split else Replicate() for a in mesh.axis_names]
        return distribute_tensor(t, mesh.device_mesh, pl)

    def place_extras(extras):
        if not extras:
            return extras
        return {k: (v if v is None else place_tokens(v)) for k, v in extras.items()}

    @torch.no_grad()
    def prefill_fn(tokens, extras: Optional[dict] = None):
        with implicit_replication():
            logits, caches = model.prefill(place_tokens(tokens), place_extras(extras), s_max=s_max)
            return logits, distribute(caches, cache_pl(caches), mesh)

    @torch.no_grad()
    def decode_fn(caches, token, pos: int):
        with implicit_replication():
            logits, caches = model.decode_step(caches, place_tokens(token), pos)
            return logits, distribute(caches, cache_pl(caches), mesh)

    return prefill_fn, decode_fn, {"dp_spec": P(dp), "params": params, "cache": cache_pl}


@torch.no_grad()
def greedy_generate(model: Model, tokens, extras=None, *, steps: int, s_max: int) -> torch.Tensor:
    """Prefill the prompts [B, S] (``extras``: ``Model.prefill``'s vision
    embeddings or frames), then decode greedily; returns [B, steps] int32."""
    logits, cache = model.prefill(tokens, extras, s_max=s_max)
    out = [torch.argmax(logits, -1)]
    pos = tokens.shape[1]
    for i in range(steps - 1):
        logits, cache = model.decode_step(cache, out[-1], pos + i)
        out.append(torch.argmax(logits, -1))
    return torch.stack(out, dim=1).to(torch.int32)
