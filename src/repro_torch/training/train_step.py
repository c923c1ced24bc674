"""Train step: microbatch gradient accumulation + AdamW.

Counterpart of ``repro/training/train_step.py``'s ``TrainState``,
``init_state`` and ``make_train_step``. The reference scans over the
microbatch axis with f32 gradient accumulators; here that is a Python
loop over ``loss_fn`` and ``torch.autograd.grad``, one microbatch's
activations alive at a time. Gradients are averaged over microbatches and
the optimizer steps once per global batch.

A step is a function of the state as the reference's is: ``state.params``
is a dict of tensors apart from the model (named as its state dict); a
step copies them into the model's parameters, takes the gradients there,
and returns a new ``TrainState`` of new tensors, leaving the old one as
it was. So a state restored from a checkpoint (``checkpoint`` flattens a
``TrainState`` by its ``FIELDS``) steps on like the one it was saved from.

``make_sharded_train_step`` runs the same step on a mesh: the model's
parameters and the state's leaves become DTensors placed by
``sharding.param_shardings`` / ``opt_state_specs``, the batch's microbatch
dim is sharded over the data axes, and gradients, the global-norm clip and
AdamW run on DTensors under DTensor's own rules (with ``implicit_replication``
for the step's plain constants). The attention and the SSD scan run on local
shards under ``local_map`` (``models/layers.py``, ``models/mamba.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.model import Model
from .optimizer import AdamWConfig, _is_factorable, adamw_init, adamw_update
from .sharding import P, distribute, opt_state_specs, param_specs, placements


@dataclasses.dataclass
class TrainState:
    FIELDS = ("params", "opt", "step")   # the reference's leaf order (checkpoint keys 0, 1, 2)

    params: Dict[str, torch.Tensor]
    opt: Dict[str, Any]
    step: int


def is_stacked(name: str) -> bool:
    """A per-layer leaf: the reference holds it with a leading group axis."""
    return name.startswith(("layers.", "enc_layers."))


def init_state(model: Model, opt_cfg: AdamWConfig) -> TrainState:
    """Makes the model's parameters trainable (``requires_grad``) and returns
    a state holding a copy of them, fresh moments and step 0. The model's
    own initialisation (its ``seed``) stands in for the reference's key."""
    model.requires_grad_(True)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(params=params, opt=adamw_init(params, opt_cfg), step=0)


def _microbatch(batch: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: v[i] for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``. ``batch``
    leaves (tensors or numpy arrays) are [n_micro, micro_batch, ...]: the
    leading axis is the accumulation loop. Metrics: ``loss`` (the mean of the
    microbatches' losses), ``grad_norm`` and ``lr``, 0-d f32 tensors."""
    live = dict(model.named_parameters())

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with torch.no_grad():
            for n, p in live.items():
                p.copy_(state.params[n])
        if not all(p.requires_grad for p in live.values()):
            raise ValueError("the model's parameters need requires_grad: build the state with init_state")
        n_micro = next(iter(batch.values())).shape[0]
        acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in live.items()}
        loss_sum = None
        for i in range(n_micro):
            loss, _ = model.loss_fn(_microbatch(batch, i))
            grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
            for n, g in zip(live, grads):
                if g is not None:                    # unused: a zero gradient, as jax.grad gives
                    acc[n] += g.float()
            del grads, g                             # held in acc: freed before the next forward
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        for g in acc.values():                       # in place: one f32 copy of the gradients
            g.div_(n_micro)
        new_params, new_opt, om = adamw_update(state.params, acc, state.opt, opt_cfg, stacked=is_stacked)
        return TrainState(new_params, new_opt, state.step + 1), {"loss": loss_sum / n_micro, **om}

    return train_step


def _shard_params(model: Model, shardings: Dict[str, tuple], mesh) -> None:
    """Replace each parameter of ``model`` by a DTensor of it placed by
    ``shardings[name]`` (a parameter that already is one is redistributed)."""
    for mod_name, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            t = distribute(p.detach(), shardings[f"{mod_name}.{name}" if mod_name else name], mesh)
            mod._parameters[name] = torch.nn.Parameter(t, requires_grad=p.requires_grad)


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig, mesh, *, dp_axes=("data",),
                            donate: bool = True, **spec_kw):
    """``make_train_step`` on ``mesh`` (a ``launch.mesh.Mesh``); returns
    ``(train_step, state_shardings, batch_sharding)`` as the reference does.

    ``model``'s parameters become DTensors placed by ``param_specs``
    (``spec_kw``: ``fsdp``, ``uneven_heads``, ...) and the model takes the
    mesh. ``state_shardings`` is a ``TrainState`` of DTensor placements
    (the moments by ``opt_state_specs``, for ``opt_cfg``'s factoring);
    ``batch_sharding(leaf)`` the placements of a [n_micro, micro, ...] leaf,
    its microbatch dim over ``dp_axes``. ``train_step(state, batch)`` places
    a state or batch leaf that is a plain tensor (the whole tensor, the same
    on every rank) or a DTensor placed otherwise, steps, and returns the new
    state with every leaf at its placements (the reference's
    ``out_shardings``). ``donate``: the input state's dicts are emptied after
    the step, so their tensors can be freed (the reference donates them)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    params = dict(model.named_parameters())
    pspecs = param_specs(params, mesh, **spec_kw)
    factored = {"v": {n: ({} if opt_cfg.factored and _is_factorable(p) else None) for n, p in params.items()}}
    to_pl = lambda tree: ({k: to_pl(v) for k, v in tree.items()} if isinstance(tree, dict)  # noqa: E731
                          else placements(tree, mesh))
    state_shardings = TrainState(params=to_pl(pspecs), opt=to_pl(opt_state_specs(factored, pspecs)),
                                 step=placements(P(), mesh))
    model.mesh = mesh
    _shard_params(model, state_shardings.params, mesh)
    step = make_train_step(model, opt_cfg)
    dp = tuple(dp_axes)

    def batch_sharding(leaf) -> tuple:
        return tuple(Shard(1) if a in dp else Replicate() for a in mesh.axis_names)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        placed = TrainState(params=distribute(state.params, state_shardings.params, mesh),
                            opt=distribute(state.opt, state_shardings.opt, mesh), step=state.step)
        batch = {k: distribute(torch.as_tensor(v), batch_sharding(v), mesh) for k, v in batch.items()}
        with implicit_replication():
            new, metrics = step(placed, batch)
        new = TrainState(params=distribute(new.params, state_shardings.params, mesh),
                         opt=distribute(new.opt, state_shardings.opt, mesh), step=new.step)
        if donate:
            for tree in (state.params, state.opt["m"], state.opt["v"]):
                tree.clear()
        return new, metrics

    return train_step, state_shardings, batch_sharding
