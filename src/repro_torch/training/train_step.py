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

The reference's ``make_sharded_train_step`` and ``training/sharding.py``
(parameter and cache shardings over a mesh) wait for the LM mesh glue,
ROADMAP.md Queue 1 item 13.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.model import Model
from .optimizer import AdamWConfig, adamw_init, adamw_update


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
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in live.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(n_micro):
            loss, _ = model.loss_fn(_microbatch(batch, i))
            grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
            for n, g in zip(live, grads):
                if g is not None:                    # unused: a zero gradient, as jax.grad gives
                    acc[n] += g.float()
            loss_sum += loss.detach().float()
        grads = {n: g / n_micro for n, g in acc.items()}
        new_params, new_opt, om = adamw_update(state.params, grads, state.opt, opt_cfg, stacked=is_stacked)
        return TrainState(new_params, new_opt, state.step + 1), {"loss": loss_sum / n_micro, **om}

    return train_step
