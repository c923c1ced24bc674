"""Rank programs of the sharded LM training tests (``tests/test_torch_sharded_train.py``).

``repro_torch.launch.mesh.run_world`` starts each rank as its own process
and calls one of these functions there, on the CPU with gloo; this module
imports numpy, torch and ``repro_torch`` only. Each returns the gathered
state and the losses as numpy arrays.
"""
import numpy as np
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.training import sharding
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_state, make_sharded_train_step


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else tree


def sharded_steps(shape, cfg, opt_kw, batches, state=None):
    """``make_sharded_train_step`` on a (data, model) mesh of ``shape``: the
    model from seed 0 (or ``state``: a single-device ``TrainState``), one
    step per batch; returns the losses, the gradients' global norms and the
    gathered state (numpy)."""
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    model = build_model(cfg, "cpu", mesh=mesh, seed=0)
    opt = AdamWConfig(**opt_kw)
    if state is None:
        state = init_state(model, opt)
    else:
        model.requires_grad_(True)
    step, _, _ = make_sharded_train_step(model, opt, mesh)
    whole = lambda t: float(t.full_tensor() if hasattr(t, "full_tensor") else t)  # noqa: E731
    losses, norms = [], []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(whole(metrics["loss"]))
        norms.append(whole(metrics["grad_norm"]))
    return {"loss": np.array(losses), "grad_norm": np.array(norms),
            "params": _np_tree(sharding.gather(state.params)),
            "opt": _np_tree(sharding.gather({"m": state.opt["m"], "v": state.opt["v"]})),
            "step": state.step}


def sharded_runs(shape, runs):
    """``sharded_steps`` for each (cfg, opt_kw, batches, state) of ``runs`` in
    this one world, in order."""
    return [sharded_steps(shape, *r) for r in runs]
