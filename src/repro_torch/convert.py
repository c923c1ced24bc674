"""Carry a trained forest, or LM parameters, across frameworks as numpy arrays.

A forest is six arrays (``Forest.FIELDS``) plus its config, and a model
adds the ``[F, B-1]`` bin edges; both packages use the same layout, so a
model trained by the JAX reference loads here unchanged:
``model_from_numpy({n: np.asarray(getattr(jax_model.forest, n)) ...},
jax_model.bin_edges, ForestConfig(**dataclasses.asdict(jax_cfg)), "cuda")``.

LM parameters: ``lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg)``
gives a state dict for ``repro_torch.models.Model(cfg)`` (gradients carry
the same way); ``lm_train_state_from_numpy`` carries a whole training
state (params, AdamW moments, step).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.api import PRFModel
from .configs.base import ArchConfig
from .core.types import Forest, ForestConfig
from .device import resolve_device

_DTYPES = {
    "feature": torch.int32, "threshold": torch.int32, "left_child": torch.int32,
    "class_counts": torch.float32, "value": torch.float32, "tree_weight": torch.float32,
}


def forest_from_numpy(arrays: dict, config: ForestConfig, device=None) -> Forest:
    """The six ``Forest`` fields as numpy arrays -> the port's ``Forest``."""
    dev = resolve_device(device)
    k, P = config.n_trees, config.max_nodes + 1
    fields = {}
    for name, dtype in _DTYPES.items():
        a = np.asarray(arrays[name])
        if a.shape[:1] != (k,) or (name != "tree_weight" and a.shape[1] != P):
            raise ValueError(f"{name} has shape {a.shape}, config wants k={k}, P={P}")
        fields[name] = torch.from_numpy(np.array(a, copy=True)).to(device=dev, dtype=dtype)
    return Forest(config=config, **fields)


def forest_to_numpy(forest: Forest) -> dict:
    """The six ``Forest`` fields as numpy arrays."""
    return {name: getattr(forest, name).cpu().numpy() for name in Forest.FIELDS}


def model_from_numpy(forest_arrays: dict, bin_edges, config: ForestConfig, device=None) -> PRFModel:
    """A ``PRFModel`` from numpy forest arrays and ``[F, B-1]`` bin edges."""
    return PRFModel(
        forest=forest_from_numpy(forest_arrays, config, device),
        bin_edges=np.asarray(bin_edges, np.float64),
    )


def _leaves(tree, path=""):
    """(dotted path, leaf) of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, f"{path}.{key}" if path else key)
    else:
        yield path, tree


def _stage_leaves(stages, key: str, prefix: str, flat: dict, source: dict) -> None:
    """The reference's ``stages`` (or ``enc_stages``): stage s, group g, cycle
    slot j -> ``{prefix}.{i}``, i counting in that order."""
    i = 0
    for si, stage in enumerate(stages):
        slots = [stage[f"l{j}"] for j in range(len(stage))]
        n_groups = np.shape(next(_leaves(stage))[1])[0]
        for g in range(n_groups):
            for j, tree in enumerate(slots):
                for path, leaf in _leaves(tree):
                    where = f"{key}[{si}].l{j}.{path}"
                    if np.shape(leaf)[:1] != (n_groups,):
                        raise ValueError(f"{where}: shape {np.shape(leaf)} lacks the group axis {n_groups}")
                    name = f"{prefix}.{i}.{path}"
                    flat[name], source[name] = np.asarray(leaf)[g], f"{where}[{g}]"
                i += 1


_STAGES = {"stages": "layers", "enc_stages": "enc_layers"}


def _flat_lm(params: dict):
    """(flat {port name: leaf}, {port name: the reference's path}) of an LM pytree."""
    flat, source = {}, {}
    for top, tree in params.items():
        if top in _STAGES:
            _stage_leaves(tree, top, _STAGES[top], flat, source)
            continue
        for path, leaf in _leaves(tree):
            name = f"{top}.{path}" if path else top
            flat[name], source[name] = leaf, name
    return flat, source


def lm_params_from_numpy(params: dict, cfg: ArchConfig) -> dict:
    """The reference's LM param pytree -> the port's ``Model`` state dict.

    ``params`` is ``repro.models.Model(cfg).init(key)`` with numpy leaves:
    ``embed`` / ``unembed`` / ``final_norm`` and ``stages``, a list with one
    dict per stage whose leaves are stacked ``[n_groups, ...]`` over the
    stage's cycle ``l0, l1, ...``. Stage s, group g, cycle slot j becomes
    layer ``layers.{i}``, i counting in that order; whisper's
    ``enc_stages`` become ``enc_layers.{i}`` in the same order. Every leaf
    below a slot keeps its path (hybrid's ``gate_attn``,
    ``moe.experts.w1``, MLA's ``attn.wuk``, cross's ``xgate``), and
    top-level leaves (hymba's ``meta``, whisper's ``enc_norm``) keep their
    names. bf16 leaves (deepseek-v3's ``param_dtype``) arrive unchanged:
    the f32 step between holds every bf16 value exactly. Raises
    ``KeyError`` on a missing or unexpected leaf and ``ValueError`` on a
    shape mismatch, naming the leaf's path in the reference's pytree.
    """
    from .models.model import Model

    want = Model(cfg, "meta").state_dict()
    flat, source = _flat_lm(params)
    for name in want:
        if name not in flat:
            raise KeyError(f"missing leaf for {name} (config {cfg.name} wants {tuple(want[name].shape)})")
    for name in flat:
        if name not in want:
            raise KeyError(f"unexpected leaf {source[name]} (no {name} in the port's model)")
    out = {}
    for name, t in want.items():
        a = np.asarray(flat[name], dtype=np.float32)
        if a.shape != tuple(t.shape):
            raise ValueError(f"{source[name]}: shape {a.shape}, the port's {name} wants {tuple(t.shape)}")
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(t.dtype)
    return out


def _moment(a) -> torch.Tensor:
    """A moment leaf in its own storage dtype (bfloat16 or float32)."""
    a = np.asarray(a)
    dt = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dt)


def _unfactor_vectors(tree):
    """In a stage's second moments, a factored stacked vector ({"vr" [G],
    "vc" [D]} for a [G, D] leaf of one [D] vector a layer) becomes the full
    [G, D] estimate its update reads, vr vc / mean(vr); stacked matrices
    keep their per-layer factors."""
    if isinstance(tree, dict):
        if set(tree) == {"vr", "vc"} and np.ndim(tree["vr"]) == 1:
            vr, vc = np.asarray(tree["vr"], np.float32), np.asarray(tree["vc"], np.float32)
            return vr[:, None] * vc[None, :] / max(float(vr.mean()), 1e-30)
        return {k: _unfactor_vectors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unfactor_vectors(v) for v in tree]
    return tree


def lm_train_state_from_numpy(params: dict, opt: dict, step, cfg: ArchConfig):
    """The reference's ``TrainState`` (``params``, ``opt`` = {"m", "v",
    "step"}, ``step``; numpy leaves) -> the port's ``training.TrainState``.
    Params go through ``lm_params_from_numpy``; the moments keep their
    dtype (f32 or bf16). A factored ``v`` leaf {"vr", "vc"} stays factored
    per layer; a stage's stacked vectors, which the reference factors
    across its layers and the port does not (``training/optimizer.py``),
    carry as the full estimate the reference's next update reads."""
    from .training.train_step import TrainState

    sd = lm_params_from_numpy(params, cfg)
    m, _ = _flat_lm(opt["m"])
    v, _ = _flat_lm({k: (_unfactor_vectors(t) if k in _STAGES else t) for k, t in opt["v"].items()})
    mom_m, mom_v = {}, {}
    for n in sd:
        mom_m[n] = _moment(m[n])
        if n in v:
            mom_v[n] = _moment(v[n])
        elif f"{n}.vr" in v:
            mom_v[n] = {"vr": _moment(v[f"{n}.vr"]), "vc": _moment(v[f"{n}.vc"])}
        else:
            raise KeyError(f"no second moment for {n}")
    return TrainState(params=sd,
                      opt={"m": mom_m, "v": mom_v, "step": int(np.asarray(opt["step"]))},
                      step=int(np.asarray(step)))
