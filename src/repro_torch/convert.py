"""Carry a trained forest across frameworks as numpy arrays.

A forest is six arrays (``Forest.FIELDS``) plus its config, and a model
adds the ``[F, B-1]`` bin edges; both packages use the same layout, so a
model trained by the JAX reference loads here unchanged:
``model_from_numpy({n: np.asarray(getattr(jax_model.forest, n)) ...},
jax_model.bin_edges, ForestConfig(**dataclasses.asdict(jax_cfg)), "cuda")``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.api import PRFModel
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
