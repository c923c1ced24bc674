"""Core datatypes for the Parallel Random Forest (PRF), PyTorch port.

Counterpart of ``repro/core/types.py``. ``ForestConfig`` is a
field-for-field copy (defaults, validation, derived properties), so a
config moves between the packages unchanged:
``ForestConfig(**dataclasses.asdict(jax_config))``.

The forest is a flat, fixed-shape *node pool*: every tree owns
``max_nodes = 1 + 2 * frontier * depth`` slots (plus one pad row), and
level ``L`` allocates its children inside the band
``[1 + 2*frontier*L, 1 + 2*frontier*(L+1))``.

Backend knobs keep the reference's strings: ``"pallas"`` names the
port's hand-written CUDA kernel, ``"segment_sum"`` / ``"xla"`` its plain
PyTorch version, and ``"auto"`` picks the kernel for tensors on CUDA and
the plain version for tensors on the CPU (it keys on the tensor's
device, never on whether a kernel could be built).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """Hyper-parameters of the PRF algorithm (paper §3–§4)."""

    n_trees: int = 32                 # k — ensemble size
    max_depth: int = 8                # levels of splitting
    n_bins: int = 64                  # histogram bins per feature
    n_classes: int = 2                # C
    max_frontier: int = 0             # beam width; 0 => full 2**max_depth
    min_samples_split: int = 2
    min_gain: float = 1e-7            # minimal gain ratio to split
    # paper §3.2 dimension reduction: "importance" | "random" | "all"
    feature_mode: str = "importance"
    n_important: int = 0              # paper's k  (0 => ceil(sqrt(m_selected)))
    n_selected: int = 0               # paper's m  (0 => ceil(sqrt(M)))
    # paper §3.3 weighted voting
    weighted_voting: bool = True
    soft_voting: bool = False
    # task-parallel execution knobs (§4.2)
    tree_chunk: int = 0               # trees processed per level-step (0 => all)
    early_exit: bool = True           # stop once every frontier is empty
    sample_block: int = 0             # rows per block of the streaming plane (0: resident)
    bin_fit: str = "auto"             # exact | blocked (streaming sketch) | auto
    regression: bool = False
    packed_hist: bool = False         # class index folded into the histogram index
    hist_reduce: str = "psum"         # mesh plane only (not ported)
    hist_reuse: str = "auto"          # sibling-subtraction histogram reuse: auto | on | off
    hist_reuse_budget_mb: int = 256
    # "pallas" = CUDA kernel, "segment_sum"/"xla" = plain PyTorch,
    # "auto" = kernel on CUDA tensors, plain version on CPU tensors.
    hist_backend: str = "auto"
    split_backend: str = "auto"
    predict_backend: str = "auto"

    def __post_init__(self):
        from .binning import validate_n_bins

        validate_n_bins(self.n_bins)
        if self.bin_fit not in ("auto", "exact", "blocked"):
            raise ValueError(
                f"bin_fit must be 'auto', 'exact' or 'blocked', got {self.bin_fit!r}"
            )
        if self.hist_reuse not in ("auto", "on", "off"):
            raise ValueError(
                f"hist_reuse must be 'auto', 'on' or 'off', got {self.hist_reuse!r}"
            )

    def resolved_bin_fit(self) -> str:
        """Resolve bin_fit='auto': blocked iff the trainer streams blocks."""
        if self.bin_fit != "auto":
            return self.bin_fit
        return "blocked" if self.sample_block > 0 else "exact"

    def resolved_hist_reuse(self) -> str:
        """Resolve hist_reuse='auto': on for classification, off for regression."""
        if self.hist_reuse != "auto":
            return self.hist_reuse
        return "off" if self.regression else "on"

    @property
    def frontier(self) -> int:
        f = self.max_frontier if self.max_frontier > 0 else 2 ** self.max_depth
        return min(f, 2 ** self.max_depth)

    @property
    def max_splits_per_level(self) -> int:
        return max(self.frontier // 2, 1)

    @property
    def max_nodes(self) -> int:
        return 1 + 2 * self.max_splits_per_level * self.max_depth

    def resolved(self, n_features: int) -> "ForestConfig":
        """Fill data-dependent defaults (m = ceil(sqrt(M)), k_imp = ceil(sqrt(m)))."""
        m = self.n_selected if self.n_selected > 0 else max(1, int(math.ceil(math.sqrt(n_features))))
        m = min(m, n_features)
        k_imp = self.n_important if self.n_important > 0 else max(1, int(math.ceil(math.sqrt(m))))
        k_imp = min(k_imp, m)
        return dataclasses.replace(self, n_selected=m, n_important=k_imp)


@dataclasses.dataclass
class Forest:
    """A trained PRF model — flat node-pool representation.

    Shapes (k = n_trees, P = max_nodes + 1, C = n_classes):
      feature      [k, P] int32   split feature, -1 => leaf / unused
      threshold    [k, P] int32   go left iff bin <= threshold
      left_child   [k, P] int32   pool id of left child (right = left+1), -1 => leaf
      class_counts [k, P, C] f32  weighted class histogram at node creation
      value        [k, P] f32     regression value (weighted mean of y)
      tree_weight  [k] f32        w_i — OOB accuracy (Eq. 8) or 1.0
    """

    feature: torch.Tensor
    threshold: torch.Tensor
    left_child: torch.Tensor
    class_counts: torch.Tensor
    value: torch.Tensor
    tree_weight: torch.Tensor
    config: ForestConfig = None

    FIELDS = ("feature", "threshold", "left_child", "class_counts", "value", "tree_weight")

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def device(self) -> torch.device:
        return self.feature.device


@dataclasses.dataclass
class GrowthState:
    """The growth engine's level-loop carry (``core/engine.py``).

    The reference's ``rng`` leaf (reserved, unused) is left out; ``level``
    is a host integer because the port's level loop runs on the host.
    ``FIELDS`` gives the checkpoint keys (``checkpoint._flatten``): each
    field keeps the reference's index, so a checkpoint holds the
    reference's keys without its ``3`` (``rng``).
    ``hist_cache`` is None with histogram reuse off; with it on, the dict
    of ``engine.init_hist_cache``: ``hist`` [k, S, F, B, C] (last level's
    histograms in paired-row order), ``perm`` [k, S] (its slot -> row
    map), ``parent`` and ``small_right`` [k, R] (``gain.sibling_plan``).
    """

    forest: Forest
    slot_node: torch.Tensor     # [k, S] pool node id of each active frontier slot, -1 idle
    sample_slot: torch.Tensor   # [k, N] frontier slot of each sample, -1 parked
    level: int = 0              # next level to grow
    hist_cache: Optional[dict] = None

    FIELDS = ("forest", "slot_node", "sample_slot", None, "level", "hist_cache")
