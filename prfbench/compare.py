"""The numbers that decide ``correct``: the program's answers judged against the reference.

* ``differ``: entries that differ bit for bit (a shape that differs
  counts every entry of the larger side). Used where the answer is one
  formula with no summation order left open (the bin edges) or a sum of
  integer counts (a node's class counts), so a sound answer reads 0.
* ``trees_differ``: the share of trees whose answer (node arrays, tree
  weight, and feature mask where the run has it) is not the reference's
  bit for bit. A sound change of a float summation order can flip a near
  tie and grow a tree otherwise; a precision lowered flips many.
* ``vote_gap``: the widest gap by which the class a call answered lies
  below the reference's best class in the reference's vote, as a share of
  the row's whole vote (1 for a row with no answer).
"""
from __future__ import annotations

import numpy as np
import torch

from prfbench import reference
from prfbench.reference import Forest


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32)
    if t.dtype == torch.float64:
        return t.contiguous().view(torch.int64)
    return t


def differ(a, b) -> int:
    """Entries of ``a`` and ``b`` that are not the same bits."""
    a, b = _tensor(a), _tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel())
    return int((_bits(a) != _bits(b.to(a.device))).sum())


def forest(answer: dict, ref) -> int:
    """Node entries of a trained forest that differ from the reference's."""
    return sum(differ(answer[f], getattr(ref, f)) for f in Forest.FIELDS)


def _tree_rows_differ(a, b):
    """[k] bool, tree t's entries of ``a`` and ``b`` differ; None if the shapes do."""
    a = _tensor(a)
    b = _tensor(b).to(a.device)
    if a.shape != b.shape or a.dtype != b.dtype or a.dim() == 0:
        return None
    return (_bits(a) != _bits(b)).reshape(a.shape[0], -1).any(dim=1).cpu()


def trees_differ(answer: dict, ref_forest, ref_weight, mask=None, ref_mask=None) -> float:
    """% of the reference's trees whose node arrays, tree weight or (given)
    feature mask the answer does not hold bit for bit (100 if a shape differs)."""
    pairs = [(answer[f], getattr(ref_forest, f)) for f in Forest.FIELDS]
    pairs.append((answer["tree_weight"], ref_weight))
    if mask is not None:
        pairs.append((mask, ref_mask))
    parts = [_tree_rows_differ(a, b) for a, b in pairs]
    if any(p is None for p in parts):
        return 100.0
    bad = torch.stack(parts).any(dim=0)
    return 100.0 * float(bad.sum()) / bad.shape[0]


def vote_gap(labels, scores: torch.Tensor) -> float:
    """The widest gap, over rows, between the reference's best score and its
    score of the answered class, over the row's whole vote. ``scores`` [N, C]
    are the reference's (float64); a missing row or a class out of range
    reads 1."""
    lab = _tensor(labels).to(scores.device).long().reshape(-1)
    if lab.shape[0] != scores.shape[0]:
        return 1.0
    ok = (lab >= 0) & (lab < scores.shape[1])
    got = torch.gather(scores, 1, torch.where(ok, lab, 0)[:, None])[:, 0]
    total = torch.clamp_min(scores.sum(dim=1), torch.finfo(scores.dtype).tiny)
    gap = torch.where(ok, (scores.max(dim=1).values - got) / total, torch.ones_like(got))
    return float(gap.max()) if gap.numel() else 0.0



class TrainingJudge:
    """Judges trainings against ``reference.train``'s ``ref`` on the same rows
    and draws ``w``. The routed counts of a forest are worked out once for
    every forest that differs from those judged before."""

    def __init__(self, ref: dict, w, spec):
        self.ref, self.w, self.spec = ref, w, spec
        self._routed = []                      # (answer, its routed counts)

    def _routed_counts(self, answer: dict) -> torch.Tensor:
        for seen, routed in self._routed:
            if all(differ(answer[f], seen[f]) == 0 for f in Forest.FIELDS):
                return routed
        routed = reference.node_counts(answer, self.ref["bins"], self.ref["y"], self.w, self.spec)
        self._routed.append((answer, routed))
        return routed

    def numbers(self, answer: dict, mask=None) -> dict:
        """The numbers compared for one training (``mask``: the feature mask
        the run read from the program, or None)."""
        ref = self.ref
        return {"edges_mismatch": differ(answer["edges"], ref["edges"]),
                "count_mismatch": differ(answer["class_counts"], self._routed_counts(answer)),
                "trees_differ_pct": trees_differ(answer, ref["forest"], ref["tree_weight"],
                                                 mask, ref["mask"])}
