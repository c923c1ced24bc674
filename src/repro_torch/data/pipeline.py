"""Per-block data validation (numpy copy of the validator in
``repro/data/pipeline.py``).

``train_prf``'s default ``bad_block_policy="raise"`` runs it over the
resident dataset (one block) before anything is binned. The streaming
feeder of the reference is not ported in this slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class DataIntegrityError(ValueError):
    """A sample block failed integrity validation (non-finite features,
    out-of-range labels, or shape drift). Carries the offending block
    index, columns, and reason so operators can find the bad shard."""

    def __init__(
        self, message: str, *,
        block_index: Optional[int] = None,
        columns: Sequence[int] = (),
        reason: str = "",
    ):
        super().__init__(message)
        self.block_index = block_index
        self.columns = tuple(int(c) for c in columns)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class BlockIssue:
    """One validation finding for one sample block."""

    index: int                    # block index in the sweep order
    reason: str                   # "nonfinite" | "label" | "shape"
    columns: Tuple[int, ...]      # offending feature columns ((): n/a)
    bad_cells: int = 0            # non-finite feature cells
    bad_labels: int = 0           # out-of-range / non-finite labels

    def describe(self) -> str:
        if self.reason == "shape":
            return f"block {self.index}: shape drift"
        if self.reason == "label":
            return f"block {self.index}: {self.bad_labels} bad label(s)"
        return (
            f"block {self.index}: {self.bad_cells} non-finite cell(s) in "
            f"columns {list(self.columns)}"
        )


@dataclasses.dataclass
class QuarantineReport:
    """What the block validator found and did — attached to the trained
    model (``PRFModel.quarantine``) and surfaced by serving ``health()``.

    ``quarantined`` lists blocks dropped from every sweep;
    ``sanitized_cells`` / ``sanitized_labels`` count deterministic
    imputations. ``clean`` is True when nothing was found, which is the
    guarantee that validation was a bitwise no-op on the model.
    """

    policy: str
    blocks_checked: int = 0
    quarantined: List[int] = dataclasses.field(default_factory=list)
    sanitized_cells: int = 0
    sanitized_labels: int = 0
    issues: List[BlockIssue] = dataclasses.field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.issues

    def counters(self) -> Dict[str, int]:
        return {
            "blocks_checked": self.blocks_checked,
            "blocks_quarantined": len(self.quarantined),
            "sanitized_cells": self.sanitized_cells,
            "sanitized_labels": self.sanitized_labels,
        }


class BlockValidator:
    """Deterministic per-block integrity validator of the data plane.

    Checks each ``[Nb, F]`` block for NaN/Inf cells, shape drift against
    the expected feature count, and (when labels are supplied)
    out-of-range or non-finite labels. ``policy`` decides what a finding
    does:

    * ``"raise"`` — typed :class:`DataIntegrityError` naming the block
      index and offending columns; nothing trains on poisoned data.
    * ``"sanitize"`` — deterministic imputation: bad feature cells are
      zeroed (the trainer maps them to bin 0), bad labels are imputed to
      0 and the sample's DSI weights neutralized — the model is
      reproducible run-to-run.
    * ``"quarantine"`` — the block is dropped from every sweep and
      recorded in the :class:`QuarantineReport`.

    Validation is pure numpy over host blocks (memmap pages are touched
    once, before any device transfer), and on clean data it mutates
    nothing — the trained model is bitwise identical with validation on
    or off.
    """

    POLICIES = ("raise", "sanitize", "quarantine")

    def __init__(
        self, policy: str = "raise", *,
        n_features: Optional[int] = None,
        n_classes: Optional[int] = None,
        regression: bool = False,
    ):
        if policy not in self.POLICIES:
            raise ValueError(
                f"bad_block_policy must be one of {self.POLICIES} (or None "
                f"to disable validation), got {policy!r}"
            )
        self.policy = policy
        self.n_features = n_features
        self.n_classes = n_classes
        self.regression = regression

    def check(
        self, block: np.ndarray, index: int,
        y_block: Optional[np.ndarray] = None,
    ) -> Optional[BlockIssue]:
        """Inspect one block (and its label slice); return the finding."""
        b = np.asarray(block)
        n_feat = self.n_features
        if b.ndim != 2 or (n_feat is not None and b.shape[1] != n_feat):
            return BlockIssue(index=index, reason="shape", columns=())
        bad_cells = 0
        cols: Tuple[int, ...] = ()
        if np.issubdtype(b.dtype, np.inexact):
            finite = np.isfinite(b)
            if not finite.all():
                bad = ~finite
                bad_cells = int(bad.sum())
                cols = tuple(int(c) for c in np.flatnonzero(bad.any(axis=0)))
        bad_labels = 0
        if y_block is not None:
            yb = np.asarray(y_block)
            bad_y = np.zeros(yb.shape[0], dtype=bool)
            if np.issubdtype(yb.dtype, np.inexact):
                bad_y |= ~np.isfinite(yb)
            if not self.regression and self.n_classes is not None:
                with np.errstate(invalid="ignore"):
                    bad_y |= (yb < 0) | (yb >= self.n_classes)
            bad_labels = int(bad_y.sum())
        if bad_cells or bad_labels:
            reason = "nonfinite" if bad_cells else "label"
            return BlockIssue(
                index=index, reason=reason, columns=cols,
                bad_cells=bad_cells, bad_labels=bad_labels,
            )
        return None

    def _label_mask(self, y_block: np.ndarray) -> np.ndarray:
        yb = np.asarray(y_block)
        bad = np.zeros(yb.shape[0], dtype=bool)
        if np.issubdtype(yb.dtype, np.inexact):
            bad |= ~np.isfinite(yb)
        if not self.regression and self.n_classes is not None:
            with np.errstate(invalid="ignore"):
                bad |= (yb < 0) | (yb >= self.n_classes)
        return bad

    def screen(
        self,
        blocks: Sequence[np.ndarray],
        y: Optional[np.ndarray] = None,
    ):
        """Validate every block and apply the policy.

        Returns ``(blocks, y, cell_masks, label_masks, report)`` —
        blocks/y are the originals when clean (bitwise no-op), imputed
        copies where sanitization touched them; ``cell_masks[i]`` /
        ``label_masks[i]`` are boolean masks of the imputed feature
        cells / labels of block ``i`` (the trainer forces masked cells
        to bin 0 and zeroes masked samples' weights); quarantined block
        indices are listed in ``report.quarantined``.
        """
        blocks = list(blocks)
        y_out = None if y is None else np.asarray(y)
        report = QuarantineReport(policy=self.policy, blocks_checked=len(blocks))
        cell_masks: Dict[int, np.ndarray] = {}
        label_masks: Dict[int, np.ndarray] = {}
        n_feat = self.n_features
        if n_feat is None:
            for b in blocks:
                bb = np.asarray(b)
                if bb.ndim == 2:
                    n_feat = int(bb.shape[1])
                    break
        offset = 0
        for i, b in enumerate(blocks):
            bb = np.asarray(b)
            rows = int(bb.shape[0]) if bb.ndim >= 1 else 0
            yb = None if y_out is None else y_out[offset:offset + rows]
            issue = None
            if bb.ndim != 2 or (n_feat is not None and bb.shape[1] != n_feat):
                issue = BlockIssue(index=i, reason="shape", columns=())
                if self.policy != "quarantine" or y_out is not None:
                    # A drifted block can't be sanitized, and with labels
                    # present its row count can't be reconciled against y.
                    raise DataIntegrityError(
                        f"block {i} drifted in shape: expected [Nb, "
                        f"{n_feat}], got {list(bb.shape)}",
                        block_index=i, reason="shape",
                    )
            else:
                issue = self.check(bb, i, yb)
            if issue is None:
                offset += rows
                continue
            report.issues.append(issue)
            if self.policy == "raise":
                raise DataIntegrityError(
                    issue.describe(), block_index=i,
                    columns=issue.columns, reason=issue.reason,
                )
            if issue.reason == "shape":
                report.quarantined.append(i)
                offset += rows
                continue
            # sanitize and quarantine both impute, so every downstream
            # consumer (bin-edge fitting included) sees finite data; a
            # quarantined block additionally drops out of every sweep.
            if issue.bad_cells:
                mask = ~np.isfinite(bb)
                fixed = bb.copy()
                fixed[mask] = 0.0
                blocks[i] = fixed
                cell_masks[i] = mask
                report.sanitized_cells += issue.bad_cells
            if issue.bad_labels:
                lmask = self._label_mask(yb)
                if y_out is y:
                    y_out = y_out.copy()
                y_out[offset:offset + rows][lmask] = 0
                label_masks[i] = lmask
                report.sanitized_labels += issue.bad_labels
            if self.policy == "quarantine":
                report.quarantined.append(i)
            offset += rows
        return blocks, y_out, cell_masks, label_masks, report


def screen_blocks(
    blocks: Sequence[np.ndarray],
    y: Optional[np.ndarray] = None,
    *,
    policy: str,
    n_features: Optional[int] = None,
    n_classes: Optional[int] = None,
    regression: bool = False,
):
    """Module-level convenience around :meth:`BlockValidator.screen`."""
    validator = BlockValidator(
        policy, n_features=n_features, n_classes=n_classes,
        regression=regression,
    )
    return validator.screen(blocks, y)
