"""The streaming data plane's host side (counterpart of
``repro/data/pipeline.py``): block lists over host arrays and
``np.memmap`` sources (``sample_blocks``, ``stream_blocks``), the
per-block validator (``BlockValidator``, ``screen_blocks``) and the
asynchronous host-to-device feed (``BlockFeeder``).

``train_prf``'s default ``bad_block_policy="raise"`` runs the validator
over the training source before anything is binned (one block on the
resident path, every ``sample_block`` on the streamed one).

On CUDA a sweep's producer thread copies each block into one of
``prefetch + 1`` pinned host buffers and from there to the card with a
non-blocking copy on its own stream; an event marks the copy's end. The
consumer's stream waits on that event before it touches the block
(``_Sweep.__next__``), and a pinned buffer is written again only after
the event of its last copy has completed. On the CPU the thread makes a
plain copy. A mesh placement (an object with a ``device`` and a
``local(block, index)``) feeds each rank its own slice of every swept
block: its ``(sample x feature)`` block of a global one
(``core/distributed._BlockPlacement``, as the reference's
``NamedSharding`` placement does), or its feature columns of the
host-local rows this process read (the multi-process plane's
``launch/multiproc.MultiHostMesh.block_placement``, the reference's
callable placement).

``TokenPipeline`` is the LM trainer's data (numpy only, the reference's
bit for bit): a synthetic corpus drawn once from the seed and batches
gathered from it through a DSI index table per epoch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import as_tensor, resolve_device


def sample_blocks(
    x: Union[np.ndarray, Sequence[np.ndarray]], block_rows: int = 0,
    row_range: Optional[Tuple[int, int]] = None,
) -> List[np.ndarray]:
    """Zero-copy ``[Nb, F]`` row views over a host array / ``np.memmap``.

    An array source is sliced into ``block_rows``-row views (no copy:
    memmap pages are read only when a block is fed). An explicit
    list/tuple passes through with ndarray blocks (memmap views
    included) kept **by identity**; only non-array entries are
    materialized, once, here. ``block_rows <= 0`` means one block.

    ``row_range=(lo, hi)`` restricts each block to its intersection with
    the global row interval ``[lo, hi)``: block boundaries stay where a
    one-process sweep puts them, blocks outside the range become empty
    ``[0, F]`` views (block indexing stays global).
    """
    if isinstance(x, (list, tuple)):
        blocks = [b if isinstance(b, np.ndarray) else np.asarray(b) for b in x]
        if row_range is None:
            return blocks
        lo, hi = row_range
        out, off = [], 0
        for b in blocks:
            b0, b1 = off, off + b.shape[0]
            out.append(b[max(lo - b0, 0):max(min(hi, b1) - b0, 0)])
            off = b1
        return out
    src = np.asarray(x)
    nb = block_rows if block_rows > 0 else src.shape[0]
    if row_range is None:
        return [src[i:i + nb] for i in range(0, src.shape[0], nb)]
    lo, hi = row_range
    return [
        src[min(max(lo, i), i + nb):min(max(hi, i), i + nb)]
        for i in range(0, src.shape[0], nb)
    ]


def stream_blocks(
    x: Union[np.ndarray, Sequence[Any]],
    sample_block: Optional[int],
    *,
    what: str,
    n_y: Optional[int] = None,
    n_w: Optional[int] = None,
) -> List[Any]:
    """The one block-list constructor and validator of the streaming data
    plane (growth, dimension reduction, OOB, prediction).

    An explicit block sequence passes through (tensors included); an
    array/memmap source is sliced per ``sample_block``, which must be
    > 0 so the full ``[N, F]`` matrix never silently becomes one device
    block. Rejects empty block sequences and, when the caller gives its
    label/weight lengths, blocks that do not cover them.
    """
    if isinstance(x, (list, tuple)):
        blocks = list(x)
    else:
        if sample_block is None or sample_block <= 0:
            raise ValueError(
                f"{what} with an array/memmap source needs sample_block > 0 "
                "— sample_block=0 would feed the whole [N, F] matrix as one "
                "device block, which is exactly what the streaming plane "
                "exists to avoid (pass an explicit block list to stream "
                "from a custom source)"
            )
        blocks = sample_blocks(x, sample_block)
    if not blocks:
        raise ValueError(
            f"{what} got an empty block sequence — the data source yielded "
            "no [Nb, F] sample blocks (empty block list, or an array source "
            "with 0 rows)"
        )
    if n_y is not None or n_w is not None:
        covered = sum(int(b.shape[0]) for b in blocks)
        if (n_y is not None and covered != n_y) or (n_w is not None and covered != n_w):
            raise ValueError(
                f"{what}: blocks cover {covered} samples, but y has {n_y} "
                f"and weights {n_w}"
            )
    return blocks


class FeedError(RuntimeError):
    """A block feed failed permanently (retry budget exhausted, a
    non-retryable error, or a producer thread that would not stop)."""


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


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _PinnedRing:
    """A sweep's ``n`` pinned host buffers and its copy stream (CUDA).

    ``upload`` copies a block into the next buffer, then starts its
    non-blocking copy to the card on ``stream`` and records an event
    after it. A buffer is written again only once the event of its last
    copy has completed, so a block still in flight is never overwritten."""

    def __init__(self, n: int, nbytes: int, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.bufs = [torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
                     for _ in range(n)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * n
        self.next = 0

    def upload(self, block) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Run inside ``torch.cuda.stream(self.stream)``."""
        ev = torch.cuda.Event()
        if isinstance(block, torch.Tensor):
            out = block.to(self.device, non_blocking=True)
            ev.record(self.stream)
            return out, ev
        a = np.asarray(block)
        j = self.next
        self.next = (j + 1) % len(self.bufs)
        if self.events[j] is not None:
            self.events[j].synchronize()           # the last copy out of this buffer has landed
        host = self.bufs[j][:a.nbytes].view(_torch_dtype(a.dtype)).view(a.shape)
        # memmap pages are read here; torch's copy runs on all host threads
        # (5x numpy's one-thread copy at a [131072, 128] uint8 block)
        if a.flags.writeable and a.flags.c_contiguous:
            host.copy_(torch.from_numpy(a))
        else:
            host.numpy()[...] = a
        out = torch.empty(a.shape, dtype=host.dtype, device=self.device)
        out.copy_(host, non_blocking=True)
        ev.record(self.stream)
        self.events[j] = ev
        return out, ev


class _Sweep:
    """One prefetching pass over a feeder's blocks.

    A real iterator object (not a generator) so the background thread
    has an owner with a deterministic ``close()``: a producer-side
    exception is re-raised from the consumer's next ``__next__`` after
    the thread is joined, and an early consumer exit (``break``, an
    exception in the loop body, or ``__exit__``) cancels the producer,
    drops its queued blocks and joins: never a leaked thread or a hung
    ``queue.put``.
    """

    def __init__(self, feeder: "BlockFeeder"):
        self._feeder = feeder
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=feeder.prefetch)
        self._stop = object()
        self._cancel = threading.Event()
        self._closed = False
        self._ring = None
        if feeder.placement.type == "cuda":
            host = [feeder.blocks[i] for i in feeder.live_blocks]
            nbytes = max((np.asarray(b).nbytes for b in host if not isinstance(b, torch.Tensor)),
                         default=0)
            self._ring = _PinnedRing(feeder.prefetch + 1, nbytes, feeder.placement)
        self._thread = threading.Thread(
            target=self._produce, daemon=True, name="prf-block-feeder"
        )
        self._thread.start()

    def _put_item(self, item) -> bool:
        """Enqueue with cancel polling so a gone consumer can't wedge us."""
        while not self._cancel.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            ctx = contextlib.ExitStack()
            if self._ring is not None:
                # torch.cuda.stream is per thread: entered here, in the producer.
                ctx.enter_context(torch.cuda.device(self._feeder.placement))
                ctx.enter_context(torch.cuda.stream(self._ring.stream))
            with ctx:
                for i in self._feeder.live_blocks:
                    if self._cancel.is_set():
                        return
                    b = self._feeder.blocks[i]
                    if not self._put_item(self._feeder._put(b, f"block[{i}]", i, self._ring)):
                        return
            self._put_item(self._stop)
        except BaseException as e:  # re-raised on the consumer side
            self._put_item(e)

    def __iter__(self) -> "_Sweep":
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        self._feeder.wait_s += time.perf_counter() - t0
        if item is self._stop:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        block, event = item
        if event is not None:
            # the consumer's stream waits for the copy; the caching
            # allocator keeps the block until that stream is done with it
            cur = torch.cuda.current_stream(block.device)
            cur.wait_event(event)
            block.record_stream(cur)
        return block

    def close(self) -> None:
        """Cancel the producer, drop queued blocks, join the thread.

        A producer that fails to stop within ``feeder.join_timeout``
        seconds is a wedged transfer: escalated to :class:`FeedError`
        (naming the last feed site) instead of silently leaking a live
        thread.
        """
        if self._closed:
            return
        self._closed = True
        self._cancel.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=self._feeder.join_timeout)
        self._feeder._sweeps.discard(self)
        if self._thread.is_alive():
            dist = torch.distributed
            proc = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
            raise FeedError(
                f"feeder thread {self._thread.name!r} on process {proc} "
                f"failed to stop within {self._feeder.join_timeout}s — a "
                f"transfer is wedged at site {self._feeder._last_site!r}"
            )

    def __enter__(self) -> "_Sweep":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _resolve_placement(placement) -> Tuple[torch.device, Optional[Callable]]:
    """``(device, local)``: where blocks go, and ``local(block, index)``,
    the slice of swept block ``index`` this rank feeds (None: the whole
    block)."""
    if placement is None or isinstance(placement, (str, torch.device)):
        return resolve_device(placement), None
    if hasattr(placement, "device") and callable(getattr(placement, "local", None)):
        return torch.device(placement.device), placement.local
    raise ValueError(f"placement {placement!r}: a torch.device, its name, or a mesh placement")


class BlockFeeder:
    """Asynchronous host-to-device feed of the streaming data plane.

    One feeder owns the host-side sample blocks of a whole training or
    evaluation run. Two jobs:

    * ``pin(a)`` — upload a per-block constant (labels, DSI weights)
      once, kept on the device for every later level sweep;
    * ``sweep()`` — yield the device copies of the live blocks in order,
      a background thread keeping ``prefetch`` copies in flight while
      the consumer's kernels run on the previous block (``prefetch=0``
      is the synchronous feed). On CUDA the copies go through pinned
      buffers on their own stream (module docstring).

    ``placement`` is a ``torch.device`` (or its name); ``None`` is the
    port's default device, ``cuda``; a mesh or multi-process placement
    feeds this rank's slice of each swept block (``pin`` uploads its
    array as it is).

    **Fault tolerance.** Every transfer (``pin`` and each sweep block)
    runs in a bounded retry loop: a ``retryable`` exception (default
    ``OSError``, flaky memmap page-ins, and ``RuntimeError``, which a
    failed CUDA copy raises) is retried up to ``max_retries`` times with
    exponential backoff (``backoff * backoff_factor**i``, capped at
    ``max_backoff`` seconds); exhaustion raises :class:`FeedError` from
    the last error. ``fault_hook(site)`` is called before every transfer
    (a deterministic chaos hook for tests). ``retries`` counts retried
    attempts; ``wait_s`` sums the seconds the consumer waited in a
    sweep's ``__next__`` (the feed that compute did not hide).

    ``validator`` screens the blocks once, at construction, and its
    quarantined blocks join ``quarantined``: they are never transferred.
    A feeder is a context manager: ``close()`` shuts down any live sweep
    threads deterministically.
    """

    def __init__(
        self,
        blocks: Sequence[Any],
        *,
        placement: Any = None,
        prefetch: int = 2,
        max_retries: int = 3,
        backoff: float = 0.05,
        backoff_factor: float = 2.0,
        max_backoff: float = 2.0,
        retryable: Tuple[type, ...] = (OSError, RuntimeError),
        fault_hook: Optional[Callable[[str], None]] = None,
        validator: Optional[BlockValidator] = None,
        quarantined: Sequence[int] = (),
        join_timeout: float = 10.0,
    ):
        self.blocks = list(blocks)
        if not self.blocks:
            raise ValueError(
                "BlockFeeder needs at least one sample block — got an empty "
                "block sequence"
            )
        # Quarantine is decided once, before any pin or sweep, so every
        # level sweep of a run sees the same live blocks.
        self.report: Optional[QuarantineReport] = None
        quar = {int(i) for i in quarantined}
        if validator is not None:
            self.blocks, _, _, _, self.report = validator.screen(self.blocks)
            quar |= set(self.report.quarantined)
        out_of_range = [i for i in quar if not 0 <= i < len(self.blocks)]
        if out_of_range:
            raise ValueError(
                f"quarantined block indices out of range: {sorted(out_of_range)}"
            )
        self.quarantined = tuple(sorted(quar))
        self.live_blocks = tuple(i for i in range(len(self.blocks)) if i not in quar)
        if not self.live_blocks:
            raise DataIntegrityError(
                f"every block quarantined ({len(self.blocks)} of "
                f"{len(self.blocks)}) — nothing left to train on",
                reason="quarantine",
            )
        self.prefetch = int(prefetch)
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if backoff < 0 or max_backoff < 0 or backoff_factor < 1.0:
            raise ValueError("backoff/max_backoff must be >= 0 and backoff_factor >= 1")
        if join_timeout <= 0:
            raise ValueError(f"join_timeout must be > 0, got {join_timeout}")
        self.placement, self._local = _resolve_placement(placement)
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff = float(max_backoff)
        self.retryable = tuple(retryable)
        self.fault_hook = fault_hook
        self.join_timeout = float(join_timeout)
        self.retries = 0                     # total retried attempts
        self.wait_s = 0.0                    # consumer's wait in sweep __next__
        self._last_site: Optional[str] = None
        self._sweeps: set = set()

    def __len__(self) -> int:
        return len(self.blocks)

    def _copy(self, block, ring: Optional[_PinnedRing]):
        """One transfer: ``(tensor, event or None)`` through the ring, else
        a tensor (a plain copy on the CPU, a synchronous upload on CUDA)."""
        if ring is not None:
            return ring.upload(block)
        if self.placement.type == "cpu" and isinstance(block, np.ndarray):
            return torch.from_numpy(np.array(block))
        return as_tensor(block, self.placement)

    def _put(self, block, site: str, index: Optional[int] = None,
             ring: Optional[_PinnedRing] = None):
        """One host-to-device transfer under the bounded retry policy."""
        self._last_site = site
        if index is not None and self._local is not None:
            block = self._local(block, index)      # this rank's slice of a swept block
        attempt = 0
        while True:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(site)
                out = self._copy(block, ring)
                return out if ring is not None else (out, None)
            except self.retryable as e:
                attempt += 1
                if attempt > self.max_retries:
                    raise FeedError(
                        f"feed of {site} failed permanently after "
                        f"{self.max_retries} retries: {e}"
                    ) from e
                self.retries += 1
                time.sleep(min(
                    self.backoff * self.backoff_factor ** (attempt - 1),
                    self.max_backoff,
                ))

    def pin(self, host_array) -> torch.Tensor:
        """Upload one host array to the feeder's device (once)."""
        return self._put(host_array, "pin")[0]

    def sweep(self) -> Iterator[torch.Tensor]:
        """Yield the *live* blocks as device tensors, prefetch-deep.

        Quarantined blocks are skipped entirely: never transferred. Zip
        with ``live_blocks`` to recover each yielded block's index.
        """
        if self.prefetch <= 0:
            def sync():
                for i in self.live_blocks:
                    t0 = time.perf_counter()
                    block = self._put(self.blocks[i], f"block[{i}]", i)[0]
                    self.wait_s += time.perf_counter() - t0
                    yield block
            return sync()
        s = _Sweep(self)
        self._sweeps.add(s)
        return s

    def close(self) -> None:
        """Shut down any live sweep threads (idempotent)."""
        for s in list(self._sweeps):
            s.close()

    def __enter__(self) -> "BlockFeeder":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


@dataclasses.dataclass
class TokenPipeline:
    """Synthetic LM corpus and its batches, the reference's
    (``repro/data/pipeline.py:TokenPipeline``) draw for draw: ``n_docs``
    documents of ``seq_len + 1`` tokens from Zipf marginals, each token
    following its predecessor's fixed successor with probability 1/2
    (learnable bigrams), held once as ``corpus`` [n_docs, seq_len + 1] int32."""
    vocab_size: int
    seq_len: int
    n_docs: int = 2048
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        probs = 1.0 / np.arange(1, self.vocab_size + 1) ** 1.1
        probs /= probs.sum()
        succ = rng.integers(0, self.vocab_size, self.vocab_size)
        toks = rng.choice(self.vocab_size, (self.n_docs, self.seq_len + 1), p=probs)
        follow = rng.random((self.n_docs, self.seq_len)) < 0.5
        for t in range(1, self.seq_len + 1):
            toks[:, t] = np.where(follow[:, t - 1], succ[toks[:, t - 1]], toks[:, t])
        self.corpus = toks.astype(np.int32)          # the single shared copy

    def dsi_epoch(self, epoch: int, batch: int, steps: int) -> np.ndarray:
        """Index table [steps, batch] of document ids: the DSI analogue (no data copied)."""
        rng = np.random.default_rng(self.seed * 1000 + epoch)
        return rng.integers(0, self.n_docs, (steps, batch)).astype(np.int32)

    def batch(self, dsi_row: np.ndarray) -> Dict[str, np.ndarray]:
        """``tokens`` / ``targets`` [batch, seq_len]: the documents of one row, shifted by one."""
        docs = self.corpus[dsi_row]
        return {"tokens": docs[:, :-1], "targets": docs[:, 1:]}

    def batches(self, batch: int, steps: int, *, epoch: int = 0,
                n_micro: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        """``steps`` batches with leaves [n_micro, batch / n_micro, seq_len]."""
        table = self.dsi_epoch(epoch, batch, steps)
        for s in range(steps):
            b = self.batch(table[s])
            yield {k: v.reshape(n_micro, batch // n_micro, *v.shape[1:]) for k, v in b.items()}
