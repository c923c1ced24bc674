"""Fault injection and straggler mitigation harness.

Counterpart of ``repro/launch/fault.py``: seeded chaos hooks
(``CheckpointCorruptor``, ``FaultInjector``) that draw exactly what the
reference's draw for the same seed (both use ``np.random.default_rng``
in the same order), deadline-based straggler detection, and a
checkpoint/restart supervisor for training loops (``ElasticRunner``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np

from ..checkpoint.checkpoint import CheckpointManager, latest_step, list_steps


class SimulatedFailure(RuntimeError):
    pass


class CheckpointCorruptor:
    """Deterministic byte-flipper for checkpoint-corruption drills.

    Flips ``n_bytes`` bytes (XOR 0xFF, so every flip changes the byte and
    the leaf's CRC32 always catches it) at seeded offsets inside one leaf
    file of a checkpoint step. File choice and offsets come from
    ``np.random.default_rng(seed)`` over the *sorted* ``.npy`` file list,
    so the same (seed, directory contents) corrupts the same bytes.
    """

    def __init__(self, *, seed: int = 0, n_bytes: int = 16):
        if n_bytes < 1:
            raise ValueError("n_bytes must be >= 1")
        self._rng = np.random.default_rng(seed)
        self.n_bytes = n_bytes

    def corrupt(self, directory: str, step: Optional[int] = None) -> int:
        """Corrupt one leaf file of ``step`` (default: the newest step).
        Returns the step that was corrupted."""
        if step is None:
            steps = list_steps(directory)
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {directory}")
            step = steps[-1]
        path = os.path.join(directory, f"step_{step:08d}")
        files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        if not files:
            raise FileNotFoundError(f"no leaf files in {path}")
        target = os.path.join(path, files[int(self._rng.integers(len(files)))])
        with open(target, "rb") as f:
            data = bytearray(f.read())
        offsets = self._rng.integers(0, len(data), size=min(self.n_bytes, len(data)))
        for off in offsets:
            data[int(off)] ^= 0xFF
        with open(target, "wb") as f:
            f.write(bytes(data))
        return step


class FaultInjector:
    """Deterministic, seeded fault injection for chaos tests.

    A callable hook: each call draws from its own ``np.random.default_rng``
    stream and raises :class:`SimulatedFailure` with probability ``rate``.
    ``max_consecutive`` bounds failure streaks, so a consumer with
    ``max_retries >= max_consecutive`` always makes progress. The same
    (seed, call sequence) reproduces the same fault sequence.
    """

    def __init__(self, rate: float, *, seed: int = 0, max_consecutive: int = 2):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        if max_consecutive < 1:
            raise ValueError("max_consecutive must be >= 1")
        self.rate = rate
        self.max_consecutive = max_consecutive
        self._rng = np.random.default_rng(seed)
        self._streak = 0
        self.calls = 0
        self.injected = 0

    def __call__(self, site: str = "") -> None:
        self.calls += 1
        fail = self._streak < self.max_consecutive and self._rng.random() < self.rate
        if fail:
            self._streak += 1
            self.injected += 1
            raise SimulatedFailure(f"injected fault #{self.injected} at {site or 'unnamed site'}")
        self._streak = 0


@dataclasses.dataclass
class StragglerMonitor:
    """Deadline-based slow-step detection (median * ``factor`` rule):
    flags a step whose duration exceeds ``factor`` times the median of
    the steps before it, after ``warmup`` steps."""

    factor: float = 3.0
    warmup: int = 5
    durations: List[float] = dataclasses.field(default_factory=list)
    flagged: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, duration: float) -> bool:
        self.durations.append(duration)
        if len(self.durations) <= self.warmup:
            return False
        med = float(np.median(self.durations[:-1]))
        if duration > self.factor * med:
            self.flagged.append(step)
            return True
        return False


@dataclasses.dataclass
class ElasticRunner:
    """Checkpoint/restart training-loop supervisor.

    Runs ``loop_fn(state, start_step, n_steps, on_step)``; on a
    :class:`SimulatedFailure`, restores the latest checkpoint and
    continues (at most ``max_restarts`` times). Exactly-once step
    semantics come from the step counter in the checkpointed state.
    ``device`` is where restored tensor leaves go (``None``: each
    template tensor's own device).
    """

    manager: CheckpointManager
    max_restarts: int = 3

    def run(self, init_state_fn: Callable[[], object], loop_fn: Callable, n_steps: int,
            device=None):
        restarts = 0
        monitor = StragglerMonitor()

        def restore_or_init():
            if latest_step(self.manager.directory) is not None:
                return self.manager.restore_latest(init_state_fn(), device=device)
            return init_state_fn(), 0

        state, start = restore_or_init()
        while start < n_steps:
            try:
                def on_step(step, st, metrics, t0=[time.time()]):
                    now = time.time()
                    monitor.record(step, now - t0[0])
                    t0[0] = now
                    self.manager.maybe_save(st, step)

                state = loop_fn(state, start, n_steps, on_step)
                start = n_steps
            except SimulatedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                state, start = restore_or_init()
        return state, monitor, restarts
