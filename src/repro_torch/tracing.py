"""Spans of the resident training and scoring paths, kept in memory.

    from repro_torch import tracing

    with tracing.recording() as rec:
        model = fit_prf_from_draws(x, y, cfg, w, u)
        labels = model.predict(x_test)
    for s in rec.drain():
        print(s.call, s.name, s.parent, s.seconds)

A span is a host interval: its name, its start and end on the host's
``perf_counter_ns``, the span open below it on the same thread (its
parent) and the call it belongs to. The root of a call (``fit``,
``predict``) takes a new call id; every span under it shares that id.
Each thread keeps its own stack of open spans. Spans stay in the
recorder until ``drain()`` hands them over.

Recording is off unless a ``recording()`` block is open. Off,
``span(name)`` returns one shared context manager that does nothing: no
clock read, no allocation, no CUDA call. On or off, a span never
synchronises the device, so what the device runs, and in what order, is
the same either way. While recording is on and a ``torch.profiler``
session is active, each span also opens a ``record_function`` range
named ``repro_torch.<name>`` (its C++ form, ``_RecordFunctionFast``,
which adds under a microsecond to either end), so the profiler's trace
holds the spans on the clock of the device activity.

``level()`` is the ``growth.level`` span of one level of a growth
loop: from the start of the level's work to the return of the host read
that learns the level's frontier, which runs as its child
``growth.sync`` (``with lv.sync(): ...``). A level with no such read
(the last one, at ``max_depth``) is marked unsynced. ``level(timed=True)``
times the level with recording off too; ``lv.seconds`` holds its
duration once the block has closed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Optional

import torch

PREFIX = "repro_torch."          # the profiler's name of a span is PREFIX + its name


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span. ``end_ns`` is 0 while it is open; ``synced`` is
    set on ``growth.level`` spans only."""
    id: int
    name: str
    parent: Optional[int]
    call: int
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    synced: Optional[bool] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """The spans recorded so far, in the order they opened."""

    def __init__(self):
        self.spans: list = []
        self._ids = itertools.count()
        self._calls = itertools.count()
        self._lock = threading.Lock()

    def drain(self) -> list:
        """The spans recorded so far; the recorder keeps none of them."""
        with self._lock:
            out, self.spans = self.spans, []
        return out

    def _open(self, name: str, stack: list) -> Span:
        parent = stack[-1] if stack else None
        s = Span(id=next(self._ids), name=name, parent=None if parent is None else parent.id,
                 call=next(self._calls) if parent is None else parent.call,
                 thread=threading.get_ident())
        with self._lock:
            self.spans.append(s)
        return s


_recorder: Optional[Recorder] = None
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The shared span of recording off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def sync(self):
        return self


OFF = _Off()


class _On:
    """An open span of recording on."""
    __slots__ = ("name", "rec", "span", "range", "stack", "start_ns", "end_ns")

    def __init__(self, name: str, rec: Optional[Recorder]):
        self.name, self.rec, self.span, self.range = name, rec, None, None

    def __enter__(self):
        if self.rec is not None:
            stack = self.stack = _stack()
            self.span = self.rec._open(self.name, stack)
            stack.append(self.span)
            if torch.autograd.profiler._is_profiler_enabled:
                self.range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
                self.range.__enter__()
        self.start_ns = time.perf_counter_ns()
        if self.span is not None:
            self.span.start_ns = self.start_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.span is not None:
            self.span.end_ns = self.end_ns
            self.stack.pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Level(_On):
    __slots__ = ("synced",)

    def __init__(self, rec: Optional[Recorder]):
        super().__init__("growth.level", rec)
        self.synced = False

    def sync(self):
        """The ``growth.sync`` span around the read that learns the level's frontier."""
        self.synced = True
        return span("growth.sync")

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.span is not None:
            self.span.synced = self.synced
        return False


def span(name: str):
    """A context manager that records ``name`` while recording is on."""
    rec = _recorder
    return OFF if rec is None else _On(name, rec)


def level(timed: bool = False):
    """The ``growth.level`` span of one level (see the module's docstring)."""
    rec = _recorder
    return OFF if rec is None and not timed else _Level(rec)


@contextlib.contextmanager
def recording():
    """Record spans inside the block; yields the ``Recorder``."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("tracing.recording() is already open")
    rec = _recorder = Recorder()
    try:
        yield rec
    finally:
        _recorder = None
