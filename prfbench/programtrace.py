"""The program's own spans (``repro_torch.tracing``) in a profiled window.

The traced runs of the benchmark time each stage from outside, in a
replay of the stage functions (``devtrace.Spans``). This module reads the
spans that the program records inside its real entry points instead:

* ``phase`` runs an entry point under the program's span recorder,
  ``plain_n`` calls without the profiler and then ``profiled_n`` inside
  one profiled window (calls just after a profiler session run slow, so
  the plain calls come first), and keeps the drained spans of each part;
* ``reduce_program`` reduces the profiled window by the program's spans,
  as the profiler recorded them (``repro_torch.<span>`` ranges on the
  host): the device's idle time under the innermost span open on the
  host, and the device operations whose launching call fell inside each
  span, matched by the profiler's correlation id;
* ``clock_gaps_ns`` pairs each recorded span with its profiler range, to
  show that the two share a clock.

``tools/program_spans.py`` runs the phase on a cell's inputs.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Optional

import torch

from prfbench import devtrace

PROGRAM = "repro_torch."          # the profiler's names of the program's spans
OUTSIDE = "outside"               # idle time and launches under no program span
CLOCK_GAP_NS = 20_000             # a span's recorded and profiled durations agree within this
LAUNCH_CALLS = ("cuda", "cuLaunch", "cuMemcpy", "cuMemset")   # host calls that launch device
                                                              # work (cuda* and cu* APIs)


@dataclasses.dataclass
class ProgramTrace:
    """A profiled window reduced by the program's spans.

    ``idle_s``: the device's idle seconds in the window, each moment given
    to the innermost program span open on the host then, or to
    ``OUTSIDE``. ``launches``: the device operations (kernels, copies,
    fills) whose launching call fell inside each span, its children's
    included; ``OUTSIDE`` those under none. ``unmatched``: operations
    whose launching call the trace does not hold. ``ranges``: (span,
    thread, start ns, end ns) of each range, in the order they opened."""
    idle_s: dict
    launches: dict
    unmatched: int
    ranges: list
    busy_s: float
    window_s: float

    def covered_share(self) -> Optional[float]:
        """The share of the window's idle time under a program span other
        than a call's root (a range with no parent)."""
        total = sum(self.idle_s.values())
        if total <= 0:
            return None
        roots = {r[0] for r, p in zip(self.ranges, _nest(self.ranges)) if p is None}
        return 1.0 - (self.idle_s.get(OUTSIDE, 0.0)
                      + sum(v for k, v in self.idle_s.items() if k in roots)) / total

    def outside_share(self) -> Optional[float]:
        total = sum(self.idle_s.values())
        return self.idle_s.get(OUTSIDE, 0.0) / total if total > 0 else None


def _nest(ranges) -> list:
    """The parent index of each range (None for a root): ranges of one
    thread nest, as the program's span stacks do."""
    parent, open_by_thread = [None] * len(ranges), defaultdict(list)
    for i, (_, thread, s, _t) in enumerate(ranges):
        stack = open_by_thread[thread]
        while stack and ranges[stack[-1]][3] <= s:
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    return parent


def _innermost(starts: list, order: list, ranges: list, parent: list, ns: int):
    """The index of the deepest of one thread's ranges open at ``ns``, or None."""
    j = bisect.bisect_right(starts, ns) - 1
    i = order[j] if j >= 0 else None
    while i is not None and ranges[i][3] <= ns:
        i = parent[i]
    return i


def reduce_program(events) -> ProgramTrace:
    """The ``ProgramTrace`` of a list of kineto events of one profiled window
    (``devtrace.WINDOW``).

    A launching call is matched to the range open at its start on any
    thread (the profiler numbers the threads of the program's ranges and
    of the runtime's calls apart); where ranges of several threads are
    open at once, the one that opened last takes the moment."""
    ranges, ops, calls, window = [], [], {}, None
    for e in events:
        name = e.name()
        if devtrace._is_device(e):
            if not (devtrace._is_annotation(e) or name.startswith(PROGRAM)):
                ops.append((devtrace._ns(e, "start"), devtrace._end_ns(e), e.correlation_id()))
        elif name == devtrace.WINDOW:
            window = (devtrace._ns(e, "start"), devtrace._end_ns(e))
        elif name.startswith(PROGRAM):
            ranges.append((name[len(PROGRAM):], e.start_thread_id(), devtrace._ns(e, "start"),
                           devtrace._end_ns(e)))
        elif name.startswith(LAUNCH_CALLS):
            calls[e.correlation_id()] = devtrace._ns(e, "start")
    if window is None:
        raise RuntimeError("the profiler's trace holds no window range")
    lo, hi = window
    ranges.sort(key=lambda r: (r[2], -r[3]))
    parent = _nest(ranges)
    by_thread = defaultdict(list)
    for i, r in enumerate(ranges):
        by_thread[r[1]].append(i)
    starts = {th: [ranges[i][2] for i in idx] for th, idx in by_thread.items()}

    def deepest(ns: int):
        found = [_innermost(starts[th], idx, ranges, parent, ns) for th, idx in by_thread.items()]
        return max((i for i in found if i is not None), key=lambda i: ranges[i][2], default=None)

    busy = devtrace._union([(max(s, lo), min(t, hi)) for s, t, _ in ops if t > lo and s < hi])
    idle, at = [], lo                                      # the window less its busy union
    for s, t in busy:
        if s > at:
            idle.append((at, s))
        at = max(at, t)
    if at < hi:
        idle.append((at, hi))
    idle_s = defaultdict(float)
    cuts = sorted({lo, hi} | {min(max(x, lo), hi) for r in ranges for x in r[2:]})
    for a, b in zip(cuts, cuts[1:]):                       # the open ranges hold on [a, b)
        gap = devtrace._overlap(idle, a, b)
        if gap > 0:
            i = deepest(a)
            idle_s[OUTSIDE if i is None else ranges[i][0]] += gap / 1e9

    launches, unmatched = defaultdict(int), 0
    for _, _, corr in ops:
        if corr not in calls:
            unmatched += 1
            continue
        i = deepest(calls[corr])
        if i is None:
            launches[OUTSIDE] += 1
        while i is not None:
            launches[ranges[i][0]] += 1
            i = parent[i]
    return ProgramTrace(idle_s=dict(idle_s), launches=dict(launches), unmatched=unmatched,
                        ranges=ranges, busy_s=devtrace._overlap(busy, lo, hi) / 1e9,
                        window_s=(hi - lo) / 1e9)


def _window_events(fn, dev):
    """(fn(), kineto events): ``fn`` under the profiler, inside one window
    range that ends in a synchronise, as ``devtrace.profiled``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    devtrace.sync(dev)
    with profile(activities=acts) as prof:
        time.sleep(devtrace.MARGIN_S)
        with torch.profiler.record_function(devtrace.WINDOW):
            out = fn()
            devtrace.sync(dev)
        time.sleep(devtrace.MARGIN_S)
    return out, prof.profiler.kineto_results.events()


def phase(tracing, fn, profiled_n: int, plain_n: int, dev):
    """The entry point ``fn`` under the program's span recorder
    (``tracing.recording()``): ``plain_n`` calls without the profiler, then
    ``profiled_n`` calls in one profiled window. Returns (the calls'
    outputs, the phase: the drained spans of the plain calls and of the
    profiled ones, and the window's ``ProgramTrace``)."""
    with tracing.recording() as rec:
        outs = [fn() for _ in range(plain_n)]
        spans = rec.drain()
        profiled, events = _window_events(lambda: [fn() for _ in range(profiled_n)], dev)
        profiled_spans = rec.drain()
    return outs + profiled, {"spans": spans, "profiled_spans": profiled_spans,
                             "trace": reduce_program(events)}


def clock_gaps_ns(spans: list, ranges: list) -> Optional[list]:
    """(gap ns, span) of each recorded span: the gap between its duration and
    its range's in the profiler's trace, the two matched in the order they
    opened, widest first; None when the two do not hold the same spans."""
    rec = sorted(spans, key=lambda s: s.start_ns)
    if [s.name for s in rec] != [r[0] for r in ranges]:
        return None
    return sorted(((abs((s.end_ns - s.start_ns) - (r[3] - r[2])), s.name)
                   for s, r in zip(rec, ranges)), reverse=True)
