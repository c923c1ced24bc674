"""Spans from the benchmark's own files, the device trace of a traced run, the device's peak.

``Spans`` times the stages a traced run replays: each stage starts and
ends in a device synchronise, is measured on the host's clock and is
marked in the profiler's trace by a ``record_function`` range named
``prfbench.stage.<name>``. ``profiled`` runs a function under
``torch.profiler`` and reduces the trace to what the per-layer metrics
read: device time and launches by kernel name, the union of device
activity inside the traced window (its busy seconds), the idle device
time under each host stage, and the operations that took most time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import re
import time
from collections import defaultdict

import torch

STAGE = "prfbench.stage."
WINDOW = "prfbench.window"
MARGIN_S = 0.05          # the profiler keeps device activity inside its window only: open it early
TOP = 10                 # entries of each breakdown list
NAME_CHARS = 160         # a kernel's name is cut to this in the breakdown


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(dev) -> int:
    """The device's allocation peak since the last reset (0 off the card)."""
    return torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0


def reset_peak(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def report_window(what: str, seconds: list) -> None:
    """One line on standard error about the window's jobs: their count and
    host-clock quantiles, for the reader of a run's log."""
    import statistics
    import sys

    ms = sorted(1000.0 * s for s in seconds)
    q = statistics.quantiles(ms, n=10) if len(ms) > 1 else ms * 9
    print(f"window: {len(ms)} {what}, ms p10 {q[0]:.3f} p50 {statistics.median(ms):.3f} "
          f"p90 {q[-1]:.3f} max {ms[-1]:.3f}", file=sys.stderr, flush=True)


def release(dev) -> None:
    """Hand freed blocks back, so the reference that runs next finds room."""
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


class Spans:
    """Host-clock seconds of each stage, in the order the stages ran."""

    def __init__(self, dev):
        self.dev = dev
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        sync(self.dev)
        t0 = time.perf_counter()
        with torch.profiler.record_function(STAGE + name):
            yield
            sync(self.dev)
        self.seconds[name].append(time.perf_counter() - t0)


@dataclasses.dataclass
class Trace:
    """What a profiled window left: per kernel name (launches, device
    seconds), busy and window seconds, idle seconds per host stage."""
    kernels: dict
    busy_s: float
    window_s: float
    idle_by_stage: dict

    def kernel_time(self, patterns) -> tuple:
        """(launches, device seconds) of the kernels whose name matches any pattern."""
        n, s = 0, 0.0
        for name, (count, secs) in self.kernels.items():
            if any(re.search(p, name) for p in patterns):
                n += count
                s += secs
        return n, s

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.idle_by_stage.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name[:NAME_CHARS], secs] for name, (_, secs) in ops],
                "idle_gaps": [[name, secs] for name, secs in gaps]}


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def _end_ns(e) -> int:
    fn = getattr(e, "end_ns", None)
    if fn is not None:
        return int(fn())
    return _ns(e, "start") + _ns(e, "duration")


def _is_device(e) -> bool:
    return str(e.device_type()).upper().endswith("CUDA")


def _is_annotation(e) -> bool:
    act = getattr(e, "activity_type", None)
    return "annotation" in str(act() if callable(act) else act).lower() or \
        e.name().startswith("prfbench.")


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a: list, lo: int, hi: int) -> int:
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in a)


def reduce_events(events) -> Trace:
    """The ``Trace`` of a list of kineto events of one profiled window."""
    kernels = defaultdict(lambda: [0, 0.0])
    device, stages, window = [], [], None
    for e in events:
        name = e.name()
        if _is_device(e):
            if _is_annotation(e):
                continue
            s, t = _ns(e, "start"), _end_ns(e)
            kernels[name][0] += 1
            kernels[name][1] += (t - s) / 1e9
            device.append((s, t))
        elif name == WINDOW:
            window = (_ns(e, "start"), _end_ns(e))
        elif name.startswith(STAGE):
            stages.append((name[len(STAGE):], _ns(e, "start"), _end_ns(e)))
    if window is None:
        raise RuntimeError("the profiler's trace holds no window range")
    lo, hi = window
    busy = _union([(max(s, lo), min(t, hi)) for s, t in device if t > lo and s < hi])
    busy_s = _overlap(busy, lo, hi)
    idle = defaultdict(float)
    for name, s, t in stages:                   # the replay's stages do not overlap
        s, t = max(s, lo), min(t, hi)
        if t > s:
            idle[name] += ((t - s) - _overlap(busy, s, t)) / 1e9
    between = ((hi - lo) - busy_s) / 1e9 - sum(idle.values())
    if between > 0:
        idle["between stages"] = between
    return Trace(kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                 busy_s=busy_s / 1e9, window_s=(hi - lo) / 1e9,
                 idle_by_stage=dict(idle))


def profiled(fn, dev):
    """(fn(), Trace): ``fn`` under the profiler, inside one window range
    that ends in a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with profile(activities=acts) as prof:
        time.sleep(MARGIN_S)
        with torch.profiler.record_function(WINDOW):
            out = fn()
            sync(dev)
        time.sleep(MARGIN_S)
    return out, reduce_events(prof.profiler.kineto_results.events())
