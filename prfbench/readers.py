"""Arithmetic shared by the per-layer readers in ``metrics/``.

A reader returns None when its run has nothing for it to read (no
untraced replay, no device time for its kernels, or a trace that holds
fewer launches of its kernel than the program counted): the harness
then leaves the metric out of the line. A share is never made up.
"""
from __future__ import annotations

import statistics


def span_mean(rec, stage: str):
    """Mean host seconds of a stage over the untraced replays."""
    secs = rec.spans.get(stage)
    return statistics.fmean(secs) if secs else None


def roofline(rec, work_key: str, patterns, count_pattern: str, counter: str):
    """% of the device time of a layer's kernels (names matching ``patterns``)
    that the least time for its work would take, over the profiled replays."""
    w = rec.work.get(work_key)
    _, secs = rec.trace.kernel_time(patterns)
    held, _ = rec.trace.kernel_time([count_pattern])
    if w is None or secs <= 0 or held != rec.launches.get(counter):
        return None
    return 100.0 * w.scaled(rec.replays_traced).bound_s / secs


def idle_share(rec):
    """% of the traced window in which no operation ran on the device."""
    if rec.trace.window_s <= 0 or rec.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def mfu(rec, work_keys):
    """% of one replay's host seconds (the mean of the untraced replays)
    that the least time for all its counted work would take on the chip."""
    if not rec.walls or any(k not in rec.work for k in work_keys):
        return None
    return 100.0 * sum(rec.work[k].bound_s for k in work_keys) / statistics.fmean(rec.walls)
