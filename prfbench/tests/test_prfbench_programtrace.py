"""The program-span phase (``prfbench/programtrace.py``): the reducer on
synthetic profiler events, the pairing of spans with their ranges, and a
phase on the CPU."""
import pytest
import torch

from prfbench import devtrace, programtrace

RANGES_THREAD, CALLS_THREAD = 1, 40321       # the profiler numbers the two apart


class _Event:
    def __init__(self, name, start, end, device=False, corr=0, thread=RANGES_THREAD):
        self._n, self._s, self._e, self._d, self._c, self._t = name, start, end, device, corr, thread

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


def _launch(name, at, start, end, corr):
    """A device operation and the runtime call that launched it."""
    return [_Event("cudaLaunchKernel", at, at + 1, corr=corr, thread=CALLS_THREAD),
            _Event(name, start, end, device=True, corr=corr)]


def _events():
    """Window [0, 100): fit [10, 90) > fit.growth [20, 60) > growth.level
    [25, 55) > growth.sync [50, 55). Busy [22, 50), [70, 80), [92, 95)."""
    ev = [_Event(devtrace.WINDOW, 0, 100),
          _Event("repro_torch.fit", 10, 90), _Event("repro_torch.fit.growth", 20, 60),
          _Event("repro_torch.growth.level", 25, 55), _Event("repro_torch.growth.sync", 50, 55),
          _Event("repro_torch.fit.growth", 20, 60, device=True),     # a device-side annotation
          _Event("aten::add", 21, 22, corr=7)]                       # a host op: not a launch
    ev += _launch("hist_kernel", 21, 22, 30, 7)          # launched in fit.growth
    ev += _launch("split_scan_kernel", 26, 30, 50, 8)    # in growth.level
    ev += _launch("Memcpy DtoH", 65, 70, 80, 9)          # in fit alone
    ev += _launch("argmax_kernel", 91, 92, 95, 10)       # after fit
    return ev


def test_idle_goes_to_the_innermost_open_span():
    tr = programtrace.reduce_program(_events())
    ns = {k: round(v * 1e9) for k, v in tr.idle_s.items()}
    assert ns == {programtrace.OUTSIDE: 10 + 2 + 5, "fit": 10 + 10 + 10, "fit.growth": 2 + 5,
                  "growth.sync": 5}
    assert round(tr.busy_s * 1e9) == 41 and round(tr.window_s * 1e9) == 100
    assert tr.covered_share() == pytest.approx((59 - 17 - 30) / 59)
    assert tr.outside_share() == pytest.approx(17 / 59)


def test_a_gap_under_no_span_is_outside():
    ev = [e for e in _events() if not e.name().startswith(programtrace.PROGRAM)]
    tr = programtrace.reduce_program(ev)
    assert tr.idle_s == {programtrace.OUTSIDE: pytest.approx(59e-9)}
    assert tr.launches == {programtrace.OUTSIDE: 4}
    assert tr.covered_share() == pytest.approx(0.0)


def test_launches_count_by_the_span_their_call_fell_in():
    tr = programtrace.reduce_program(_events())
    assert tr.launches == {"fit.growth": 2, "growth.level": 1, "fit": 3, programtrace.OUTSIDE: 1}
    assert tr.unmatched == 0
    lost = [e for e in _events() if not (e.name() == "cudaLaunchKernel" and e.start_ns() == 26)]
    assert programtrace.reduce_program(lost).unmatched == 1


def test_a_window_is_needed():
    with pytest.raises(RuntimeError):
        programtrace.reduce_program([e for e in _events() if e.name() != devtrace.WINDOW])


def _span(i, name, parent, start_ms, ms, synced=None):
    from repro_torch.tracing import Span

    return Span(id=i, name=name, parent=parent, call=0, thread=1, start_ns=int(start_ms * 1e6),
                end_ns=int((start_ms + ms) * 1e6), synced=synced)


def test_clock_gaps_pair_spans_and_ranges_in_order():
    spans = [_span(1, "fit.growth", 0, 0.02, 0.04), _span(0, "fit", None, 0.01, 0.08)]
    ranges = [("fit", 1, 10_000, 90_003), ("fit.growth", 1, 20_000, 59_990)]
    assert programtrace.clock_gaps_ns(spans, ranges) == [(10, "fit.growth"), (3, "fit")]
    assert programtrace.clock_gaps_ns(spans[:1], ranges) is None


def test_a_phase_on_the_cpu():
    """The profiled window of a phase holds the program's ranges, and the
    recorded spans pair with them."""
    from repro_torch import tracing

    def call():
        with tracing.span("predict"):
            with tracing.span("predict.vote"):
                return torch.ones(64).sum().item()

    outs, prog = programtrace.phase(tracing, call, 2, 3, "cpu")
    assert outs == [64.0] * 5
    assert [s.name for s in prog["profiled_spans"]] == ["predict", "predict.vote"] * 2
    assert [s.name for s in prog["spans"]] == ["predict", "predict.vote"] * 3
    tr = prog["trace"]
    assert [r[0] for r in tr.ranges] == ["predict", "predict.vote"] * 2
    gaps = programtrace.clock_gaps_ns(prog["profiled_spans"], tr.ranges)
    assert gaps is not None and len(gaps) == 4


def test_the_plain_calls_run_before_the_profiled_window():
    """Calls just after a profiler session run slow: the plain calls, whose
    spans are read as the program's times, come first."""
    from repro_torch import tracing

    n = iter(range(5))

    def call():
        with tracing.span("predict"):
            return next(n)

    outs, prog = programtrace.phase(tracing, call, 2, 3, "cpu")
    assert outs == [0, 1, 2, 3, 4]
    assert max(s.end_ns for s in prog["spans"]) < min(s.start_ns for s in prog["profiled_spans"])
    assert len(prog["spans"]) == 3 and len(prog["profiled_spans"]) == 2
