"""The port's span recorder (``repro_torch.tracing``) on the CPU.

* Off, ``span`` and ``level`` hand out one shared no-op and nothing is
  recorded; ``level(timed=True)`` still times its level.
* Spans nest: parents, one call id a root, a stack per thread.
* Under ``torch.profiler`` each span is one ``repro_torch.<span>`` range,
  in the order the spans opened.
* ``fit_prf_from_draws`` and ``PRFModel.predict`` record their span trees,
  and recording on changes no output bit.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import ForestConfig, fit_prf_from_draws, tracing
from repro_torch.core import engine
from repro_torch.core.types import Forest

N, F, K = 600, 6, 4
CFG = ForestConfig(n_trees=K, max_depth=8, n_bins=16, n_classes=3, tree_chunk=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread: the suite's workers share the machine's cores, and a
    tiny forest gains nothing from more (it grew 80x slower oversubscribed)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 4, size=(N, F)).astype(np.float32)
    y = (x[:, 0] + x[:, 1]).astype(np.int64) % 3          # pure leaves before max_depth
    w = torch.from_numpy(rng.poisson(1.0, size=(K, N)).astype(np.float32))
    u = torch.from_numpy(rng.random((K, F), dtype=np.float32))
    return x, y, w, u


def _tree(spans):
    """(name, [children...]) of each root, children in the order they opened."""
    kids = {s.id: [] for s in spans}
    roots = []
    for s in spans:
        (roots if s.parent is None else kids[s.parent]).append(s)

    def walk(s):
        return (s.name, [walk(c) for c in kids[s.id]])
    return [walk(r) for r in roots]


def test_off_records_nothing_and_hands_out_one_noop():
    assert tracing.span("fit") is tracing.OFF and tracing.span("predict") is tracing.OFF
    assert tracing.level() is tracing.OFF and tracing.OFF.sync() is tracing.OFF
    with tracing.span("fit") as s:
        assert s is tracing.OFF
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    assert rec.drain() == [] and tracing.span("fit") is tracing.OFF


def test_a_timed_level_has_its_seconds_with_recording_off():
    with tracing.level(timed=True) as lv:
        with lv.sync() as sync:
            assert sync is tracing.OFF
            time.sleep(0.002)
    assert lv is not tracing.OFF and lv.seconds >= 0.002


def test_nesting_parents_and_call_ids():
    with tracing.recording() as rec:
        for _ in range(2):
            with tracing.span("fit"):
                with tracing.span("fit.growth"):
                    for last in (False, True):
                        with tracing.level() as lv:
                            if not last:
                                with lv.sync():
                                    pass
        spans = rec.drain()
        assert rec.drain() == []
    assert [s.name for s in spans] == ["fit", "fit.growth", "growth.level", "growth.sync",
                                      "growth.level"] * 2
    by = {s.id: s for s in spans}
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.parent is not None:
            p = by[s.parent]
            assert p.call == s.call and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert [s.call for s in spans if s.parent is None] == [spans[0].call, spans[5].call]
    assert spans[0].call != spans[5].call
    assert [s.synced for s in spans if s.name == "growth.level"] == [True, False] * 2
    assert _tree(spans[:5]) == [("fit", [("fit.growth", [("growth.level", [("growth.sync", [])]),
                                                        ("growth.level", [])])])]


def test_each_thread_keeps_its_own_stack():
    both = threading.Barrier(2, timeout=10)

    def work(tag):
        with tracing.span(f"root.{tag}"):
            both.wait()                     # both roots open at once
            with tracing.span(f"child.{tag}"):
                both.wait()

    with tracing.recording() as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    spans = {s.name: s for s in rec.drain()}
    assert len(spans) == 4
    for tag in "ab":
        root, child = spans[f"root.{tag}"], spans[f"child.{tag}"]
        assert root.parent is None and child.parent == root.id
        assert child.call == root.call and child.thread == root.thread
    assert spans["root.a"].call != spans["root.b"].call


def test_many_threads_lose_no_span_while_draining():
    """More threads than cores record while the main thread drains: every
    span comes out once, under its own thread's root."""
    n_threads, n_calls = 24, 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            def work():
                for _ in range(n_calls):
                    with tracing.span("fit"):
                        with tracing.span("fit.growth"):
                            pass

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            got = []
            while any(t.is_alive() for t in threads):
                got += rec.drain()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            got += rec.drain()
    finally:
        sys.setswitchinterval(switch)
    assert len(got) == 2 * n_threads * n_calls
    assert len({s.id for s in got}) == len(got)
    by = {s.id: s for s in got}
    for s in got:
        if s.name == "fit":
            assert s.parent is None
        else:
            root = by[s.parent]
            assert root.name == "fit" and (root.thread, root.call) == (s.thread, s.call)
    assert len({s.call for s in got}) == n_threads * n_calls


def test_spans_are_profiler_ranges_in_order():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            with tracing.span("fit"):
                for name in ("fit.binning", "fit.growth"):
                    with tracing.span(name):
                        torch.ones(4).sum()
    with tracing.span("predict"):           # off: no range
        torch.ones(4).sum()
    ranges = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(tracing.PREFIX))
    assert [n for _, n in ranges] == ["repro_torch.fit", "repro_torch.fit.binning",
                                      "repro_torch.fit.growth"]
    assert [s.name for s in rec.drain()] == ["fit", "fit.binning", "fit.growth"]


@pytest.fixture(scope="module")
def fitted():
    x, y, w, u = _data()
    plain = fit_prf_from_draws(x, y, CFG, w, u, device="cpu")
    labels = plain.predict(x)
    with tracing.recording() as rec:
        model = fit_prf_from_draws(x, y, CFG, w, u, device="cpu")
        fit_spans = rec.drain()
        got = model.predict(x)
        predict_spans = rec.drain()
    return plain, labels, model, got, fit_spans, predict_spans


def test_fit_records_its_span_tree(fitted):
    _, _, model, _, spans, _ = fitted
    L = engine.levels_run(model.forest)
    assert 1 < L < CFG.max_depth                        # the last level ends in its read
    level = ("growth.level", [("growth.sync", [])])
    assert _tree(spans) == [("fit", [
        ("fit.validation", []),
        ("fit.binning", [("binning.fit", []), ("binning.copy", []), ("binning.digitize", [])]),
        ("fit.dimred", []),
        ("fit.growth", [level] * L),
        ("fit.oob", []),
    ])]
    assert len({s.call for s in spans}) == 1
    assert all(s.synced for s in spans if s.name == "growth.level")


def test_predict_records_its_span_tree(fitted):
    *_, spans = fitted
    assert _tree(spans) == [("predict", [
        ("predict.to_bins", [("binning.copy", []), ("binning.digitize", [])]),
        ("predict.vote", []),
        ("predict.to_host", []),
    ])]


def test_recording_changes_no_output_bit(fitted):
    plain, labels, model, got, _, _ = fitted
    for name in Forest.FIELDS:
        assert torch.equal(getattr(plain.forest, name), getattr(model.forest, name)), name
    assert np.array_equal(plain.bin_edges, model.bin_edges)
    assert np.array_equal(labels, got)


def test_a_level_that_ends_at_max_depth_is_unsynced():
    from repro_torch.core.forest import grow_forest

    x, y, w, _ = _data()
    xb = np.digitize(x, np.linspace(-2, 2, 15)).astype(np.uint8)
    cfg = ForestConfig(n_trees=K, max_depth=2, n_bins=16, n_classes=3)
    with tracing.recording() as rec:
        forest = grow_forest(xb, y, w, cfg, device="cpu")
    spans = rec.drain()
    assert engine.levels_run(forest) == 2
    assert [(s.name, s.synced) for s in spans] == [
        ("growth.level", True), ("growth.sync", None), ("growth.level", False)]


def test_the_streamed_levels_s_are_its_level_spans():
    """One system: ``stats["levels_s"]`` holds the seconds of the streamed
    trainer's ``growth.level`` spans, and its last level, at
    ``max_depth``, is unsynced as the resident one."""
    from repro_torch.core.api import grow_forest_streamed

    x, y, w, _ = _data()
    xb = np.digitize(x, np.linspace(-2, 2, 15)).astype(np.uint8)
    cfg = ForestConfig(n_trees=K, max_depth=2, n_bins=16, n_classes=3, sample_block=256)
    stats = {}
    with tracing.recording() as rec:
        grow_forest_streamed(xb, y, w.numpy(), cfg, prefetch=0, device="cpu", stats=stats)
    levels = [s for s in rec.drain() if s.name == "growth.level"]
    assert [s.synced for s in levels] == [True, False]
    assert stats["levels_s"] == [s.seconds for s in levels]
    off = {}
    grow_forest_streamed(xb, y, w.numpy(), cfg, prefetch=0, device="cpu", stats=off)
    assert len(off["levels_s"]) == 2 and min(off["levels_s"]) > 0
