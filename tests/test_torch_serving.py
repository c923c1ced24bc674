"""The port's PRF serving layer (``repro_torch.serving``) on the CPU.

* Every case of ``tests/test_serving.py`` on the port: bucketing at
  every batch size 1..33, the bounded bucket set, the queue's order and
  auto-drain, typed shedding, the circuit breaker, shutdown, the
  registry's hot-swap, bulkheads, fallback and cache invalidation,
  deadlines, rate limiting, ``health()`` and the result cache.
* Against ``repro``: a model trained by ``repro`` and carried over by
  ``convert.model_from_numpy``, served by both packages' ``PRFService``,
  gives identical labels at every batch size 1..33 and at 1024 and 1500
  rows (regression within ``tests/test_torch_regression.py``'s
  tolerance for ``predict_regression``); ``stats()`` and ``health()``
  have the reference's keys.
* The kernel path's logic (payload built once, the validity mask, Eq. 9's
  normalisation), run on the CPU by pointing the service's backend
  resolver at it; a failing forward pass is raised and recorded by the
  breaker, never answered by the plain path.
* ``make_sharded_vote_fn`` on a gloo world of 4 processes (spawned once
  for the module; rank program ``tests/torch_mesh_ranks.py:sharded_vote``)
  over meshes (4,) and (2, 2): labels equal to the single-device port's
  and to ``repro``'s, regression within the reference's rtol 1e-5, atol
  1e-6, and ``ValueError`` when the trees do not divide.
* ``kernels._build.library`` builds once when 8 threads ask together.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import ForestConfig, train_prf
from repro_torch.data.tabular import make_classification, make_regression, train_test_split
from repro_torch.serving import (
    CircuitBreaker, CircuitOpenError, DeadlineExceeded, ModelRegistry, PRFService, RateLimited,
    RateLimiter, ServiceClosedError, ServiceError, ServiceOverloaded, bucket_size,
)
from repro_torch.serving import prf_service

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _train(x, y, cfg, seed):
    return train_prf(x, y, cfg, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def served_model():
    x, y = make_classification(n_samples=900, n_features=12, n_classes=3, seed=8)
    xtr, ytr, xte, _ = train_test_split(x, y, 0.25, 0)
    cfg = ForestConfig(n_trees=8, max_depth=4, n_bins=16, n_classes=3, feature_mode="all")
    return _train(xtr, ytr, cfg, 0), xte


def test_bucket_size():
    assert [bucket_size(n) for n in (1, 7, 8, 9, 16, 17)] == [8, 8, 8, 16, 16, 32]
    assert bucket_size(5000, max_batch=1024) == 1024
    assert bucket_size(3, min_bucket=4) == 4
    with pytest.raises(ValueError):
        bucket_size(0)


def test_service_rejects_non_power_of_two_buckets(served_model):
    model, _ = served_model
    with pytest.raises(ValueError):
        PRFService(model, max_batch=100)
    with pytest.raises(ValueError):
        PRFService(model, min_bucket=6)


def test_bucketing_correct_at_every_batch_size(served_model):
    """Batch sizes 1..33: every bucket boundary and both sides of it; the
    padding never leaks into real rows, and only power-of-two buckets run."""
    model, xte = served_model
    svc = PRFService(model, max_batch=32, min_bucket=8)
    for n in range(1, 34):
        np.testing.assert_array_equal(svc.predict(xte[:n]), model.predict(xte[:n]),
                                      err_msg=f"batch size {n}")
    stats = svc.stats()
    assert set(stats["buckets_compiled"]) <= {8, 16, 32}
    assert len(stats["buckets_compiled"]) <= stats["max_buckets"]


def test_bucketing_correct_regression():
    x, y = make_regression(600, 8, seed=6)
    xtr, ytr, xte, _ = train_test_split(x, y, 0.25, 0)
    cfg = ForestConfig(n_trees=6, max_depth=4, n_bins=16, regression=True, feature_mode="all")
    model = _train(xtr, ytr, cfg, 0)
    svc = PRFService(model, max_batch=64, min_bucket=8)
    for n in (1, 5, 9, 33):
        np.testing.assert_allclose(svc.predict(xte[:n]), model.predict(xte[:n]), rtol=1e-6, atol=1e-6)


def test_single_sample_shape(served_model):
    model, xte = served_model
    svc = PRFService(model)
    got = svc.predict(xte[0])
    assert np.ndim(got) == 0
    assert got == model.predict(xte[:1])[0]


def test_queue_drain_preserves_request_order(served_model):
    model, xte = served_model
    svc = PRFService(model, max_batch=256)
    sizes = [3, 1, 7, 2, 5]
    futs, offsets = [], []
    off = 0
    for n in sizes:
        futs.append(svc.submit(xte[off:off + n]))
        offsets.append(off)
        off += n
    assert svc.pending == len(sizes)
    assert all(not f.done() for f in futs)
    with pytest.raises(RuntimeError):
        futs[0].result()
    assert svc.drain() == len(sizes)
    assert svc.pending == 0
    want = model.predict(xte[:off])
    for n, off0, fut in zip(sizes, offsets, futs):
        np.testing.assert_array_equal(fut.result(), want[off0:off0 + n])


def test_queue_auto_drains_at_max_batch(served_model):
    model, xte = served_model
    svc = PRFService(model, max_batch=8, min_bucket=8)
    futs = [svc.submit(xte[i:i + 4]) for i in range(0, 12, 4)]
    # the second submit reached max_batch=8 rows: those two auto-drained
    assert futs[0].done() and futs[1].done() and not futs[2].done()
    assert svc.pending == 1
    assert svc.drain() == 1
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(), model.predict(xte[4 * i:4 * i + 4]))


def test_drain_empty_queue_is_noop(served_model):
    model, _ = served_model
    assert PRFService(model).drain() == 0


def test_submit_rejects_malformed_requests(served_model):
    model, _ = served_model
    svc = PRFService(model)
    with pytest.raises(ValueError):
        svc.submit(np.empty((0, 12)))
    with pytest.raises(ValueError):
        svc.submit(np.zeros((2, 99)))
    with pytest.raises(ValueError):
        svc.predict(np.zeros((2, 3, 4)))
    assert svc.pending == 0


def test_failed_drain_keeps_requests_queued(served_model, monkeypatch):
    model, xte = served_model
    svc = PRFService(model, max_batch=256)
    good = svc.submit(xte[:3])
    calls = {"n": 0}
    real_predict = PRFService.predict

    def flaky(self, x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device failure")
        return real_predict(self, x)

    monkeypatch.setattr(PRFService, "predict", flaky)
    with pytest.raises(RuntimeError):
        svc.drain()
    assert svc.pending == 1 and not good.done()
    assert svc.drain() == 1
    np.testing.assert_array_equal(good.result(), model.predict(xte[:3]))


# ---------------------------------------------------------------------------
# Hardening: admission control, circuit breaker, shutdown, hot-swap
# ---------------------------------------------------------------------------


def _flaky_bucketed(monkeypatch, fail_when):
    """The forward pass inside the breaker's bracket fails while ``fail_when()``."""
    real = PRFService._predict_bucketed

    def patched(self, xb):
        if fail_when():
            raise RuntimeError("injected model failure")
        return real(self, xb)

    monkeypatch.setattr(PRFService, "_predict_bucketed", patched)


def test_overload_sheds_with_typed_error(served_model):
    model, xte = served_model
    svc = PRFService(model, max_batch=64, max_queue_rows=10)
    fut = svc.submit(xte[:6])
    with pytest.raises(ServiceOverloaded):
        svc.submit(xte[:6])
    with pytest.raises(ServiceError):
        svc.submit(xte[:5])
    assert svc.pending == 1
    svc.submit(xte[6:10])
    svc.drain()
    np.testing.assert_array_equal(fut.result(), model.predict(xte[:6]))
    assert svc.stats()["requests_shed"] == 2


def test_circuit_breaker_opens_sheds_and_recovers(served_model, monkeypatch):
    model, xte = served_model
    now = [0.0]
    br = CircuitBreaker(failure_threshold=2, reset_timeout=5.0, clock=lambda: now[0])
    svc = PRFService(model, max_batch=64, breaker=br)
    broken = [True]
    _flaky_bucketed(monkeypatch, lambda: broken[0])
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected model failure"):
            svc.predict(xte[:4])
    assert br.state == "open"
    with pytest.raises(CircuitOpenError):
        svc.predict(xte[:4])
    with pytest.raises(CircuitOpenError):
        svc.submit(xte[:4])
    assert svc.stats()["requests_shed"] == 1
    now[0] = 6.0
    assert br.state == "half_open"
    broken[0] = False
    out = svc.predict(xte[:4])
    assert br.state == "closed"
    np.testing.assert_array_equal(out, model.predict(xte[:4]))


def test_circuit_breaker_failed_probe_reopens(served_model, monkeypatch):
    model, xte = served_model
    now = [0.0]
    br = CircuitBreaker(failure_threshold=1, reset_timeout=5.0, clock=lambda: now[0])
    svc = PRFService(model, max_batch=64, breaker=br)
    _flaky_bucketed(monkeypatch, lambda: True)
    with pytest.raises(RuntimeError):
        svc.predict(xte[:4])
    assert br.state == "open"
    now[0] = 6.0
    with pytest.raises(RuntimeError):
        svc.predict(xte[:4])
    assert br.state == "open"
    now[0] = 7.0
    with pytest.raises(CircuitOpenError):
        svc.predict(xte[:4])


def test_drain_keeps_queue_while_circuit_open(served_model, monkeypatch):
    model, xte = served_model
    svc = PRFService(model, max_batch=64,
                     breaker=CircuitBreaker(failure_threshold=1, reset_timeout=0.0))
    fut = svc.submit(xte[:3])
    broken = [True]
    _flaky_bucketed(monkeypatch, lambda: broken[0])
    with pytest.raises(RuntimeError):
        svc.drain()
    assert svc.pending == 1 and not fut.done()
    broken[0] = False
    assert svc.drain() == 1
    np.testing.assert_array_equal(fut.result(), model.predict(xte[:3]))


def test_shutdown_drains_pending_futures(served_model):
    model, xte = served_model
    svc = PRFService(model, max_batch=64)
    fa, fb = svc.submit(xte[0]), svc.submit(xte[1:4])
    assert svc.shutdown(drain=True) == 2
    assert fa.done() and fb.done()
    assert fa.exception() is None and fb.exception() is None
    np.testing.assert_array_equal(fb.result(), model.predict(xte[1:4]))
    with pytest.raises(ServiceClosedError):
        svc.submit(xte[:2])
    assert svc.shutdown() == 0
    np.testing.assert_array_equal(svc.predict(xte[:2]), model.predict(xte[:2]))


def test_shutdown_cancel_rejects_futures_deterministically(served_model):
    model, xte = served_model
    svc = PRFService(model, max_batch=64)
    fut = svc.submit(xte[:3])
    assert svc.shutdown(drain=False) == 1
    assert fut.done()
    assert isinstance(fut.exception(), ServiceClosedError)
    with pytest.raises(ServiceClosedError):
        fut.result()
    assert svc.stats()["requests_cancelled"] == 1


def test_registry_hot_swap_drops_zero_futures(served_model):
    model, xte = served_model
    x, y = make_classification(n_samples=900, n_features=12, n_classes=3, seed=9)
    model2 = _train(x, y, ForestConfig(n_trees=8, max_depth=4, n_bins=16, n_classes=3,
                                       feature_mode="all"), 1)
    reg = ModelRegistry(max_batch=256)
    with pytest.raises(ServiceClosedError):
        reg.predict(xte[:2])
    assert reg.publish(model) == 1 and reg.version == 1
    futs = [reg.submit(xte[i:i + 2]) for i in range(0, 10, 2)]
    assert reg.publish(model2) == 2 and reg.version == 2
    assert all(f.done() and f.exception() is None for f in futs), "hot swap dropped in-flight futures"
    for i, f in enumerate(futs):            # answered by the OLD model
        np.testing.assert_array_equal(f.result(), model.predict(xte[2 * i:2 * i + 2]))
    f_new = reg.submit(xte[:2])
    reg.drain()
    np.testing.assert_array_equal(f_new.result(), model2.predict(xte[:2]))


def test_registry_hot_swap_with_concurrent_submitter(served_model):
    model, xte = served_model
    reg = ModelRegistry(max_batch=256)
    reg.publish(model)
    futs, stop = [], threading.Event()

    def submitter():
        i = 0
        while not stop.is_set():
            try:
                futs.append(reg.submit(xte[i % 64:i % 64 + 2]))
            except ServiceClosedError:
                pass                        # raced the flip: typed
            i += 1

    t = threading.Thread(target=submitter)
    t.start()
    try:
        for _ in range(3):
            reg.publish(model)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    reg.drain()
    assert all(f.done() for f in futs), "swap left futures pending"
    assert all(f.exception() is None for f in futs)


def test_registry_versions_are_bulkheaded(served_model):
    model, xte = served_model
    reg = ModelRegistry(max_batch=64)
    reg.publish(model)
    old_breaker = reg.service.breaker
    for _ in range(5):
        old_breaker.record_failure()
    assert old_breaker.state == "open"
    reg.publish(model)
    assert reg.service.breaker.state == "closed"
    np.testing.assert_array_equal(reg.predict(xte[:4]), model.predict(xte[:4]))
    assert old_breaker.state == "open"
    stats = reg.stats()
    assert stats["version"] == 2 and stats["breaker_state"] == "closed"


# ---------------------------------------------------------------------------
# Degraded mode: deadlines, rate limiting, stale fallback, health
# ---------------------------------------------------------------------------


def test_rate_limiter_refill_and_per_client_isolation():
    now = [0.0]
    rl = RateLimiter(rate=1.0, burst=2, clock=lambda: now[0])
    assert rl.allow("a", n=2)
    assert not rl.allow("a", n=1)
    assert rl.allow("b", n=2)
    now[0] = 1.5
    assert rl.allow("a", n=1)
    assert not rl.allow("a", n=1)
    snap = rl.snapshot()
    assert snap["granted"] == 3 and snap["rejected"] == 2
    assert snap["clients"] == 2
    with pytest.raises(ValueError):
        RateLimiter(rate=0, burst=2)
    with pytest.raises(ValueError):
        RateLimiter(rate=1, burst=0.5)


def test_submit_deadline_rejects_stale_requests(served_model):
    model, xte = served_model
    now = [0.0]
    svc = PRFService(model, max_batch=256, clock=lambda: now[0])
    stale = svc.submit(xte[:3], deadline=5.0)
    fresh = svc.submit(xte[3:6])
    now[0] = 10.0
    assert svc.drain() == 2
    assert isinstance(stale.exception(), DeadlineExceeded)
    with pytest.raises(DeadlineExceeded):
        stale.result()
    np.testing.assert_array_equal(fresh.result(), model.predict(xte[3:6]))
    h = svc.health()
    assert h["deadline_exceeded"] == 1 and h["served"] == 1
    with pytest.raises(ValueError):
        svc.submit(xte[:2], deadline=0)
    with pytest.raises(ValueError):
        PRFService(model, default_deadline=-1)


def test_default_deadline_applies_to_every_submit(served_model):
    model, xte = served_model
    now = [0.0]
    svc = PRFService(model, max_batch=256, default_deadline=1.0, clock=lambda: now[0])
    fut = svc.submit(xte[:2])
    now[0] = 0.5
    ok = svc.submit(xte[2:4])
    now[0] = 1.2
    svc.drain()
    assert isinstance(fut.exception(), DeadlineExceeded)
    np.testing.assert_array_equal(ok.result(), model.predict(xte[2:4]))


def test_rate_limited_submit_is_typed_and_counted(served_model):
    model, xte = served_model
    now = [0.0]
    rl = RateLimiter(rate=1.0, burst=4, clock=lambda: now[0])
    svc = PRFService(model, max_batch=256, rate_limiter=rl, clock=lambda: now[0])
    fut = svc.submit(xte[:4], client="tenant-a")
    with pytest.raises(RateLimited):
        svc.submit(xte[:1], client="tenant-a")
    other = svc.submit(xte[4:6], client="tenant-b")
    assert svc.pending == 2
    svc.drain()
    np.testing.assert_array_equal(fut.result(), model.predict(xte[:4]))
    assert other.exception() is None
    h = svc.health()
    assert h["rate_limited"] == 1
    assert h["rate_limiter"]["rejected"] == 1
    assert svc.stats()["requests_rate_limited"] == 1


def test_health_snapshot_shape(served_model):
    from repro_torch.data.pipeline import QuarantineReport

    model, xte = served_model
    svc = PRFService(model, max_batch=64, max_queue_rows=100)
    svc.submit(xte[:3])
    h = svc.health()
    assert h["queue_requests"] == 1 and h["queue_rows"] == 3
    assert h["max_queue_rows"] == 100
    assert h["breaker"] == "closed" and not h["closed"]
    assert h["quarantined_blocks"] == 0
    assert "rate_limiter" not in h
    svc.drain()
    assert svc.health()["queue_requests"] == 0
    report = QuarantineReport(policy="quarantine", blocks_checked=4, quarantined=[2])
    qmodel = dataclasses.replace(model, quarantine=report)
    assert PRFService(qmodel).health()["quarantined_blocks"] == 1


def test_registry_falls_back_to_newest_healthy_retired(served_model):
    model, xte = served_model
    reg = ModelRegistry(max_batch=64)
    reg.publish(model)
    reg.publish(model)
    for _ in range(5):
        reg.service.breaker.record_failure()
    assert reg.service.breaker.state == "open"
    np.testing.assert_array_equal(reg.predict(xte[:6]), model.predict(xte[:6]))
    h = reg.health()
    assert h["fallback_served"] == 1
    assert h["version"] == 2
    assert h["retired"] == {1: "closed"}
    assert h["live"]["breaker"] == "open"


def test_registry_fallback_skips_open_retired_versions(served_model):
    model, xte = served_model
    reg = ModelRegistry(max_batch=64)
    reg.publish(model)
    svc1 = reg.service
    reg.publish(model)
    svc2 = reg.service
    reg.publish(model)
    for _ in range(5):
        reg.service.breaker.record_failure()
    for _ in range(5):
        svc2.breaker.record_failure()
    np.testing.assert_array_equal(reg.predict(xte[:4]), model.predict(xte[:4]))
    assert reg.health()["retired"] == {1: "closed", 2: "open"}
    assert reg.health()["fallback_served"] == 1
    for _ in range(5):
        svc1.breaker.record_failure()
    with pytest.raises(CircuitOpenError):
        reg.predict(xte[:4])


def test_registry_shutdown_releases_retired_versions(served_model):
    model, xte = served_model
    reg = ModelRegistry(max_batch=64)
    reg.publish(model)
    reg.publish(model)
    fut = reg.submit(xte[:3])
    assert reg.health()["retired"] == {1: "closed"}
    assert reg.shutdown(drain=True) == 1
    assert fut.exception() is None
    np.testing.assert_array_equal(fut.result(), model.predict(xte[:3]))
    assert reg.health()["retired"] == {}
    with pytest.raises(ServiceClosedError):
        reg.submit(xte[:2])


# ---------------------------------------------------------------------------
# Cache-aside result cache
# ---------------------------------------------------------------------------


def test_cache_hit_bitwise_identical_and_counted(served_model):
    model, xte = served_model
    svc = PRFService(model, cache_size=4)
    b = np.asarray(xte[:16])
    first = svc.predict(b)
    again = svc.predict(b.copy())
    np.testing.assert_array_equal(first, again)
    h = svc.health()
    assert (h["cache_hits"], h["cache_misses"], h["cache_entries"]) == (1, 1, 1)
    svc.predict(b[:8])
    svc.predict(np.asarray(xte[16:32]))
    assert svc.health()["cache_entries"] == 3
    assert svc.stats()["cache_misses"] == 3


def test_cache_lru_evicts_oldest_and_refreshes_on_hit(served_model):
    model, xte = served_model
    svc = PRFService(model, cache_size=2)
    a, b, c = (np.asarray(xte[i:i + 8]) for i in (0, 8, 16))
    svc.predict(a)
    svc.predict(b)
    svc.predict(a)
    svc.predict(c)
    h = svc.health()
    assert (h["cache_evictions"], h["cache_entries"]) == (1, 2)
    svc.predict(a)
    assert svc.health()["cache_hits"] == 2


def test_cache_disabled_by_default(served_model):
    model, xte = served_model
    svc = PRFService(model)
    svc.predict(np.asarray(xte[:8]))
    svc.predict(np.asarray(xte[:8]))
    h = svc.health()
    assert (h["cache_size"], h["cache_hits"], h["cache_misses"]) == (0, 0, 0)
    with pytest.raises(ValueError):
        PRFService(model, cache_size=-1)


def test_cache_serves_hot_rows_while_circuit_open(served_model):
    model, xte = served_model
    svc = PRFService(model, cache_size=4, breaker=CircuitBreaker(failure_threshold=1))
    hot = np.asarray(xte[:16])
    want = svc.predict(hot)
    svc.breaker.record_failure()
    assert svc.breaker.state == "open"
    np.testing.assert_array_equal(svc.predict(hot), want)
    with pytest.raises(CircuitOpenError):
        svc.predict(np.asarray(xte[16:32]))


def test_cache_immune_to_caller_mutation(served_model):
    model, xte = served_model
    svc = PRFService(model, cache_size=4)
    b = np.asarray(xte[:16])
    want = svc.predict(b).copy()
    svc.predict(b)[:] = -7
    b_bytes = b.tobytes()
    np.testing.assert_array_equal(svc.predict(b), want)
    assert b.tobytes() == b_bytes


def test_registry_hot_swap_invalidates_old_cache(served_model):
    model, xte = served_model
    reg = ModelRegistry(cache_size=4)
    reg.publish(model)
    old = reg.service
    reg.predict(np.asarray(xte[:16]))
    assert old.health()["cache_entries"] == 1
    reg.publish(model)
    assert old.health()["cache_entries"] == 0
    reg.predict(np.asarray(xte[:16]))
    h = reg.health()["live"]
    assert (h["cache_entries"], h["cache_hits"]) == (1, 0)


# ---------------------------------------------------------------------------
# Against repro: a carried model served by both packages
# ---------------------------------------------------------------------------


def _carry(jmodel):
    from repro_torch.convert import model_from_numpy
    from repro_torch.core.types import Forest

    arrays = {n: np.asarray(getattr(jmodel.forest, n)) for n in Forest.FIELDS}
    cfg = ForestConfig(**dataclasses.asdict(jmodel.forest.config))
    return model_from_numpy(arrays, jmodel.bin_edges, cfg, "cpu")


@pytest.fixture(scope="module")
def reference():
    """repro-trained models (the data and configs of ``tests/test_serving.py``'s
    sharded-vote case), their carried copies, 1500 rows each to serve (the
    test rows first) and the test rows binned by ``repro``."""
    import jax.numpy as jnp

    from repro.core import ForestConfig as JConfig
    from repro.core import train_prf as jtrain
    from repro.core.binning import apply_bins

    out = {}
    x, y = make_classification(n_samples=800, n_features=12, n_classes=3, seed=0)
    xr, yr = make_regression(800, 10, seed=1)
    for name, (xx, yy), kw, extra in (
            ("cls", (x, y), dict(n_classes=3), make_classification(1500, 12, n_classes=3, seed=10)[0]),
            ("reg", (xr, yr), dict(regression=True), make_regression(1500, 10, seed=7)[0])):
        xtr, ytr, xte, _ = train_test_split(xx, yy, 0.25, 0)
        jm = jtrain(xtr, ytr, JConfig(n_trees=16, max_depth=4, n_bins=16, feature_mode="all", **kw), 0)
        xb = np.array(apply_bins(jnp.asarray(xte), jnp.asarray(jm.bin_edges)))
        out[name] = (jm, _carry(jm), np.concatenate([xte, extra])[:1500], xb)
    return out


PARITY_SIZES = list(range(1, 34)) + [1024, 1500]


def test_carried_model_labels_equal_repro_service(reference):
    from repro.serving import PRFService as JService

    jmodel, tmodel, rows, _ = reference["cls"]
    jsvc, tsvc = JService(jmodel, max_batch=1024), PRFService(tmodel, max_batch=1024)
    for n in PARITY_SIZES:
        want = np.asarray(jsvc.predict(rows[:n]))
        got = tsvc.predict(rows[:n])
        np.testing.assert_array_equal(got, want, err_msg=f"batch size {n}")
        np.testing.assert_array_equal(got, tmodel.predict(rows[:n]), err_msg=f"batch size {n}")
    assert tsvc.stats()["buckets_compiled"] == jsvc.stats()["buckets_compiled"] == [8, 16, 32, 64,
                                                                                      512, 1024]


def test_carried_regression_values_close_to_repro_service(reference):
    from repro.serving import PRFService as JService

    jmodel, tmodel, rows, _ = reference["reg"]
    jsvc, tsvc = JService(jmodel, max_batch=1024), PRFService(tmodel, max_batch=1024)
    for n in (1, 5, 9, 33, 1024, 1500):
        want = np.asarray(jsvc.predict(rows[:n]))
        np.testing.assert_allclose(tsvc.predict(rows[:n]), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f"batch size {n}")


def test_stats_and_health_keys_equal_repro(reference):
    from repro.serving import ModelRegistry as JRegistry
    from repro.serving import PRFService as JService
    from repro.serving import RateLimiter as JLimiter

    jmodel, tmodel, rows, _ = reference["cls"]
    for kw in ({}, {"max_queue_rows": 64, "cache_size": 2}):
        jsvc = JService(jmodel, **kw, rate_limiter=JLimiter(10.0, 100))
        tsvc = PRFService(tmodel, **kw, rate_limiter=RateLimiter(10.0, 100))
        for svc in (jsvc, tsvc):
            svc.submit(rows[:3], client="a")
            svc.predict(rows[:5])
        assert tsvc.stats().keys() == jsvc.stats().keys()
        assert tsvc.health().keys() == jsvc.health().keys()
        assert tsvc.health()["rate_limiter"].keys() == jsvc.health()["rate_limiter"].keys()
        assert {k: v for k, v in tsvc.stats().items() if k != "buckets_compiled"} == \
            {k: v for k, v in jsvc.stats().items() if k != "buckets_compiled"}
    jreg, treg = JRegistry(max_batch=64), ModelRegistry(max_batch=64)
    assert treg.health().keys() == jreg.health().keys()
    jreg.publish(jmodel)
    treg.publish(tmodel)
    assert treg.stats().keys() == jreg.stats().keys()
    assert treg.health().keys() == jreg.health().keys()
    assert treg.health()["live"].keys() == jreg.health()["live"].keys()


# ---------------------------------------------------------------------------
# The kernel path's logic, and no fallback from a failing forward pass
# ---------------------------------------------------------------------------


def _on_kernel_path(monkeypatch, fused):
    """Resolve the service's backend to the traversal (``"pallas"``) on
    the CPU, with ``fused`` in place of ``fused_vote_scores``; the plain
    path's entry points fail the test if the service calls them."""
    monkeypatch.setattr(prf_service, "resolve_predict_backend", lambda backend, device: "pallas")
    monkeypatch.setattr(prf_service, "fused_vote_scores", fused)

    def plain(*a, **k):
        raise AssertionError("the service answered from the plain path")

    monkeypatch.setattr(prf_service, "predict_scores", plain)
    monkeypatch.setattr(prf_service, "predict_regression", plain)


@pytest.mark.parametrize("regression", [False, True], ids=["classification", "regression"])
def test_kernel_path_builds_payload_once_and_matches_predict(served_model, monkeypatch, regression):
    from repro_torch.core.forest import fused_vote_scores

    if regression:
        x, y = make_regression(600, 8, seed=6)
        xtr, ytr, xte, _ = train_test_split(x, y, 0.25, 0)
        model = _train(xtr, ytr, ForestConfig(n_trees=6, max_depth=4, n_bins=16, regression=True,
                                              feature_mode="all"), 0)
    else:
        model, xte = served_model
    payloads, builds = [], []
    real_build = prf_service.build_payload

    def counting_build(forest):
        builds.append(1)
        return real_build(forest)

    def fused(forest, xb, payload):
        payloads.append(payload)
        assert xb.shape[0] in (8, 16, 32, 64)          # only bucket shapes reach the traversal
        return fused_vote_scores(forest, xb, payload)

    monkeypatch.setattr(prf_service, "build_payload", counting_build)
    _on_kernel_path(monkeypatch, fused)
    svc = PRFService(model, max_batch=64)
    for n in (1, 7, 8, 9, 33, 64, 100):
        got = svc.predict(xte[:n])
        want = model.predict(xte[:n])
        if regression:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"batch size {n}")
    assert len(builds) == 1 and all(p is payloads[0] for p in payloads)
    assert len(payloads) == 8                                  # one traversal per bucket-chunk


def test_failing_forward_pass_is_raised_never_answered_by_the_plain_path(served_model, monkeypatch):
    model, xte = served_model

    def broken(forest, xb, payload):
        raise RuntimeError("prf_traverse: CUDA error 98 at launch")

    _on_kernel_path(monkeypatch, broken)
    svc = PRFService(model, breaker=CircuitBreaker(failure_threshold=2, reset_timeout=60.0))
    fut = svc.submit(xte[:3])
    for _ in range(2):
        with pytest.raises(RuntimeError, match="CUDA error"):
            svc.predict(xte[:5])
    assert svc.breaker.state == "open"
    with pytest.raises(CircuitOpenError):
        svc.drain()
    assert svc.pending == 1 and not fut.done()                 # kept, not answered
    reg = ModelRegistry()
    reg.publish(model)
    with pytest.raises(RuntimeError, match="CUDA error"):
        reg.predict(xte[:5])                                   # no fallback on a failure itself


def test_service_refuses_the_kernel_backend_for_a_cpu_model(served_model):
    model, _ = served_model
    with pytest.raises(ValueError):
        PRFService(model, backend="pallas")                    # the kernel needs CUDA tensors
    assert PRFService(model, backend="xla")._payload is None


def test_threads_submit_and_drain_concurrently(served_model):
    """12 threads (more than this machine's cores) submit 16 requests each
    (1-32 rows, seeded), auto-draining as they go, under a short switch
    interval: every future resolves to ``model.predict`` of its rows, and
    the served counter (a read-modify-write under the service's lock)
    loses no update."""
    model, xte = served_model
    svc = PRFService(model, max_batch=64)
    rng = np.random.default_rng(4)
    n_threads = 12
    plans = [[(int(o), int(n)) for o, n in zip(rng.integers(0, 190, 16), rng.integers(1, 33, 16))]
             for _ in range(n_threads)]
    results = [[] for _ in plans]

    def client(i):
        for o, n in plans[i]:
            results[i].append((o, n, svc.submit(xte[o:o + n])))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    svc.drain()
    assert sum(len(r) for r in results) == 16 * n_threads
    want = model.predict(xte)
    for r in results:
        for o, n, fut in r:
            np.testing.assert_array_equal(fut.result(), want[o:o + n])
    assert svc.stats()["requests_served"] == 16 * n_threads
    assert svc.pending == 0


# ---------------------------------------------------------------------------
# Tree-sharded voting on a gloo world of 4 processes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vote_world(reference):
    from repro.core.voting import predict, predict_regression
    from repro_torch.core.types import Forest
    from repro_torch.launch.mesh import run_world

    cases, want = {}, {}
    for name, fn in (("cls", predict), ("reg", predict_regression)):
        jm, _, _, xb = reference[name]
        arrays = {n: np.asarray(getattr(jm.forest, n)) for n in Forest.FIELDS}
        cases[name] = (arrays, dataclasses.asdict(jm.forest.config), xb)
        want[name] = np.asarray(fn(jm.forest, xb))
    arrays, cfg_kw, xb = cases["cls"]
    uneven = ({n: a[:15] for n, a in arrays.items()}, dict(cfg_kw, n_trees=15), xb)
    out = run_world("torch_mesh_ranks:sharded_vote", 4, args=(cases, uneven), timeout_s=240)
    return cases, want, out


def _single_device(cases, name):
    from repro_torch.convert import forest_from_numpy
    from repro_torch.core.voting import predict, predict_regression

    arrays, cfg_kw, xb = cases[name]
    forest = forest_from_numpy(arrays, ForestConfig(**cfg_kw), "cpu")
    fn = predict_regression if forest.config.regression else predict
    return fn(forest, torch.from_numpy(xb)).numpy()


VOTE_IDS = ["4-data", "2x2-data", "2x2-model"]
VOTE_KEYS = [((4,), "data"), ((2, 2), "data"), ((2, 2), "model")]


@pytest.mark.parametrize("shape,axis", VOTE_KEYS, ids=VOTE_IDS)
def test_sharded_vote_labels_equal_single_device_and_repro(vote_world, shape, axis):
    cases, want, out = vote_world
    single = _single_device(cases, "cls")
    np.testing.assert_array_equal(single, want["cls"])
    for r, rank in enumerate(out):
        np.testing.assert_array_equal(rank[shape, axis, "cls"], single, err_msg=f"rank {r}")


@pytest.mark.parametrize("shape,axis", VOTE_KEYS, ids=VOTE_IDS)
def test_sharded_vote_regression_close_to_single_device_and_repro(vote_world, shape, axis):
    cases, want, out = vote_world
    single = _single_device(cases, "reg")
    for r, rank in enumerate(out):
        got = rank[shape, axis, "reg"]
        np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got, want["reg"], rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("shape,axis", VOTE_KEYS, ids=VOTE_IDS)
def test_sharded_vote_refuses_trees_that_do_not_divide(vote_world, shape, axis):
    _, _, out = vote_world
    assert all(rank[shape, axis, "refused"] for rank in out)


# ---------------------------------------------------------------------------
# The kernel library is built once under concurrent first launches
# ---------------------------------------------------------------------------


def test_library_builds_once_under_eight_threads(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return tmp_path / _build.LIB_NAME

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    barrier = threading.Barrier(8)
    libs = []

    def first_launch():
        barrier.wait()
        libs.append(_build.library())

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(calls) == 1 and len(libs) == 8
    assert all(lib is libs[0] for lib in libs)


def test_import_hygiene_of_serving_and_baselines():
    code = ("import sys, repro_torch.serving, repro_torch.core.baselines\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'msgpack')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT, timeout=120)
