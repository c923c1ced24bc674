"""PRF serving layer — bucketed, batched, tree-sharded forest inference.

Counterpart of ``repro/serving/prf_service.py``. It turns a trained
:class:`repro_torch.core.api.PRFModel` into a serving endpoint on the
fused traversal+voting path (``ForestConfig.predict_backend``; on CUDA
``"auto"`` is the traversal kernel, ``csrc/tree_traverse.cu``):

* **Power-of-two batch bucketing** — request batches are padded up to
  the next power-of-two bucket (clamped to ``[min_bucket, max_batch]``)
  with an explicit validity mask, so at most
  ``log2(max_batch / min_bucket) + 1`` batch shapes ever reach the
  device. The reference compiles one ``jax.jit`` executable per bucket;
  here each bucket is an eager call, and ``stats()["buckets_compiled"]``
  (the reference's key) lists the bucket shapes served. Padded rows are
  masked out of the scores and sliced off; they can never leak into a
  real row (per-sample traversal is row-independent).

* **Async micro-batch queue** — ``submit()`` enqueues a request and
  returns a :class:`PRFFuture`; ``drain()`` aggregates everything
  pending into one bucketed forward pass and resolves the futures in
  submission order. ``submit`` auto-drains when the queue reaches
  ``max_batch`` rows. The forward pass runs outside the queue's lock, so
  several threads may submit and drain at once (and launch kernels).

* **Tree-sharded multi-process voting** — ``make_sharded_vote_fn``
  gives each rank of a ``launch.mesh.Mesh`` axis its share of the
  trees; each rank accumulates their weighted votes into an ``[N, C]``
  partial score and one ``all_reduce`` combines them (Eq. 9/10 is a sum
  over trees): O(N*C) words on the wire, never the ``[k, N, C]`` tensor.

* **Resilience** — overload is shed at admission with typed errors
  (``max_queue_rows`` -> :class:`ServiceOverloaded`); a per-service
  :class:`CircuitBreaker` opens after consecutive model failures and
  half-open-probes its way back; ``shutdown()`` settles every pending
  future; :class:`ModelRegistry` gives each published model version its
  own bulkheaded service and hot-swaps versions with an atomic pointer
  flip that drops zero in-flight futures. A failing forward pass (a
  kernel that does not build or launch) is recorded by the breaker and
  raised: the service never answers from another backend instead.

* **Cache-aside result cache** — an optional per-service LRU
  (``cache_size`` entries) keyed by a SHA-1 digest of the request batch;
  a hit returns the stored prediction bitwise with no device work, and
  is checked before the breaker.

* **Degraded mode** — per-request deadlines (:class:`DeadlineExceeded`,
  settled through the future at drain), a per-client token-bucket
  :class:`RateLimiter` (:class:`RateLimited`), the newest *healthy*
  retired version answering ``ModelRegistry.predict`` while the live
  breaker is open, and a flat ``health()`` snapshot.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.api import PRFModel
from ..core.binning import apply_bins
from ..core.forest import fused_vote_scores
from ..core.types import Forest
from ..core.voting import (
    _vote_weights, build_payload, predict_regression, predict_scores, resolve_predict_backend,
)
from ..device import as_tensor


def bucket_size(n: int, *, min_bucket: int = 8, max_batch: int = 1024) -> int:
    """Next power-of-two >= n, clamped to [min_bucket, max_batch]."""
    if n <= 0:
        raise ValueError(f"batch size must be positive, got {n}")
    b = 1 << max(0, n - 1).bit_length()
    return max(min_bucket, min(b, max_batch))


class ServiceError(RuntimeError):
    """Base class of the serving layer's typed rejections — a caller
    catching it handles every fast-shed path (overload, open circuit,
    shutdown) without also swallowing model or kernel failures."""


class ServiceOverloaded(ServiceError):
    """Admission control: the queue is at ``max_queue_rows``."""


class CircuitOpenError(ServiceError):
    """The service's circuit breaker is open (model keeps failing)."""


class ServiceClosedError(ServiceError):
    """The service was shut down (or the registry has no model)."""


class DeadlineExceeded(ServiceError):
    """The request's deadline expired before it was served. Settled
    through the normal future path at drain time — a late future is
    rejected, never silently dropped."""


class RateLimited(ServiceError):
    """The client's token bucket is empty (per-client rate limiting in
    front of admission control)."""


class RateLimiter:
    """Per-client token-bucket rate limiter.

    Each client id owns a bucket holding up to ``burst`` tokens that
    refills at ``rate`` tokens/second; a request for ``n`` rows is
    admitted iff ``n`` tokens are available (and consumes them). Tokens
    are charged per ROW, the currency of ``max_queue_rows``, so ``burst``
    must cover a client's largest single request. The refill is computed
    from the elapsed time at each call (no background thread); ``clock``
    is injectable so tests drive refills without sleeping.
    """

    def __init__(self, rate: float, burst: float, *,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/s, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1 token, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, Tuple[float, float]] = {}  # id -> (tokens, t)
        self.granted = 0
        self.rejected = 0

    def allow(self, client: str = "", n: float = 1.0) -> bool:
        """Take ``n`` tokens from ``client``'s bucket; False = shed."""
        now = self._clock()
        with self._lock:
            tokens, last = self._buckets.get(client, (self.burst, now))
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            if tokens >= n:
                self._buckets[client] = (tokens - n, now)
                self.granted += 1
                return True
            self._buckets[client] = (tokens, now)
            self.rejected += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rate": self.rate, "burst": self.burst,
                "clients": len(self._buckets),
                "granted": self.granted, "rejected": self.rejected,
            }


class CircuitBreaker:
    """Per-service circuit breaker with half-open probing.

    ``failure_threshold`` consecutive model failures open the circuit;
    while open, ``allow()`` is False (callers shed with
    :class:`CircuitOpenError` instead of running a broken model). After
    ``reset_timeout`` seconds ONE probe call is let through (half-open):
    success closes the circuit, failure re-opens it for another full
    timeout. ``clock`` is injectable.
    """

    def __init__(self, failure_threshold: int = 5, reset_timeout: float = 30.0, *,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout < 0:
            raise ValueError("reset_timeout must be >= 0")
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = "closed"
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        """"closed" | "open" | "half_open" (open, probe window reached).
        A peek — never consumes the half-open probe."""
        with self._lock:
            if self._state == "open" and self._clock() - self._opened_at >= self.reset_timeout:
                return "half_open"
            return self._state

    def allow(self) -> bool:
        """May a call proceed? Consumes the single half-open probe."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open" and self._clock() - self._opened_at >= self.reset_timeout:
                self._state = "half_open"        # this call IS the probe
                return True
            return False          # open, or a half-open probe in flight

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = "closed"

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open" or self._failures >= self.failure_threshold:
                self._state = "open"
                self._opened_at = self._clock()


class PRFFuture:
    """Result handle for a queued request (settled by ``drain`` /
    ``shutdown``): resolved with a value, or rejected with an exception
    that ``result()`` re-raises."""

    __slots__ = ("_value", "_exc", "_done")

    def __init__(self):
        self._value = None
        self._exc = None
        self._done = False

    def done(self) -> bool:
        return self._done

    def result(self) -> np.ndarray:
        if not self._done:
            raise RuntimeError("request not served yet — call drain()")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self) -> Optional[BaseException]:
        """The rejection, or None if resolved with a value."""
        if not self._done:
            raise RuntimeError("request not served yet — call drain()")
        return self._exc

    def _resolve(self, value: np.ndarray) -> None:
        self._value = value
        self._done = True

    def _reject(self, exc: BaseException) -> None:
        self._exc = exc
        self._done = True


class PRFService:
    """Serving wrapper around a trained PRF model, on the forest's device.

    >>> svc = PRFService(model)
    >>> labels = svc.predict(x)                  # any batch size
    >>> fut = svc.submit(x1); svc.submit(x2)     # micro-batch queue
    >>> svc.drain(); fut.result()
    """

    def __init__(
        self,
        model: PRFModel,
        *,
        max_batch: int = 1024,
        min_bucket: int = 8,
        backend: Optional[str] = None,
        max_queue_rows: Optional[int] = None,
        breaker: Optional[CircuitBreaker] = None,
        rate_limiter: Optional[RateLimiter] = None,
        default_deadline: Optional[float] = None,
        cache_size: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_batch & (max_batch - 1) or min_bucket & (min_bucket - 1):
            raise ValueError("max_batch and min_bucket must be powers of two")
        if min_bucket > max_batch:
            raise ValueError(f"min_bucket={min_bucket} must not exceed max_batch={max_batch}")
        if max_queue_rows is not None and max_queue_rows < 1:
            raise ValueError("max_queue_rows must be >= 1")
        if backend is not None:
            model = model.with_predict_backend(backend)
        self.model = model
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        # Admission control: queue depth past which submit() sheds with
        # ServiceOverloaded (None = unbounded).
        self.max_queue_rows = max_queue_rows
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # Degraded mode: a per-client token bucket sheds in front of the
        # queue-depth check, deadlines bound how stale a queued request gets.
        self.rate_limiter = rate_limiter
        if default_deadline is not None and default_deadline <= 0:
            raise ValueError("default_deadline must be > 0 seconds")
        self.default_deadline = default_deadline
        self._clock = clock
        forest = model.forest
        self._device = forest.device
        # apply_bins compares in float32: cast the edges once, not per request
        self._edges = torch.from_numpy(np.asarray(model.bin_edges)).to(self._device, torch.float32)
        self._n_features = int(np.asarray(model.bin_edges).shape[0])
        # One entry per request, under one lock: (x, single, future,
        # absolute deadline or None).
        self._queue: List[Tuple[np.ndarray, bool, PRFFuture, Optional[float]]] = []
        self._queued_rows = 0
        self._lock = threading.Lock()
        self._closed = False
        self._buckets_seen: set = set()
        # Cache-aside result cache: digest of the request batch -> its
        # prediction; entries are private copies.
        if cache_size < 0:
            raise ValueError(f"cache_size must be >= 0, got {cache_size}")
        self.cache_size = cache_size
        self._cache: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_evictions = 0
        self._requests_served = 0
        self._requests_shed = 0
        self._requests_cancelled = 0
        self._requests_deadline_exceeded = 0
        self._requests_rate_limited = 0

        # The payload depends only on the trained forest: built once, on
        # the forest's device, so a request does no O(k*P*C) work before
        # the traversal.
        self._forest = forest
        self._use_kernel = resolve_predict_backend(forest.config.predict_backend,
                                                   self._device) == "pallas"
        self._payload = build_payload(forest).contiguous() if self._use_kernel else None
        self._norm = torch.clamp_min(_vote_weights(forest).sum(), 1e-38)

    def _bucket_predict(self, xb: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """One bucket's labels (or values). The mask zeroes padded rows'
        scores before the argmax / normalisation, so a padded row can
        never carry a non-neutral value even if a caller forgets to slice."""
        forest = self._forest
        if forest.config.regression:
            if self._use_kernel:
                vals = fused_vote_scores(forest, xb, self._payload)[:, 0] / self._norm
            else:
                vals = predict_regression(forest, xb)
            return torch.where(valid, vals, 0.0)
        scores = (fused_vote_scores(forest, xb, self._payload) if self._use_kernel
                  else predict_scores(forest, xb))
        scores = torch.where(valid[:, None], scores, 0.0)
        return torch.argmax(scores, dim=-1)

    def _validate(self, x: np.ndarray) -> np.ndarray:
        """Shape-check a request up front: a malformed request fails at
        its own submit/predict call, never inside a micro-batch."""
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[None]
        if x.ndim != 2 or x.shape[1] != self._n_features:
            raise ValueError(f"expected [n, {self._n_features}] features, got {x.shape}")
        if len(x) == 0:
            raise ValueError("empty request")
        return x

    # -- cache-aside result cache ----------------------------------------

    @staticmethod
    def _cache_key(x: np.ndarray) -> bytes:
        h = hashlib.sha1()
        h.update(str(x.dtype).encode())
        h.update(np.asarray(x.shape, np.int64).tobytes())
        h.update(np.ascontiguousarray(x).tobytes())
        return h.digest()

    def _cache_get(self, key: bytes) -> Optional[np.ndarray]:
        with self._lock:
            out = self._cache.get(key)
            if out is None:
                self._cache_misses += 1
                return None
            self._cache.move_to_end(key)
            self._cache_hits += 1
            return out.copy()

    def _cache_put(self, key: bytes, out: np.ndarray) -> None:
        with self._lock:
            if key not in self._cache and len(self._cache) >= self.cache_size:
                self._cache.popitem(last=False)
                self._cache_evictions += 1
            self._cache[key] = out.copy()
            self._cache.move_to_end(key)

    def invalidate_cache(self) -> int:
        """Drop every cached prediction; returns how many were dropped.
        Called by :class:`ModelRegistry.publish` on the outgoing service."""
        with self._lock:
            n = len(self._cache)
            self._cache.clear()
            return n

    # -- direct (synchronous) path ---------------------------------------

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Predict labels/values for any batch size (bucketed + padded).

        The circuit breaker brackets the forward pass: while open it
        sheds with :class:`CircuitOpenError` before any device work;
        client-side ``ValueError`` / ``ServiceError`` never count as model
        failures, and any other failure (a kernel that does not build or
        launch) is recorded and re-raised. Stateless, so it stays usable
        after ``shutdown``. With ``cache_size > 0`` a cached batch is
        answered first, bitwise, before the breaker.
        """
        squeeze = np.ndim(x) == 1
        x = self._validate(x)
        key = self._cache_key(x) if self.cache_size > 0 else None
        if key is not None:
            hit = self._cache_get(key)
            if hit is not None:
                return hit[0] if squeeze else hit
        if not self.breaker.allow():
            raise CircuitOpenError(
                f"circuit open after repeated model failures; retrying in "
                f"<= {self.breaker.reset_timeout:g}s"
            )
        try:
            # bin once on the device; buckets are sliced and padded there
            xb = apply_bins(as_tensor(x, self._device), self._edges)
            outs = []
            for i in range(0, len(xb), self.max_batch):
                outs.append(self._predict_bucketed(xb[i:i + self.max_batch]))
            out = np.concatenate(outs, axis=0)
        except ServiceError:
            raise
        except Exception:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        if key is not None:
            self._cache_put(key, out)
        return out[0] if squeeze else out

    def _predict_bucketed(self, xb: torch.Tensor) -> np.ndarray:
        n = len(xb)
        b = bucket_size(n, min_bucket=self.min_bucket, max_batch=self.max_batch)
        self._buckets_seen.add(b)
        padded = xb if b == n else torch.cat([xb, xb.new_zeros((b - n, xb.shape[1]))])
        valid = torch.arange(b, device=xb.device) < n
        out = self._bucket_predict(padded, valid)
        return out[:n].cpu().numpy()          # one device-to-host copy per bucket

    # -- async micro-batch queue -----------------------------------------

    def submit(self, x: np.ndarray, *, client: str = "",
               deadline: Optional[float] = None) -> PRFFuture:
        """Enqueue a request; returns a future resolved by ``drain``.

        Auto-drains when the aggregated queue reaches ``max_batch`` rows.
        Admission is the fast-shed point: a shut-down service raises
        :class:`ServiceClosedError`, an open circuit
        :class:`CircuitOpenError`, a drained token bucket
        :class:`RateLimited` (per ``client``, charged by rows), and a
        queue at ``max_queue_rows`` :class:`ServiceOverloaded` — all
        before the request touches the queue. ``deadline`` (seconds from
        now; default ``default_deadline``) bounds queue staleness: a
        request still queued past it is settled with
        :class:`DeadlineExceeded` at the next drain.
        """
        single = np.ndim(x) == 1
        x = self._validate(x)
        if self.breaker.state == "open":
            with self._lock:
                self._requests_shed += 1
            raise CircuitOpenError("circuit open after repeated model failures; request shed")
        if self.rate_limiter is not None and not self.rate_limiter.allow(client, n=len(x)):
            with self._lock:
                self._requests_rate_limited += 1
            raise RateLimited(
                f"client {client!r} exceeded its token bucket "
                f"({self.rate_limiter.rate:g} rows/s, burst "
                f"{self.rate_limiter.burst:g}) — request of {len(x)} shed"
            )
        if deadline is None:
            deadline = self.default_deadline
        elif deadline <= 0:
            raise ValueError(f"deadline must be > 0 seconds, got {deadline}")
        expires = None if deadline is None else self._clock() + deadline
        fut = PRFFuture()
        with self._lock:
            if self._closed:
                raise ServiceClosedError("submit on a shut-down service")
            if self.max_queue_rows is not None and self._queued_rows + len(x) > self.max_queue_rows:
                self._requests_shed += 1
                raise ServiceOverloaded(
                    f"queue full: {self._queued_rows} rows pending, request "
                    f"of {len(x)} exceeds max_queue_rows={self.max_queue_rows}"
                )
            self._queue.append((x, single, fut, expires))
            self._queued_rows += len(x)
            full = self._queued_rows >= self.max_batch
        if full:
            self.drain()
        return fut

    @property
    def pending(self) -> int:
        """Number of queued (unserved) requests."""
        return len(self._queue)

    def drain(self) -> int:
        """Settle every queued request: expired deadlines are rejected
        (:class:`DeadlineExceeded`), the rest served in one aggregated
        micro-batch, futures resolved in submission order. Returns the
        number of requests settled (served + deadline-rejected).

        The queue is snapshotted and cleared under the lock and the
        forward pass runs outside it, so concurrent submits gather into
        the next batch; on failure the snapshot is put back in front."""
        with self._lock:
            if not self._queue:
                return 0
            queue = self._queue
            self._queue, self._queued_rows = [], 0
        now = self._clock()
        live = [e for e in queue if e[3] is None or now <= e[3]]
        expired = [e for e in queue if not (e[3] is None or now <= e[3])]
        for (_, _, fut, dl) in expired:
            fut._reject(DeadlineExceeded(
                f"request expired {now - dl:.3f}s past its deadline while queued — shed at drain"
            ))
        if expired:
            with self._lock:
                self._requests_deadline_exceeded += len(expired)
        if not live:
            return len(expired)
        try:
            out = self.predict(np.concatenate([x for x, _, _, _ in live]))
        except Exception:
            with self._lock:
                self._queue = live + self._queue
                self._queued_rows += sum(len(x) for x, _, _, _ in live)
            raise
        offset = 0
        for (x, single, fut, _) in live:
            chunk = out[offset:offset + len(x)]
            fut._resolve(chunk[0] if single else chunk)
            offset += len(x)
        with self._lock:
            self._requests_served += len(live)
        return len(live) + len(expired)

    def shutdown(self, drain: bool = True) -> int:
        """Stop admission and settle every pending future.

        After this, ``submit`` raises :class:`ServiceClosedError`. With
        ``drain=True`` pending requests are served one last time (how
        :class:`ModelRegistry` hot-swaps without dropping a future); with
        ``drain=False``, or if that drain fails, the remainder is rejected
        with :class:`ServiceClosedError`. Returns the number of futures
        settled. Idempotent; ``predict`` stays usable.
        """
        with self._lock:
            self._closed = True
        settled = 0
        if drain:
            try:
                settled = self.drain()
            except Exception:
                pass                  # failed drain re-queued — cancel below
        with self._lock:
            queue, self._queue, self._queued_rows = self._queue, [], 0
        for (_, _, fut, _) in queue:
            fut._reject(ServiceClosedError("service shut down before request was served"))
        with self._lock:
            self._requests_cancelled += len(queue)
        return settled + len(queue)

    def stats(self) -> dict:
        """Serving counters; ``buckets_compiled`` lists the bucket shapes
        served (the reference's per-bucket executables)."""
        return {
            "buckets_compiled": sorted(self._buckets_seen),
            "max_buckets": self.max_batch.bit_length() - self.min_bucket.bit_length() + 1,
            "requests_served": self._requests_served,
            "requests_shed": self._requests_shed,
            "requests_cancelled": self._requests_cancelled,
            "requests_deadline_exceeded": self._requests_deadline_exceeded,
            "requests_rate_limited": self._requests_rate_limited,
            "cache_hits": self._cache_hits,
            "cache_misses": self._cache_misses,
            "cache_evictions": self._cache_evictions,
            "breaker_state": self.breaker.state,
            "closed": self._closed,
            "pending": self.pending,
        }

    def health(self) -> dict:
        """Scrapeable health snapshot: breaker state, queue depth
        (requests and rows), the shed / deadline / rate-limit / cancel
        counters, the cache counters and the quarantined-block count of
        the model's training-time integrity report. No device work."""
        q = self.model.quarantine
        with self._lock:
            snap = {
                "breaker": self.breaker.state,
                "closed": self._closed,
                "queue_requests": len(self._queue),
                "queue_rows": self._queued_rows,
                "max_queue_rows": self.max_queue_rows,
                "served": self._requests_served,
                "shed": self._requests_shed,
                "cancelled": self._requests_cancelled,
                "deadline_exceeded": self._requests_deadline_exceeded,
                "rate_limited": self._requests_rate_limited,
                "cache_size": self.cache_size,
                "cache_entries": len(self._cache),
                "cache_hits": self._cache_hits,
                "cache_misses": self._cache_misses,
                "cache_evictions": self._cache_evictions,
                "quarantined_blocks": 0 if q is None else len(q.quarantined),
            }
        if self.rate_limiter is not None:
            snap["rate_limiter"] = self.rate_limiter.snapshot()
        return snap


# ---------------------------------------------------------------------------
# Versioned model registry: bulkheaded services, atomic hot-swap
# ---------------------------------------------------------------------------


class ModelRegistry:
    """Versioned registry of :class:`PRFService` instances with atomic
    hot-swap.

    Every ``publish`` wraps its model in a fresh service (its own queue,
    breaker and counters), so versions are bulkheaded. The live version
    is one reference flipped under a lock; a request routed to the old
    service the instant before a flip completes against the old model,
    and ``publish`` then calls ``old.shutdown(drain=True)``, which serves
    (never drops) its in-flight futures.
    """

    def __init__(self, **service_opts):
        self._service_opts = service_opts
        self._lock = threading.Lock()
        self._current: Optional[Tuple[int, PRFService]] = None
        self._retired: Dict[int, PRFService] = {}
        self._next_version = 1
        self._fallback_served = 0

    def publish(self, model: PRFModel, **overrides) -> int:
        """Swap in ``model`` (service kwargs: registry defaults +
        ``overrides``); returns its version. The previous version is
        drained against its own model, closed to submits, and its result
        cache invalidated."""
        svc = PRFService(model, **{**self._service_opts, **overrides})
        with self._lock:
            version = self._next_version
            self._next_version += 1
            old = self._current
            self._current = (version, svc)           # the atomic flip
            if old is not None:
                self._retired[old[0]] = old[1]
        if old is not None:
            old[1].shutdown(drain=True)
            old[1].invalidate_cache()
        return version

    @property
    def service(self) -> PRFService:
        """The live service (one reference read — safe against publish)."""
        cur = self._current
        if cur is None:
            raise ServiceClosedError("no model published")
        return cur[1]

    @property
    def version(self) -> int:
        cur = self._current
        if cur is None:
            raise ServiceClosedError("no model published")
        return cur[0]

    def _newest_healthy_retired(self) -> Optional[Tuple[int, PRFService]]:
        """Newest retired version whose own breaker is not open."""
        with self._lock:
            candidates = sorted(self._retired.items(), reverse=True)
        for version, svc in candidates:
            if svc.breaker.state != "open":
                return version, svc
        return None

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Predict against the live version; while its breaker is open,
        answer from the newest healthy retired version (counted as
        ``fallback_served``). With none, :class:`CircuitOpenError`."""
        try:
            return self.service.predict(x)
        except CircuitOpenError:
            fallback = self._newest_healthy_retired()
            if fallback is None:
                raise
            out = fallback[1].predict(x)
            with self._lock:
                self._fallback_served += 1
            return out

    def submit(self, x: np.ndarray, **kwargs) -> PRFFuture:
        return self.service.submit(x, **kwargs)

    def drain(self) -> int:
        return self.service.drain()

    def stats(self) -> dict:
        return {"version": self.version, **self.service.stats()}

    def health(self) -> dict:
        """The live service's ``health()`` plus version bookkeeping (live
        version, each retired version's breaker state, the fallback
        counter)."""
        cur = self._current
        with self._lock:
            retired = {v: s.breaker.state for v, s in self._retired.items()}
            snap = {"fallback_served": self._fallback_served, "retired": retired}
        if cur is None:
            snap.update({"version": None, "live": None})
        else:
            snap.update({"version": cur[0], "live": cur[1].health()})
        return snap

    def shutdown(self, drain: bool = True) -> int:
        """Shut down the live service and release every retired version
        (settling the live queue with ``drain``); returns the number of
        futures settled."""
        cur = self._current
        settled = 0 if cur is None else cur[1].shutdown(drain=drain)
        with self._lock:
            retired, self._retired = self._retired, {}
        for _, svc in sorted(retired.items()):
            settled += svc.shutdown(drain=False)
        return settled


# ---------------------------------------------------------------------------
# Tree-sharded multi-process voting
# ---------------------------------------------------------------------------


def make_sharded_vote_fn(forest: Forest, mesh, *, tree_axis: Union[str, Tuple[str, ...]] = "data"):
    """A predictor with the trees sharded over ``tree_axis`` of a
    ``launch.mesh.Mesh`` (SPMD: every rank holds the global forest and
    calls the returned function with the same rows).

    Rank ``i = mesh.index(tree_axis)`` takes trees ``[i * m, (i + 1) * m)``,
    ``m = n_trees / mesh.size(tree_axis)``, walks them with the traversal
    (``tree_chunk`` trees a launch, the ``[N, C]`` partial threaded
    through the chunks; the kernel on CUDA under ``"auto"`` / ``"pallas"``,
    its plain version otherwise) and one ``mesh.all_reduce`` over
    ``tree_axis`` sums the partials (host-staged on gloo); then the argmax,
    or Eq. 9's normalisation by the whole forest's vote weight.

    Returns ``fn(x_binned) -> [N]`` labels (classification) or values
    (regression), a tensor on the forest's device. ``n_trees`` must
    divide evenly over ``tree_axis`` (``ValueError`` otherwise, raised
    here on every rank before any collective).
    """
    from ..kernels.tree_traverse.ops import traverse_block
    from ..kernels.tree_traverse.ref import traverse_block_ref

    cfg = forest.config
    dev = forest.device
    k, n_shards = forest.n_trees, mesh.size(tree_axis)
    if k % n_shards:
        raise ValueError(f"n_trees={k} does not divide over {n_shards} ranks of {tree_axis!r}")
    m = k // n_shards
    t0 = mesh.index(tree_axis) * m
    shard = slice(t0, t0 + m)
    feat, thr, left = (getattr(forest, n)[shard].contiguous()
                       for n in ("feature", "threshold", "left_child"))
    payload = build_payload(forest)[shard].contiguous()
    norm = torch.clamp_min(_vote_weights(forest).sum(), 1e-38)
    walk = (traverse_block if resolve_predict_backend(cfg.predict_backend, dev) == "pallas"
            else traverse_block_ref)
    tc = min(cfg.tree_chunk if cfg.tree_chunk > 0 else m, m)

    def run(x_binned) -> torch.Tensor:
        xb = as_tensor(x_binned, dev, torch.uint8)
        partial = torch.zeros((xb.shape[0], payload.shape[-1]), dtype=torch.float32, device=dev)
        for c0 in range(0, m, tc):
            c = slice(c0, min(c0 + tc, m))
            partial = walk(xb, feat[c], thr[c], left[c], payload[c], partial, depth=cfg.max_depth)
        scores = mesh.all_reduce(partial, tree_axis)                      # the ONE combine
        if cfg.regression:
            return scores[:, 0] / norm
        return torch.argmax(scores, dim=-1)

    return run
