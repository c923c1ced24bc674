"""Serving layer (counterpart of ``repro/serving``).

* ``serve_step``   -- LM prefill + decode on one device or a mesh
  (``make_serve_fns``: caches placed by ``training.cache_specs``, flash
  decoding's LSE combine), and the greedy loop (``greedy_generate``).
* ``prf_service``  -- forest serving on the fused traversal path:
  power-of-two batch buckets, an async micro-batch queue, tree-sharded
  voting over a ``launch.mesh.Mesh``, typed shedding, a circuit breaker,
  deterministic shutdown, a versioned hot-swap registry, deadlines,
  per-client rate limiting, stale fallback and ``health()`` snapshots.
"""
from .prf_service import (  # noqa: F401
    CircuitBreaker, CircuitOpenError, DeadlineExceeded, ModelRegistry, PRFFuture, PRFService,
    RateLimited, RateLimiter, ServiceClosedError, ServiceError, ServiceOverloaded, bucket_size,
    make_sharded_vote_fn,
)
from .serve_step import greedy_generate, make_serve_fns  # noqa: F401
