"""Serving layer (counterpart of ``repro/serving``).

* ``serve_step``   -- LM prefill + greedy decode (``greedy_generate``).
* ``prf_service``  -- forest serving on the fused traversal path:
  power-of-two batch buckets, an async micro-batch queue, tree-sharded
  voting over a ``launch.mesh.Mesh``, typed shedding, a circuit breaker,
  deterministic shutdown, a versioned hot-swap registry, deadlines,
  per-client rate limiting, stale fallback and ``health()`` snapshots.

The reference's ``make_serve_fns`` (LM mesh and jit glue, over
``training/sharding.py``'s shardings) is not ported: ROADMAP.md Queue 1
item 13, the LM mesh glue's serving slice (its training half is ported).
"""
from .prf_service import (  # noqa: F401
    CircuitBreaker, CircuitOpenError, DeadlineExceeded, ModelRegistry, PRFFuture, PRFService,
    RateLimited, RateLimiter, ServiceClosedError, ServiceError, ServiceOverloaded, bucket_size,
    make_sharded_vote_fn,
)
from .serve_step import greedy_generate  # noqa: F401
