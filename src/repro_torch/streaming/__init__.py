"""Streaming re-cluster subsystem — serve v while warming v+1.

Port of the JAX package's ``repro.streaming`` (stdlib only there and
here), with the same classes, lock names and counters.  On the card the
background solves launch the fused Nyström kernels from the solver's
worker thread, on that thread's current (by default the device's
default) stream, so a warm solve and a select are ordered on the card.

Under continuous embedding churn (clients report fresh embeddings every
round) the pre-streaming serving stack pays a full Nyström + eigensolve
inline on the first ``select_cohort`` after every ``update_embeddings``,
so p99 select latency degrades to cold-solve latency.  This package
makes re-clustering asynchronous and double-buffered:

* :class:`BackgroundSolver` (``solver.py``) — a small thread pool with a
  latest-wins dirty set.  ``CohortServer.update_embeddings`` submits a
  warm task; the worker snapshots the table, runs
  ``CohortEngine.prepare`` (which never touches serving-visible caches),
  and parks the finished ``(version, table, result)`` in the server's
  publish mailbox.  The serving path swaps the warmed result in
  atomically — selects never block on a solve after warm-up.  A bounded
  staleness knob (``StreamingSpec.max_stale_versions``) forces an inline
  solve only when the served version falls too far behind the table.
* :class:`AdmissionController` (``admission.py``) — per-tenant bounded
  queue depth + token-bucket rate limiting with typed :class:`ShedError`
  shedding, so one misbehaving tenant can't starve the others.
* :class:`SolveDeduper` (``dedupe.py``) — cross-tenant solve dedupe:
  tenants whose embedding tables share a content fingerprint ride one
  background solve, the rest adopt it via
  ``CohortEngine.publish(prep, count=False)``.

Wiring lives in ``launch/serve.py`` (swap protocol + streaming counters)
and ``launch/frontend.py`` (per-tenant :class:`StreamingSpec`, graceful
``close()``).  Every lock introduced here keeps the JAX package's name
and rank in the port's ``repro_torch.analysis.watchdog.
SERVING_LOCK_ORDER``, so that watchdog instruments the port's serving
stack; see the JAX package's docs/ARCHITECTURE.md ("Streaming
re-clustering") for the swap diagram.
"""

from repro_torch.streaming.admission import (AdmissionController,
                                             QueueFullError, RateLimitError,
                                             ServiceClosedError, ShedError)
from repro_torch.streaming.dedupe import SolveDeduper
from repro_torch.streaming.solver import BackgroundSolver, StreamingSpec

__all__ = [
    "AdmissionController", "BackgroundSolver", "QueueFullError",
    "RateLimitError", "ServiceClosedError", "ShedError", "SolveDeduper",
    "StreamingSpec",
]
