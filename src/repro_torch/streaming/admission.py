"""AdmissionController — per-tenant select admission + load shedding.

Two independent gates, both optional:

* **bounded queue depth** — at most ``max_queue_depth`` selects in
  flight per tenant; the next admit sheds with :class:`QueueFullError`.
  Depth is the frontend's in-flight count (admit on entry, release in a
  ``finally``), so a tenant whose solves stall can only ever pin
  ``max_queue_depth`` worker threads, not the whole pool.
* **token bucket** — sustained ``rate_per_s`` with ``burst`` headroom;
  an empty bucket sheds with :class:`RateLimitError`.  Tokens accrue
  continuously from a monotonic clock (injectable for tests).

Shedding is deterministic — admit/shed depends only on current depth
and bucket level, never on timing races — which is what the streaming
tests pin down.  Both error types derive from :class:`ShedError` so
callers can catch one type and read ``.tenant`` for attribution.

Threading: all mutable state is guarded by ``_admission_lock``, ranked
innermost-but-one among the serving locks of ``repro_torch.analysis.
watchdog.SERVING_LOCK_ORDER`` (only ``_stats_lock`` and the kernel
locks rank later); ``try_admit``/``release`` are safe from any frontend
worker.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["AdmissionController", "QueueFullError", "RateLimitError",
           "ServiceClosedError", "ShedError"]


class ServiceClosedError(RuntimeError):
    """Select arrived after ``close()``; the service is draining/down."""


class ShedError(RuntimeError):
    """A select was shed by admission control (load, not failure)."""

    def __init__(self, message: str, *, tenant: str = ""):
        super().__init__(message)
        self.tenant = tenant


class QueueFullError(ShedError):
    """Per-tenant in-flight depth is at ``max_queue_depth``."""


class RateLimitError(ShedError):
    """Per-tenant token bucket is empty (rate_per_s exceeded)."""


class AdmissionController:
    """Bounded-depth + token-bucket admission for one tenant."""

    def __init__(self, *, max_queue_depth: Optional[int] = None,
                 rate_per_s: Optional[float] = None,
                 burst: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = ""):
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth={max_queue_depth} must be >= 1")
        if rate_per_s is not None and rate_per_s <= 0:
            raise ValueError(f"rate_per_s={rate_per_s} must be > 0")
        self.name = name
        self.max_queue_depth = max_queue_depth
        self.rate_per_s = rate_per_s
        # default burst: one second's worth of tokens, at least 1
        self.burst = (burst if burst is not None
                      else max(1, int(rate_per_s)) if rate_per_s else None)
        self._clock = clock
        self._admission_lock = threading.Lock()
        self._depth = 0                      # guarded-by: _admission_lock
        self._tokens = float(self.burst or 0)   # guarded-by: _admission_lock
        self._last_refill = clock()          # guarded-by: _admission_lock
        self._counters = {"admitted": 0, "shed_queue": 0,
                          "shed_rate": 0}    # guarded-by: _admission_lock

    def try_admit(self) -> None:
        """Admit one select or raise a :class:`ShedError` subclass.

        On success the caller owns one unit of depth and MUST pair this
        with :meth:`release` (use ``finally``).
        """
        with self._admission_lock:
            if (self.max_queue_depth is not None
                    and self._depth >= self.max_queue_depth):
                self._counters["shed_queue"] += 1
                raise QueueFullError(
                    f"tenant {self.name!r}: {self._depth} selects in "
                    f"flight (max_queue_depth={self.max_queue_depth})",
                    tenant=self.name)
            if self.rate_per_s is not None:
                now = self._clock()
                self._tokens = min(
                    float(self.burst),
                    self._tokens + (now - self._last_refill)
                    * self.rate_per_s)
                self._last_refill = now
                if self._tokens < 1.0:
                    self._counters["shed_rate"] += 1
                    raise RateLimitError(
                        f"tenant {self.name!r}: token bucket empty "
                        f"(rate_per_s={self.rate_per_s}, "
                        f"burst={self.burst})", tenant=self.name)
                self._tokens -= 1.0
            self._depth += 1
            self._counters["admitted"] += 1

    def release(self) -> None:
        """Return one unit of depth admitted by :meth:`try_admit`."""
        with self._admission_lock:
            if self._depth <= 0:
                raise RuntimeError("release() without matching try_admit()")
            self._depth -= 1

    @property
    def depth(self) -> int:
        with self._admission_lock:
            return self._depth

    def stats(self) -> dict:
        with self._admission_lock:
            out = dict(self._counters)
            out["depth"] = self._depth
        return out
