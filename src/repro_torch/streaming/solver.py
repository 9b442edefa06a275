"""BackgroundSolver — the double-buffer's write side.

A small thread pool that runs solve-ahead ("warm") tasks off the serving
path.  The queue is a **latest-wins dirty set** keyed by tenant: ten
rapid ``update_embeddings`` calls on one tenant coalesce into one
pending warm task, because the task itself snapshots the freshest table
when it finally runs — warming ten intermediate versions would be wasted
work.  Tasks for *different* keys run concurrently (up to ``workers``).

The solver knows nothing about engines or tables; it runs opaque
callables.  ``CohortServer._background_warm`` is the canonical task: it
snapshots, ``CohortEngine.prepare``-s, and parks the result in the
server's publish mailbox for the next select to swap in.

Threading: ``_dirty``/``_inflight``/``_closed``/``stats`` are guarded by
``_queue_lock`` (ranked in ``repro_torch.analysis.watchdog.
SERVING_LOCK_ORDER``); workers run tasks with no solver lock held, so a
slow solve never blocks ``submit``.  The wake signal is a plain
:class:`threading.Event` rather than a Condition so the port's runtime
lock-order watchdog (:mod:`repro_torch.analysis.watchdog`) can
instrument ``_queue_lock`` like any other lock.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import traceback
from collections import OrderedDict
from typing import Callable, Optional

__all__ = ["BackgroundSolver", "StreamingSpec"]

#: nice value for worker threads; see :func:`_deprioritize`.
_WORKER_NICENESS = 10


def _deprioritize() -> None:
    """Drop the calling worker thread's scheduling priority.

    A solve is tens of milliseconds of compute; a warmed select is ~2.
    At equal priority on a loaded (or single-core) host the solver
    starves concurrent selects — the classic compaction-vs-reads
    problem, solved the classic way: background threads run niced, so
    the scheduler hands the core back the moment a select thread wakes.
    On Linux ``setpriority(PRIO_PROCESS, 0, ...)`` is per-thread;
    elsewhere it may be process-wide or unsupported, so best-effort.
    """
    try:
        os.setpriority(os.PRIO_PROCESS, 0, _WORKER_NICENESS)
    except (AttributeError, OSError):
        pass


@dataclasses.dataclass(frozen=True)
class StreamingSpec:
    """Per-tenant streaming-serving knobs (see package docstring).

    max_stale_versions — serve a warmed result as long as the table
                         version it was solved at is within this many
                         versions of the current table; beyond it the
                         select solves inline (bounded staleness).
                         ``None`` never forces an inline solve: selects
                         serve whatever is warmed, however old.
    solver_workers     — background solve threads (shared pool when the
                         frontend owns the solver).
    dedupe             — ride another tenant's solve when the embedding
                         tables share a content fingerprint.
    max_queue_depth    — admission: max concurrent selects per tenant
                         before ``QueueFullError`` sheds.  None = no cap.
    rate_per_s/burst   — admission: token-bucket select rate limit.
                         None = unlimited.
    """
    max_stale_versions: Optional[int] = None
    solver_workers: int = 1
    dedupe: bool = True
    max_queue_depth: Optional[int] = 64
    rate_per_s: Optional[float] = None
    burst: Optional[int] = None

    def __post_init__(self):
        if self.max_stale_versions is not None and self.max_stale_versions < 0:
            raise ValueError(
                f"max_stale_versions={self.max_stale_versions} must be >= 0")
        if self.solver_workers < 1:
            raise ValueError(
                f"solver_workers={self.solver_workers} must be >= 1")


class BackgroundSolver:
    """Latest-wins background task pool for solve-ahead work."""

    def __init__(self, workers: int = 1, *, name: str = "repro-solver"):
        if workers < 1:
            raise ValueError(f"workers={workers} must be >= 1")
        self._queue_lock = threading.Lock()
        self._wake = threading.Event()
        # key -> task; latest submit for a key replaces the pending one
        self._dirty: "OrderedDict[object, Callable[[], None]]" = \
            OrderedDict()               # guarded-by: _queue_lock
        self._inflight: set = set()     # guarded-by: _queue_lock
        self._closed = False            # guarded-by: _queue_lock
        self.stats = {"submitted": 0, "runs": 0, "errors": 0,
                      "coalesced": 0}   # guarded-by: _queue_lock
        # traceback of the latest failed task (None while none failed)
        self.last_error: Optional[str] = None   # guarded-by: _queue_lock
        self._threads = [
            threading.Thread(target=self._loop, name=f"{name}-{i}",
                             daemon=True)
            for i in range(workers)]
        for t in self._threads:
            t.start()

    def submit(self, key, fn: Callable[[], None]) -> bool:
        """Mark ``key`` dirty; ``fn`` runs on a worker soon.

        Returns False (and drops the task) after :meth:`close` — a
        server racing a shutdown must treat that as "no warm coming".
        """
        with self._queue_lock:
            if self._closed:
                return False
            self.stats["submitted"] += 1
            if key in self._dirty:
                self.stats["coalesced"] += 1
            self._dirty[key] = fn
            self._dirty.move_to_end(key)
        self._wake.set()
        return True

    def _next_task(self):
        with self._queue_lock:
            for key, fn in self._dirty.items():
                # one in-flight task per key: the task snapshots the
                # freshest table itself, so running two generations of
                # the same tenant concurrently is pure waste
                if key not in self._inflight:
                    del self._dirty[key]
                    self._inflight.add(key)
                    return key, fn
            # nothing runnable (empty, or every dirty key already in
            # flight): clear under the lock — submit inserts under the
            # same lock before set(), and task completion re-sets the
            # event after discard, so a wake can't be lost
            self._wake.clear()
            return None, None

    def _loop(self) -> None:
        _deprioritize()
        while True:
            with self._queue_lock:
                if self._closed and not self._dirty:
                    return
            key, fn = self._next_task()
            if fn is None:
                self._wake.wait(timeout=0.05)
                continue
            try:
                with self._queue_lock:
                    self.stats["runs"] += 1
                fn()
            except Exception:
                error = traceback.format_exc()
                # the error first: a reader that sees it counted (without
                # the lock) finds it
                with self._queue_lock:
                    self.last_error = error
                    self.stats["errors"] += 1
            finally:
                with self._queue_lock:
                    self._inflight.discard(key)
                self._wake.set()   # another key may be runnable now

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until no task is pending or running.  True on success."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._queue_lock:
                idle = not self._dirty and not self._inflight
            if idle:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.002)

    def close(self, timeout: Optional[float] = None) -> None:
        """Finish pending work, then stop and join the workers."""
        with self._queue_lock:
            self._closed = True
        self._wake.set()
        self.drain(timeout)
        self._wake.set()
        for t in self._threads:
            t.join(timeout=timeout)
