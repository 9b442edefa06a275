"""Runtime lock-order watchdog: assert the static order at acquisition.

The port's copy of the JAX package's ``repro.analysis.watchdog``:
:class:`OrderedLock`, :class:`LockOrderError`, :func:`held_names` and
:func:`instrument`.  A non-reentrant :class:`OrderedLock` accepts and
refuses exactly what the JAX one does.  What changed:

* :data:`SERVING_LOCK_ORDER` keeps the JAX table's eleven names and
  ranks and adds the port's own locks, the four kernel locks.  Their
  attribute name ``_lock`` is shared by three classes, so a key may be
  ``"<Class>.<attr>"``: :func:`instrument` looks that up first and the
  bare ``attr`` second.  For a module the "class" is the module's last
  name (``_common._COUNT_LOCK``), so ``instrument(_common)`` swaps the
  launch counts' module-level lock: ``launched()`` and
  ``reset_launch_counts()`` read the global on every call.
* ``StepCounter._lock`` is an ``RLock`` (a finalizer may free a storage
  on the thread that holds it), so :func:`instrument` wraps a reentrant
  lock in a reentrant :class:`OrderedLock`: re-acquiring a lock the
  thread already holds skips the rank check.  Every other lock stays
  non-reentrant, and re-acquiring one is refused as in the JAX package.
* Each :class:`OrderedLock` counts its acquisitions, so a run can show
  which locks it exercised.

A thread may only acquire a lock whose rank is strictly greater than
every lock it already holds; a violation raises :class:`LockOrderError`
at the acquisition site.  The ranks (ascending = outermost first)::

    SERVING_LOCK_ORDER = {
        "_registry_lock": 5,    # CohortFrontend tenant registry
        "_sched_lock": 15,      # DecodeScheduler slot table + queue
        "_select_lock": 20,     # CohortServer single-writer select/draw
        "_solve_lock": 24,      # engine entry: inline + background solves
        "lock": 30,             # _Tenant batch bookkeeping (via seal)
        "_write_lock": 32,      # embedding base table + delta buffer
        "_queue_lock": 34,      # BackgroundSolver dirty-tenant queue
        "_dedupe_lock": 35,     # SolveDeduper fingerprint registry
        "_publish_lock": 36,    # warmed (version, table, result) mailbox
        "_admission_lock": 38,  # AdmissionController tokens / depth
        "_stats_lock": 40,      # CohortServer counters
        "_PallasToggle._lock": 42,   # kernels/ops.py use_pallas toggle
        "_Library._lock": 44,        # kernels/_build.py loaded libraries
        "_common._COUNT_LOCK": 46,   # kernels/_common.py launch counts
        "StepCounter._lock": 48,     # roofline/counting.py (innermost)
    }

The four kernel locks are leaves: each is held only around its own
fields, and a kernel launch takes them inside whichever serving locks
its caller holds (a scheduler's prefill reads the toggle under
``_sched_lock``; an inline solve launches under ``_select_lock`` and
``_solve_lock``, a background one under ``_solve_lock``), so they rank
after ``_stats_lock``.  ``_build.library()`` is called before a launch
is counted, so ``_Library._lock`` ranks before ``_COUNT_LOCK``, though
neither is held while the other is taken.  ``StepCounter._lock`` ranks
last: its finalizer runs wherever the garbage collector frees a counted
storage, under any lock at all.  ``tests/test_torch_streaming.py``,
``tests/test_torch_frontend.py``, ``tests/test_torch_serve_lm.py`` and
``chip_smoke.py``'s phase 17 prove the order on herds of threads.
"""

from __future__ import annotations

import threading
import types
from typing import Dict, List, Optional

#: acquisition order of the port's serving stack and its kernel locks
SERVING_LOCK_ORDER: Dict[str, int] = {
    "_registry_lock": 5,
    "_sched_lock": 15,
    "_select_lock": 20,
    "_solve_lock": 24,
    "lock": 30,
    "_write_lock": 32,
    "_queue_lock": 34,
    "_dedupe_lock": 35,
    "_publish_lock": 36,
    "_admission_lock": 38,
    "_stats_lock": 40,
    "_PallasToggle._lock": 42,
    "_Library._lock": 44,
    "_common._COUNT_LOCK": 46,
    "StepCounter._lock": 48,
}

_RLOCK_TYPES = (type(threading.RLock()),)


class LockOrderError(RuntimeError):
    """A thread acquired locks against the declared rank order."""


class _Held(threading.local):
    def __init__(self):
        self.stack: List["OrderedLock"] = []


_held = _Held()


class OrderedLock:
    """A lock wrapper asserting rank order at every acquisition.

    Drop-in for the ``with``-statement and ``acquire``/``release``
    subset of the :class:`threading.Lock` interface the serving stack
    uses.  Re-acquiring an already-held rank is rejected unless the lock
    is ``reentrant`` (then it wraps an ``RLock`` and a re-acquisition by
    its holder skips the check).
    """

    def __init__(self, name: str, rank: int,
                 lock: Optional[threading.Lock] = None, *,
                 reentrant: bool = False):
        self.name = name
        self.rank = rank
        self.reentrant = reentrant
        self.acquisitions = 0
        self._lock = lock if lock is not None else (
            threading.RLock() if reentrant else threading.Lock())

    def _check(self) -> None:
        if self.reentrant and self in _held.stack:
            return
        for held in _held.stack:
            if held.rank >= self.rank:
                raise LockOrderError(
                    f"lock-order violation: acquiring {self.name!r} "
                    f"(rank {self.rank}) while holding {held.name!r} "
                    f"(rank {held.rank}); declared order requires "
                    f"strictly increasing ranks")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check()
        got = (self._lock.acquire(blocking, timeout) if timeout != -1
               else self._lock.acquire(blocking))
        if got:
            self.acquisitions += 1
            _held.stack.append(self)
        return got

    def release(self) -> None:
        if _held.stack and _held.stack[-1] is self:
            _held.stack.pop()
        else:  # out-of-LIFO release: still drop our entry if present
            for i in range(len(_held.stack) - 1, -1, -1):
                if _held.stack[i] is self:
                    del _held.stack[i]
                    break
        self._lock.release()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()


def held_names() -> List[str]:
    """Names of the locks the calling thread currently holds."""
    return [lk.name for lk in _held.stack]


def owner_name(obj) -> str:
    """The "class" of ``obj`` in a rank key: its type's name, or a
    module's last dotted name."""
    if isinstance(obj, types.ModuleType):
        return obj.__name__.rsplit(".", 1)[-1]
    return type(obj).__name__


def instrument(obj, ranks: Optional[Dict[str, int]] = None,
               prefix: str = "") -> List[str]:
    """Replace ``obj``'s lock attributes with :class:`OrderedLock`.

    Every attribute of ``obj`` named in ``ranks`` (default
    :data:`SERVING_LOCK_ORDER`) that currently holds a lock-like object
    is swapped for an ``OrderedLock`` of that rank: a key
    ``"<owner>.<attr>"`` names ``attr`` of an object whose
    :func:`owner_name` is ``owner``, and wins over a bare ``attr`` key.
    An ``RLock`` becomes a reentrant ``OrderedLock``.  Returns the
    attribute names instrumented.  ``prefix`` disambiguates instances in
    error messages (e.g. the tenant name).
    """
    ranks = ranks if ranks is not None else SERVING_LOCK_ORDER
    owner = owner_name(obj)
    done = []
    for key, rank in ranks.items():
        cls, _, attr = key.rpartition(".")
        if cls and cls != owner:
            continue
        if not cls and f"{owner}.{attr}" in ranks:
            continue
        cur = getattr(obj, attr, None)
        if cur is None or isinstance(cur, OrderedLock):
            continue
        if not (hasattr(cur, "acquire") and hasattr(cur, "release")):
            continue
        name = f"{prefix}{owner}.{attr}"
        setattr(obj, attr, OrderedLock(
            name, rank, reentrant=isinstance(cur, _RLOCK_TYPES)))
        done.append(attr)
    return done
