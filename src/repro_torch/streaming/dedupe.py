"""SolveDeduper — cross-tenant background-solve dedupe.

Demo and test fleets routinely run sibling tenants whose embedding
tables are byte-identical (same synthetic generator, same round), and
real fleets shard one model family across tenants that ingest the same
client population.  Each table's content fingerprint
(``CohortEngine.fingerprint``) keys a registry: the first tenant to warm
a fingerprint computes the ``PreparedSolve``; siblings wait on the
ticket's event and adopt the finished solve via
``CohortEngine.publish(prep, count=False)`` — ``count=False`` keeps
"exactly one engine solve per fingerprint" true on dashboards, which is
what the dedupe tests pin down.

The adopted ``PreparedSolve`` is shared by reference.  That is safe for
the serving path because everything downstream treats result arrays as
read-only (``CohortServer`` hands cohort draws out as python lists and
the engine cache replays defensive copies), and the engine state arrays
it installs (landmarks, eigenbases) are only ever read by later solves.

Threading: registry + done-cache are guarded by ``_dedupe_lock`` (ranked
in ``repro_torch.analysis.watchdog.SERVING_LOCK_ORDER``).  Waiters block on a per-ticket Event with no
lock held.  A failed solve aborts its ticket so waiters fall back to
solving solo rather than hanging.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

__all__ = ["SolveDeduper"]

_WAIT_S = 30.0   # waiter back-stop; an eigensolve should never take this


class _Ticket:
    def __init__(self, fingerprint: bytes):
        self.fingerprint = fingerprint
        self.done = threading.Event()


class SolveDeduper:
    """Fingerprint-keyed registry of in-flight and finished solves."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self._capacity = capacity
        self._dedupe_lock = threading.Lock()
        self._inflight: dict = {}      # fp -> _Ticket; guarded-by: _dedupe_lock
        # fp -> PreparedSolve, LRU-bounded so long-gone tables don't pin
        # their (N, k) embeddings forever
        self._done: OrderedDict = OrderedDict()  # guarded-by: _dedupe_lock
        self.stats = {"leads": 0, "hits": 0, "waits": 0,
                      "aborts": 0}     # guarded-by: _dedupe_lock

    def begin(self, fingerprint: bytes) -> Tuple[Optional[_Ticket], object]:
        """Claim or join the solve for ``fingerprint``.

        Returns ``(ticket, prep)``:

        * ``(ticket, None)`` — caller leads: solve, then
          :meth:`complete` (or :meth:`abort` on failure).
        * ``(None, prep)`` — another tenant already solved it; adopt.
        * ``(None, None)`` — an in-flight lead aborted (or timed out);
          caller should solve solo without registering.
        """
        with self._dedupe_lock:
            prep = self._done.get(fingerprint)
            if prep is not None:
                self._done.move_to_end(fingerprint)
                self.stats["hits"] += 1
                return None, prep
            ticket = self._inflight.get(fingerprint)
            if ticket is None:
                ticket = _Ticket(fingerprint)
                self._inflight[fingerprint] = ticket
                self.stats["leads"] += 1
                return ticket, None
            self.stats["waits"] += 1
        ticket.done.wait(timeout=_WAIT_S)
        with self._dedupe_lock:
            prep = self._done.get(fingerprint)
            if prep is not None:
                self._done.move_to_end(fingerprint)
                self.stats["hits"] += 1
            return None, prep

    def complete(self, ticket: _Ticket, prep) -> None:
        """Publish the lead's finished solve and release waiters."""
        fp = ticket.fingerprint
        with self._dedupe_lock:
            self._done[fp] = prep
            self._done.move_to_end(fp)
            while len(self._done) > self._capacity:
                self._done.popitem(last=False)
            self._inflight.pop(fp, None)
        ticket.done.set()

    def abort(self, ticket: _Ticket) -> None:
        """Lead failed: release waiters with nothing (they solve solo)."""
        with self._dedupe_lock:
            self._inflight.pop(ticket.fingerprint, None)
            self.stats["aborts"] += 1
        ticket.done.set()
