"""The end-to-end metrics' arithmetic, kept apart so the tests can hold
it: a tail over every select of the window, a rate over whole selects.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional


def percentile(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def select_p95_ms(records) -> Optional[float]:
    """95th percentile latency in ms over every select of the window; a
    failed select counts as missing, an infinite latency.
    ``records``: objects with ``ok`` and ``latency_s``."""
    lat = [r.latency_s if r.ok else math.inf for r in records]
    if not lat:
        return None
    return percentile(lat, 95.0) * 1e3


def selects_per_s(records, start: float, close: float) -> Optional[float]:
    """Selects completed by ``close`` over the time from ``start`` to the
    end of the last of them; a select still running at ``close`` neither
    counts nor adds time.  ``records``: objects with ``ok`` and ``end``."""
    done = [r.end for r in records if r.ok and r.end <= close]
    if not done:
        return None
    return len(done) / (max(done) - start)

