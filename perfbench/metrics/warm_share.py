"""Share of the window's solves that warm-started (``engine.stats``:
``warm_starts`` over ``solves``)."""


def read(run):
    warm = solves = 0
    for t, after in run.stats_after.items():
        before = run.stats_before[t]["engine"]
        warm += after["engine"]["warm_starts"] - before["warm_starts"]
        solves += after["engine"]["solves"] - before["solves"]
    return warm / solves if solves else None
