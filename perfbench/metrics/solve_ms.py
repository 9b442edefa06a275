"""Mean engine solve time (``CohortResult.seconds``, host clock to the
results back on the host) over the solves published in the window."""


def read(run):
    secs = [p.seconds for p in run.window_publishes() if p.source != "cache"]
    return 1e3 * sum(secs) / len(secs) if secs else None
