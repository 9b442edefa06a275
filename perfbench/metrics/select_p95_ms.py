"""95th percentile select latency over every select of the window,
timed from its call; a failed select counts as missing."""

from perfbench.harness.stats import select_p95_ms


def read(run):
    return select_p95_ms(run.window_selects())
