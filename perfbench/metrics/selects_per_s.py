"""Selects completed in the window over the time from its start to the
end of the last of them."""

from perfbench.harness.stats import selects_per_s


def read(run):
    return selects_per_s(run.window_selects(), run.t0, run.close)
