"""Share of the window in which no operation ran on the device, from the
profiler's trace."""


def read(run):
    if run.trace is None:
        return None
    return 1.0 - run.trace.busy_s(run.t0, run.close) / run.seconds
