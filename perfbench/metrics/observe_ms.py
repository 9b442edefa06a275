"""Mean time of ``observe_round`` (the DQN's replay insert and TD step)
in the window, from the benchmark's own span around the call."""


def read(run):
    spans = run.spans_named("observe")
    if not spans:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) / len(spans)
