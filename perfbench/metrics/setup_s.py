"""Process start to the first timed select: imports, the card's start,
the kernels' build or load, the tables, every tenant's warm-up rounds
(a cold and a warm solve, a DQN update)."""


def read(run):
    return run.setup_s
