"""Fixture: launch counts (parsed, not run)."""
LAUNCH_COUNTS = {"no_cpu_route": 0, "fallback": 0, "unchecked": 0,
                 "miscounted": 0, "fake_leak": 0, "no_oracle": 0,
                 "wrong_arity": 0, "early_count": 0}


def launched(name):
    LAUNCH_COUNTS[name] += 1


def is_fake(t):
    return False
