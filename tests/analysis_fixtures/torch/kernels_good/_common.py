"""Fixture: launch counts of the compliant kernels (parsed, not run)."""
import threading

LAUNCH_COUNTS = {"scale": 0, "shaped": 0}
_COUNT_LOCK = threading.Lock()


def launched(name):
    with _COUNT_LOCK:
        LAUNCH_COUNTS[name] += 1


def is_fake(t):
    return False
