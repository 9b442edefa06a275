"""Fixture: plain versions, one missing (parsed, not run)."""


def no_cpu_route_ref(x):
    return x


def fallback_ref(x):
    return x


def unchecked_ref(x):
    return x


def miscounted_ref(x):
    return x


def fake_leak_ref(x):
    return x


def wrong_arity_ref(x):
    return x


def early_count_ref(x):
    return x
