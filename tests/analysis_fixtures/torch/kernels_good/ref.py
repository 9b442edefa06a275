"""Fixture: the plain versions (parsed, not run)."""


def scale_ref(x, alpha):
    return x * alpha


def _shaped_impl(x):
    return x.clone()


shaped_ref = _shaped_impl            # an alias counts as the oracle
