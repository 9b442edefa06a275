"""Public dispatch for the hand-written kernels.

Counterpart of the JAX package's ``kernels/ops.py``, for all ten
kernels.  There is no interpret mode: the device of the tensors decides,
CPU tensors running the plain PyTorch versions and CUDA tensors the CUDA
kernels (see :mod:`repro_torch.kernels.nystrom`,
:mod:`~repro_torch.kernels.affinity`,
:mod:`~repro_torch.kernels.flash_attention` and
:mod:`~repro_torch.kernels.ssd`).  ``set_use_pallas`` keeps the
process-wide substrate switch of the JAX package under the same name:
with it on, the LM's prefill attention runs :func:`flash_attention` and
its SSD layers :func:`ssd_chunk` (``models/attention.py``,
``models/mamba.py``).  The toggle is lock-guarded and
``use_pallas_scoped`` restores the previous value on exit.
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.kernels import affinity as _affinity
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import nystrom as _nystrom
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels._common import (LAUNCH_COUNTS, THREAD_LAUNCHES,
                                         reset_launch_counts)

__all__ = ["LAUNCH_COUNTS", "THREAD_LAUNCHES", "reset_launch_counts",
           "set_use_pallas",
           "use_pallas", "use_pallas_scoped", "pairwise_sq_dists",
           "rbf_affinity", "rbf_cross_affinity", "nystrom_colsum",
           "nystrom_gram", "nystrom_extension", "panel_matmul",
           "quantized_cross_affinity", "flash_attention", "ssd_chunk"]


class _PallasToggle:
    """Process-wide substrate switch, safe under concurrent serving threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flag = False  # guarded-by: _lock

    def get(self) -> bool:
        with self._lock:
            return self._flag

    def swap(self, flag: bool) -> bool:
        """Set the flag, returning the value it replaced (atomically)."""
        with self._lock:
            prev = self._flag
            self._flag = bool(flag)
        return prev


_TOGGLE = _PallasToggle()


def set_use_pallas(flag: bool) -> None:
    _TOGGLE.swap(flag)


def use_pallas() -> bool:
    return _TOGGLE.get()


@contextlib.contextmanager
def use_pallas_scoped(flag: bool = True):
    """Scoped substrate flip: restores the value observed at entry.

    The swap in/out is atomic, but two threads scoping different values
    over the same window still race on the shared flag — per-call
    ``use_pallas=`` arguments are the per-thread mechanism; this is for
    tests and single-threaded tools.
    """
    prev = _TOGGLE.swap(flag)
    try:
        yield
    finally:
        _TOGGLE.swap(prev)


def pairwise_sq_dists(x, y, **kw):
    return _affinity.pairwise_sq_dists(x, y, **kw)


def rbf_affinity(x, gamma, **kw):
    return _affinity.rbf_affinity(x, gamma, **kw)


def rbf_cross_affinity(x, y, gamma, **kw):
    return _affinity.rbf_cross_affinity(x, y, gamma, **kw)


def nystrom_colsum(x, z, gamma, mask=None, **kw):
    return _nystrom.nystrom_colsum(x, z, gamma, mask, **kw)


def nystrom_gram(x, z, gamma, u, w_isqrt, mask=None, **kw):
    return _nystrom.nystrom_gram(x, z, gamma, u, w_isqrt, mask, **kw)


def nystrom_extension(x, z, gamma, u, proj, mask=None, **kw):
    return _nystrom.nystrom_extension(x, z, gamma, u, proj, mask, **kw)


def panel_matmul(w, q, **kw):
    return _nystrom.panel_matmul(w, q, **kw)


def quantized_cross_affinity(x, y, gamma, **kw):
    return _nystrom.quantized_cross_affinity(x, y, gamma, **kw)


def flash_attention(q, k, v, **kw):
    return _flash_attention.flash_attention(q, k, v, **kw)


def ssd_chunk(xdt, cs, Bm, Cm):
    return _ssd.ssd_chunk(xdt, cs, Bm, Cm)
