"""repro-torch-lint: static analysis of the PyTorch/CUDA port.

The port's counterpart of the JAX package's ``repro.analysis``, with the
same exported names.  It imports only the standard library: it parses
source and never imports it, so it runs in milliseconds anywhere (no
torch, no numpy, no card).  Three rule families over the port's
correctness-critical layers:

1. **Host syncs and RNG** (``repro_torch.analysis.purity``) — host reads
   inside functions handed to ``torch.func`` / ``torch.vmap`` /
   ``torch.compile`` or an ``autograd.Function``, draws from a global
   generator anywhere, constant and reused seeds, and blocking reads of
   device results.
2. **Kernel wrappers** (``repro_torch.analysis.kernel_rules``, for
   ``pallas_rules``) — each ``lib.rt_*`` wrapper has a plain version in
   ``ref.py`` and runs it on the CPU, never falls back quietly on the
   card, checks and counts its launch, keeps a fake tensor off the
   kernel, and agrees with the ``extern "C"`` prototype its ctypes
   table describes.
3. **Lock discipline** (``repro_torch.analysis.locks``) — the JAX
   checker's ``# guarded-by:`` and lock-order-cycle rules.  The runtime
   counterpart is :mod:`repro_torch.analysis.watchdog`, with the port's
   kernel locks in its rank table.

Run it as ``python -m repro_torch.analysis`` or the ``repro-torch-lint``
entry point; the README's "The port's lint" lists the rules.
"""

from repro_torch.analysis.findings import Finding, RULES
from repro_torch.analysis.runner import analyze_paths, main
from repro_torch.analysis.watchdog import (LockOrderError, OrderedLock,
                                           SERVING_LOCK_ORDER, instrument)

__all__ = ["Finding", "RULES", "analyze_paths", "main", "LockOrderError",
           "OrderedLock", "SERVING_LOCK_ORDER", "instrument"]
