"""Operation and byte counts of the kernels on the measured path, one
module a kernel, found by name (see ``perfbench/harness/registry.py``).

Each module defines ``DEVICE_KERNELS``, the substrings of the names of
the device kernels one call launches (empty where the work is a library
call), and ``count(shape)``, the operations and bytes one call needs at
``shape``, a dict with the keys ``n``, ``m``, ``d``, ``k``, ``r`` and
``iters`` (``r``: the subspace width, ``iters``: the sweeps).
Operations: a multiply-add counts 2, an RBF affinity entry ``2d + 5``
(the d-term dot as multiply-adds, the norm sum, the clamp, the
bandwidth's scale and one exp).  Bytes: each input read once and each
output written once.
"""
