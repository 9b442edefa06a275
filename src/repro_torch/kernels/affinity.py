"""Wrappers of the materialized affinity CUDA kernels (``csrc/affinity.cu``).

The PyTorch counterpart of the JAX package's ``kernels/affinity_pallas.py``
with the same signatures.  The device of the inputs decides the route:
CPU tensors run the plain versions in :mod:`repro_torch.kernels.ref`;
CUDA tensors launch the kernel, or raise.  Each wrapper checks device,
dtype, shape and contiguity, allocates its output with ``torch.empty``,
launches on the current stream without synchronizing and counts the
launch in :data:`repro_torch.kernels._common.LAUNCH_COUNTS`.  The TPU
kernels' ``block_m``/``block_n`` VMEM tiles have no counterpart: the CUDA
kernels fix their own tiles.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (check_kernel_shape, check_points,
                                         check_tensors, launched, stream)


def pairwise_sq_dists(x, y):
    """(n, d), (m, d) -> (n, m) squared distances, f32, clamped at 0."""
    name = "pairwise_sq_dists"
    dev = check_tensors(name, x=x, y=y)
    n, m, d = check_points(name, x, y)
    if dev.type == "cpu":
        return ref.pairwise_sq_dists_ref(x, y)
    check_kernel_shape(name, n, m, d)
    lib = _build.library()
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_pairwise_sq_dists(x.data_ptr(), y.data_ptr(),
                                       out.data_ptr(), n, m, d, stream(dev))
    _build.check(err, name)
    launched(name)
    return out


def rbf_affinity(x, gamma):
    """Fused RBF affinity exp(-γ d²) with zero diagonal, (n, d) -> (n, n)."""
    name = "rbf_affinity"
    dev = check_tensors(name, x=x)
    n, _, d = check_points(name, x, x)
    g = float(gamma)
    if dev.type == "cpu":
        return ref.rbf_affinity_ref(x, g)
    check_kernel_shape(name, n, n, d)
    lib = _build.library()
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_rbf_affinity(x.data_ptr(), g, out.data_ptr(), n, d,
                                  stream(dev))
    _build.check(err, name)
    launched(name)
    return out


def rbf_cross_affinity(x, y, gamma):
    """Rectangular fused RBF exp(-γ d²(x, y)), (n, d), (m, d) -> (n, m)."""
    name = "rbf_cross_affinity"
    dev = check_tensors(name, x=x, y=y)
    n, m, d = check_points(name, x, y)
    g = float(gamma)
    if dev.type == "cpu":
        return ref.rbf_cross_affinity_ref(x, y, g)
    check_kernel_shape(name, n, m, d)
    lib = _build.library()
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_rbf_cross_affinity(x.data_ptr(), y.data_ptr(), g,
                                        out.data_ptr(), n, m, d, stream(dev))
    _build.check(err, name)
    launched(name)
    return out
