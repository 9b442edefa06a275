"""Wrappers of the materialized affinity CUDA kernels (``csrc/affinity.cu``).

The PyTorch counterpart of the JAX package's ``kernels/affinity_pallas.py``
with the same signatures.  The device of the inputs decides the route:
CPU tensors run the plain versions in :mod:`repro_torch.kernels.ref`;
CUDA tensors launch the kernel, or raise.  Each wrapper checks device,
dtype, shape and contiguity, allocates its output with ``torch.empty``,
launches on the current stream without synchronizing and counts the
launch in :data:`repro_torch.kernels._common.LAUNCH_COUNTS`.  The TPU
kernels' ``block_m``/``block_n`` VMEM tiles have no counterpart: all
three wrappers launch one CUDA kernel, ``cross_tile_kernel`` (B1's too),
with their own epilogue, and :func:`cross_tile_plan` splits its work.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (check_kernel_shape, check_points,
                                         check_tensors, launched, stream)


_CROSS_COL_THREADS = 64     # kCrossColThreads in csrc/affinity_tile.cuh
_CROSS_LANES = 4            # kCrossLanes: row lanes of a 256-thread block
_CROSS_MAX_ROWS = 64        # kCrossMaxRows
_SMS = 132                  # an H100's SMs


class CrossPlan(NamedTuple):
    """How ``cross_tile_kernel`` splits an (n, m) affinity."""
    row_tiles: int    # gridDim.x
    col_tiles: int    # gridDim.y: column tiles of 64 * cols columns
    rows: int         # rows a tile
    cols: int         # consecutive columns a thread
    vec: bool         # one vector store a row; else ``cols`` scalar stores


def cross_tile_plan(n: int, m: int, d: int) -> CrossPlan:
    """The grid of B1's, B6's, B7's and B8's kernel, a function of the
    shapes only (B8: m = n).

    A block of 256 threads owns one (row tile, column tile): 64 threads
    across the column tile, ``cols`` consecutive columns each (4 at
    d <= 8, 2 above, for the registers), and 4 row lanes.  Tiles have 64
    rows, halved down to 4 while fewer than two tiles an SM exist (small
    n, as B1's (m, m) block at m = 512).  Rows of ``out`` take vector
    stores only where ``m % 4 == 0`` (16-byte aligned rows of a fresh
    tensor).
    """
    cols = 4 if d <= 8 else 2
    col_tiles = math.ceil(m / (_CROSS_COL_THREADS * cols))
    rows = _CROSS_MAX_ROWS
    while rows > _CROSS_LANES and math.ceil(n / rows) * col_tiles < 2 * _SMS:
        rows //= 2
    return CrossPlan(math.ceil(n / rows), col_tiles, rows, cols, m % 4 == 0)


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
                                       out.data_ptr(), n, m, d,
                                       cross_tile_plan(n, m, d).rows,
                                       stream(dev))
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
                                  cross_tile_plan(n, n, d).rows, stream(dev))
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
                                        out.data_ptr(), n, m, d,
                                        cross_tile_plan(n, m, d).rows,
                                        stream(dev))
    _build.check(err, name)
    launched(name)
    return out
