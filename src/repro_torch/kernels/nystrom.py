"""Wrappers of the fused Nyström CUDA kernels (``csrc/nystrom.cu``).

The PyTorch counterpart of the JAX package's ``kernels/nystrom_pallas.py``,
with the same signatures (``x, z, gamma, mask, *, affinity_dtype,
block_m``; ``w, q`` for the eigensolver's panel matmul).
The device of the inputs decides the route:

* tensors on the CPU run the plain PyTorch versions in
  :mod:`repro_torch.kernels.ref`;
* tensors on a CUDA device launch the hand-written kernel, or raise —
  there is no fallback to the plain version.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current stream
without synchronizing, and adds one to its entry of :data:`LAUNCH_COUNTS`
(shared by every kernel wrapper) when it launches.
``block_m`` is kept for signature parity: the CUDA kernels fix their own
row panels (see the kernel source), and the plain versions have none.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.affinity import cross_tile_plan
from repro_torch.kernels._common import (LAUNCH_COUNTS, check_block,
                                         check_kernel_shape, check_points,
                                         check_tensors, launched, ptr,
                                         reset_launch_counts, stream)

__all__ = ["LAUNCH_COUNTS", "reset_launch_counts", "quantized_cross_affinity",
           "nystrom_colsum", "nystrom_gram", "nystrom_extension",
           "panel_matmul", "gram_slabs", "gram_pair", "gram_tile_pairs",
           "colsum_grid", "extension_row_width"]

AFFINITY_DTYPES = ("f32", "bf16", "int8")
_DTYPE_CODE = {"f32": 0, "bf16": 1, "int8": 2}
_MAX_K = 64              # widest projection the extension kernel holds
_COLSUM_ROWS = 256       # kColsumRows in nystrom.cu: the reduction tree
_COLSUM_THREADS = 128    # kColsumThreads
_GRAM_ROWS = 32          # kGramRows
_GRAM_TILE = 128         # kGramTile
_PANEL_COLS = 64         # the widest column tile of panel_kernel
_MAX_GRID_X = 2 ** 31 - 1   # CUDA's limit on gridDim.x (the tile pairs)
_MAX_GRID_Y = 65535      # ... on gridDim.y (column tiles; the Gram's slabs)
# the Gram kernel splits the rows into slabs until about this many
# (pair, slab) blocks exist (4 waves of 2 blocks on each SM of a 132-SM
# H100); a function of the shapes only, so the summation order never
# depends on the card
_GRAM_TARGET_BLOCKS = 1056
# cap on the floats of the slabs' partial tiles (128 MiB); it binds only
# when it leaves more than one slab: at m = 4096 two slabs, 69 MB
_GRAM_SCRATCH_CAP = 2 ** 25


def _check(name, affinity_dtype, block_m, **tensors) -> torch.device:
    """Validate the inputs; returns their common device."""
    if affinity_dtype not in AFFINITY_DTYPES:
        raise ValueError(f"{name}: unknown affinity_dtype "
                         f"{affinity_dtype!r}; expected one of "
                         f"{AFFINITY_DTYPES}")
    check_block(name, "block_m", block_m)
    return check_tensors(name, **tensors)


def _check_vector(name, label, v, length):
    if v is not None and tuple(v.shape) != (length,):
        raise ValueError(f"{name}: {label} must have shape ({length},), got "
                         f"{tuple(v.shape)}")


def quantized_cross_affinity(x, y, gamma, *, affinity_dtype: str = "f32",
                             block_m: int = 128):
    """(n, m) cross-affinity exp(-γ d²) at the chosen tile precision.

    On the card, the kernel of :func:`~repro_torch.kernels.affinity.
    rbf_cross_affinity` too (split by ``cross_tile_plan``): at ``"f32"``
    the two outputs are equal bit for bit.
    """
    name = "quantized_cross_affinity"
    dev = _check(name, affinity_dtype, block_m, x=x, y=y)
    n, m, d = check_points(name, x, y)
    g = float(gamma)
    if dev.type == "cpu":
        return ref.quantized_cross_affinity_ref(
            x, y, g, affinity_dtype=affinity_dtype)
    check_kernel_shape(name, n, m, d)
    lib = _build.library()
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_quantized_cross_affinity(
            x.data_ptr(), y.data_ptr(), g, out.data_ptr(), n, m, d,
            _DTYPE_CODE[affinity_dtype], cross_tile_plan(n, m, d).rows,
            stream(dev))
    _build.check(err, name)
    launched(name)
    return out


def colsum_grid(n: int, m: int, d: int):
    """(panels, column tiles, landmarks a thread) of B2's launch: a block
    owns one 256-row panel and ``landmarks a thread`` x 128 columns."""
    cols = 4 if d <= 8 else 2
    return (math.ceil(n / _COLSUM_ROWS),
            math.ceil(m / (cols * _COLSUM_THREADS)), cols)


def extension_row_width(d: int, k: int) -> int:
    """Floats of one packed landmark row of B4 (``ext_row_width``):
    coordinates (8, or 32 for d > 8), |z|², int8 scale, u, 0, then proj
    padded to 4."""
    return (8 if d <= 8 else 32) + 4 + math.ceil(k / 4) * 4


def nystrom_colsum(x, z, gamma, mask=None, *, affinity_dtype: str = "f32",
                   block_m: int = 1024):
    """``col = Σᵢ exp(-γ d²(xᵢ, z))·maskᵢ`` without materializing C, (m,)."""
    name = "nystrom_colsum"
    dev = _check(name, affinity_dtype, block_m, x=x, z=z, mask=mask)
    n, m, d = check_points(name, x, z)
    _check_vector(name, "mask", mask, n)
    g = float(gamma)
    if dev.type == "cpu":
        return ref.nystrom_colsum_ref(x, z, g, mask,
                                      affinity_dtype=affinity_dtype)
    check_kernel_shape(name, n, m, d)
    lib = _build.library()
    panels = colsum_grid(n, m, d)[0]
    partial = torch.empty((panels, m), dtype=torch.float32, device=dev)
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_nystrom_colsum(
            x.data_ptr(), z.data_ptr(), g, ptr(mask), partial.data_ptr(),
            out.data_ptr(), n, m, d, _DTYPE_CODE[affinity_dtype],
            stream(dev))
    _build.check(err, name)
    launched(name)
    return out


def gram_pair(tiles: int, idx: int):
    """(P, Q), P <= Q: the Gram kernel's tile pair ``idx`` of the upper
    triangle of a ``tiles`` x ``tiles`` grid of 128 x 128 tiles, row by
    row (``gram_pair`` in nystrom.cu)."""
    p = 0
    while idx >= tiles - p:
        idx -= tiles - p
        p += 1
    return p, p + idx


def _gram_pairs(m: int) -> int:
    tiles = math.ceil(m / _GRAM_TILE)
    return tiles * (tiles + 1) // 2


def gram_tile_pairs(m: int):
    """Every tile pair the Gram kernel computes, in block order: the
    upper triangle of SᵀS, each (P, Q) with P <= Q once."""
    tiles = math.ceil(m / _GRAM_TILE)
    return [gram_pair(tiles, i) for i in range(_gram_pairs(m))]


def gram_slabs(n: int, m: int):
    """(slabs, rows per slab) of the Gram kernel's split over the rows: a
    function of (n, m) alone."""
    pairs = _gram_pairs(m)
    slabs = max(1, min(math.ceil(n / _GRAM_ROWS),
                       math.ceil(_GRAM_TARGET_BLOCKS / pairs),
                       _GRAM_SCRATCH_CAP // (pairs * _GRAM_TILE ** 2)))
    slab_rows = math.ceil(math.ceil(n / slabs) / _GRAM_ROWS) * _GRAM_ROWS
    return math.ceil(n / slab_rows), slab_rows


def nystrom_gram(x, z, gamma, u, w_isqrt, mask=None, *,
                 affinity_dtype: str = "f32", block_m: int = 1024):
    """Fused ``W⁻¹ᐟ² (SᵀS) W⁻¹ᐟ²`` where S is the degree-normalized C.

    ``u`` (m,) is ``W⁻¹ᐟ²(W⁻¹ᐟ² col)``; ``w_isqrt`` (m, m), any matrix.
    Returns the rotated (m, m) Gram; the caller symmetrizes and
    eigensolves.  The CUDA kernel computes the upper triangle of SᵀS in
    the tile pairs of :func:`gram_tile_pairs` over the row slabs of
    :func:`gram_slabs`, and mirrors it.
    """
    name = "nystrom_gram"
    dev = _check(name, affinity_dtype, block_m, x=x, z=z, u=u,
                 w_isqrt=w_isqrt, mask=mask)
    n, m, d = check_points(name, x, z)
    _check_vector(name, "mask", mask, n)
    _check_vector(name, "u", u, m)
    if tuple(w_isqrt.shape) != (m, m):
        raise ValueError(f"{name}: w_isqrt must be ({m}, {m}), got "
                         f"{tuple(w_isqrt.shape)}")
    g = float(gamma)
    if dev.type == "cpu":
        return ref.nystrom_gram_ref(x, z, g, u, w_isqrt, mask,
                                    affinity_dtype=affinity_dtype)
    check_kernel_shape(name, n, m, d)
    pairs = _gram_pairs(m)
    if pairs > _MAX_GRID_X:
        raise ValueError(f"{name}: m={m} needs {pairs} tile pairs, more "
                         f"than CUDA's {_MAX_GRID_X} blocks")
    lib = _build.library()
    slabs, slab_rows = gram_slabs(n, m)
    f32 = dict(dtype=torch.float32, device=dev)
    r = torch.empty((n,), **f32)
    partial = torch.empty((slabs, pairs, _GRAM_TILE, _GRAM_TILE), **f32)
    gram = torch.empty((m, m), **f32)
    rotated_half = torch.empty((m, m), **f32)
    out = torch.empty((m, m), **f32)
    with torch.cuda.device(dev):
        err = lib.rt_nystrom_gram(
            x.data_ptr(), z.data_ptr(), g, u.data_ptr(), w_isqrt.data_ptr(),
            ptr(mask), r.data_ptr(), partial.data_ptr(), gram.data_ptr(),
            rotated_half.data_ptr(), out.data_ptr(), n, m, d, slabs,
            slab_rows, _DTYPE_CODE[affinity_dtype], stream(dev))
    _build.check(err, name)
    launched(name)
    return out


def nystrom_extension(x, z, gamma, u, proj, mask=None, *,
                      affinity_dtype: str = "f32", block_m: int = 1024):
    """Fused row-normalized extension ``row_normalize(S · proj)``, (n, k).

    Masked rows come out zero.  The CUDA kernel packs the landmarks with
    u and proj into an (m, :func:`extension_row_width`) scratch.
    """
    name = "nystrom_extension"
    dev = _check(name, affinity_dtype, block_m, x=x, z=z, u=u, proj=proj,
                 mask=mask)
    n, m, d = check_points(name, x, z)
    _check_vector(name, "mask", mask, n)
    _check_vector(name, "u", u, m)
    if proj.dim() != 2 or proj.shape[0] != m:
        raise ValueError(f"{name}: proj must be ({m}, k), got "
                         f"{tuple(proj.shape)}")
    k = proj.shape[1]
    g = float(gamma)
    if dev.type == "cpu":
        return ref.nystrom_extension_ref(x, z, g, u, proj, mask,
                                         affinity_dtype=affinity_dtype)
    check_kernel_shape(name, n, m, d)
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"{name}: the CUDA kernel takes 1 <= k <= "
                         f"{_MAX_K}, got k={k}")
    lib = _build.library()
    packed = torch.empty((m, extension_row_width(d, k)), dtype=torch.float32,
                         device=dev)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_nystrom_extension(
            x.data_ptr(), z.data_ptr(), g, u.data_ptr(), proj.data_ptr(),
            ptr(mask), packed.data_ptr(), out.data_ptr(), n, m, d, k,
            _DTYPE_CODE[affinity_dtype], stream(dev))
    _build.check(err, name)
    launched(name)
    return out


def panel_matmul(w, q):
    """(m, p) @ (p, r) in exact f32: the subspace solver's W·Q product.

    The TPU kernel walks row panels of ``block_rows``; this kernel covers
    every row in one launch (a block owns 16 or 32 rows and every column
    up to 64), and each output entry sums over p in one fixed order, so
    the JAX ``block_rows`` has no counterpart here and a repeat call is
    bit-identical.
    """
    name = "panel_matmul"
    dev = check_tensors(name, w=w, q=q)
    if w.dim() != 2 or q.dim() != 2 or w.shape[1] != q.shape[0]:
        raise ValueError(f"{name}: w {tuple(w.shape)} and q "
                         f"{tuple(q.shape)} must be (m, p) and (p, r)")
    m, p = w.shape
    r = q.shape[1]
    if dev.type == "cpu":
        return ref.panel_matmul_ref(w, q)
    if min(m, p, r) < 1:
        raise ValueError(f"{name}: the CUDA kernel needs m, p, r >= 1, got "
                         f"({m}, {p}, {r})")
    if math.ceil(r / _PANEL_COLS) > _MAX_GRID_Y:
        raise ValueError(f"{name}: the CUDA kernel takes r <= "
                         f"{_MAX_GRID_Y * _PANEL_COLS} columns, got {r}")
    lib = _build.library()
    out = torch.empty((m, r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_panel_matmul(w.data_ptr(), q.data_ptr(), out.data_ptr(),
                                  m, p, r, stream(dev))
    _build.check(err, name)
    launched(name)
    return out
