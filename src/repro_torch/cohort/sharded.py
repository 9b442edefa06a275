"""Mesh-sharded Nyström: the 10⁵–10⁸-client route of the cohort engine.

Port of the JAX package's ``cohort/sharded.py``.  The (N, m)
cross-affinity is the only N-sized object of the landmark pipeline, so
client rows are what gets spread: x is zero-padded to a multiple of D
rows and cut into D contiguous shards, shard s on ``mesh[s]`` (a tuple
of devices, ``launch/mesh.py``), each computing its own rows of C (or
its fused passes) and of the output embedding.  Everything m-sized (z,
W⁻¹ᐟ², u, the projector) is computed once on ``mesh[0]`` and copied to
every device.  Per solve exactly two partials cross the mesh, at the
JAX package's two ``psum`` points:

    col  = Σ_s col_s             (m,)
    M    = Σ_s W⁻¹ᐟ² S_sᵀS_s W⁻¹ᐟ²   (m, m)

Both are summed on ``mesh[0]`` in shard order 0…D-1, with no atomics and
no ``torch.distributed``, so a re-solve is bit-identical at every D.
One process drives every device: it launches shard by shard without a
host sync in between (the launches are asynchronous, so shards on
separate cards overlap), and cross-device copies are ordered on the
current streams of both devices.  Padded rows are masked out of both
sums and sliced off the output; a shard with no padded row runs
unmasked, so at D = 1 the result is ``nystrom_from_landmarks``' bit for
bit.
"""

from __future__ import annotations

import torch

from repro_torch.cohort.nystrom import (_degree_direction, _degree_normalize,
                                        _extension_factors, _fused_projection,
                                        _solve_operator, landmark_block_isqrt)
from repro_torch.core.spectral import (cross_affinity, row_normalize,
                                       split_generator)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import as_mesh


def _shards(x, mesh):
    """``[(x_s, mask_s)]``: x zero-padded to a multiple of D rows, cut into
    D contiguous shards, shard s on ``mesh[s]``; ``mask_s`` is a 0/1 row
    mask where the shard holds a padded row, else None."""
    n, d = x.shape
    num = len(mesh)
    rows = -(-n // num)
    pad = rows * num - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))])
    out = []
    for s, dev in enumerate(mesh):
        lo = s * rows
        mask = None
        if lo + rows > n:
            mask = (torch.arange(lo, lo + rows, device=dev) < n).float()
        out.append((x[lo: lo + rows].to(dev), mask))
    return out


def _to_all(t, mesh):
    """``t`` copied to every device of the mesh (a no-op where it lies)."""
    return [t.to(dev) for dev in mesh]


def _sum_on(parts, dev):
    """The partials summed on ``dev`` in shard order."""
    total = parts[0].to(dev)
    for part in parts[1:]:
        total = total + part.to(dev)
    return total


def sharded_nystrom_from_landmarks(x, idx, k: int, gamma, mesh, *,
                                   use_pallas: bool = False,
                                   fused: bool = False,
                                   affinity_dtype: str = "f32",
                                   w_solver: str = "eigh",
                                   w_rank: int | None = None,
                                   mm_solver: str = "eigh",
                                   iters: int = 30, w_q0=None, mm_q0=None,
                                   generator=None, block_rows: int = 2048):
    """Distributed twin of ``nystrom.nystrom_from_landmarks``.

    The same arguments plus ``mesh`` (a sequence of devices, one row
    shard each); the same ``(y, evals, mm_basis, w_basis)`` contract,
    with ``y`` gathered in row order on ``mesh[0]``.  x and ``idx`` are
    moved to ``mesh[0]``, where W, its inverse square root and the one
    eigensolve run.  The two routes differ only in the float summation
    order of the two cross-shard sums, so compare rotation-invariant
    quantities across D (eigenvalues, the ``y·yᵀ`` projector,
    partitions).  ``fused=True`` gives every shard the three streaming
    kernel passes (colsum, rotated Gram, extension) at
    ``affinity_dtype``; ``fused=False`` materializes each shard's C
    panel (the RBF cross-affinity kernel on the card with
    ``use_pallas``).
    """
    mesh = as_mesh(mesh)
    home = mesh[0]
    gamma = float(gamma)
    x = x.to(device=home, dtype=torch.float32)
    n = x.shape[0]
    z = x[idx.to(home)].contiguous()
    w_gen, mm_gen = split_generator(generator)
    # W on the same route as the panels (consistency inside the
    # degenerate leading eigenspace, see nystrom_from_landmarks)
    if fused:
        w = kernel_ops.quantized_cross_affinity(
            z, z, gamma, affinity_dtype=affinity_dtype)
    else:
        w = cross_affinity(z, z, gamma=gamma, use_pallas=use_pallas)
    w_isqrt, w_basis = landmark_block_isqrt(
        z, gamma, w=w, w_solver=w_solver, w_rank=w_rank, iters=iters,
        w_q0=w_q0, generator=w_gen, block_rows=block_rows,
        use_pallas=fused or use_pallas)
    w_isqrt = w_isqrt.contiguous()
    shards = _shards(x, mesh)
    zs, ws = _to_all(z, mesh), _to_all(w_isqrt, mesh)
    solve = dict(mm_solver=mm_solver, mm_iters=iters, mm_q0=mm_q0,
                 generator=mm_gen, block_rows=block_rows)

    if fused:
        kw = dict(affinity_dtype=affinity_dtype)
        col = _sum_on([kernel_ops.nystrom_colsum(xs, zz, gamma, mask, **kw)
                       for (xs, mask), zz in zip(shards, zs)], home)
        us = _to_all(_degree_direction(w_isqrt, col), mesh)
        mm = _sum_on([kernel_ops.nystrom_gram(xs, zz, gamma, u, wi, mask,
                                              **kw)
                      for (xs, mask), zz, u, wi in zip(shards, zs, us, ws)],
                     home)
        lam, basis = _solve_operator(mm, k, use_pallas=True, **solve)
        projs = _to_all(_fused_projection(w_isqrt, basis, lam, k), mesh)
        parts = [kernel_ops.nystrom_extension(xs, zz, gamma, u, proj, mask,
                                              **kw)
                 for (xs, mask), zz, u, proj in zip(shards, zs, us, projs)]
    else:
        cs = []
        for (xs, mask), zz in zip(shards, zs):
            c = cross_affinity(xs, zz, gamma=gamma, use_pallas=use_pallas)
            cs.append(c if mask is None else c * mask[:, None])
        col = _sum_on([c.sum(0) for c in cs], home)
        us = _to_all(_degree_direction(w_isqrt, col), mesh)
        ss = [_degree_normalize(c, u) for c, u in zip(cs, us)]
        sts = _sum_on([s.T @ s for s in ss], home)
        lam, basis = _solve_operator(w_isqrt @ sts @ w_isqrt, k, **solve)
        wb, scale = _extension_factors(w_isqrt, basis, lam, k)
        parts = [row_normalize((s @ wbs) * sc)
                 for s, wbs, sc in zip(ss, _to_all(wb, mesh),
                                       _to_all(scale, mesh))]
    y = torch.cat([v.to(home) for v in parts])[:n]
    return y, 1.0 - lam, basis, w_basis
