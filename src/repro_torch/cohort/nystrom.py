"""Landmark-explicit Nyström embedding — the math core of the engine.

``nystrom_from_landmarks`` is the one-shot Nyström extension (Fowlkes et
al., 2004) with the landmark set as an input: the engine owns landmark
selection and warm-start state.  Two routes compute the same operator:

* ``fused=False`` materializes the (n, m) cross-affinity C in plain
  PyTorch and composes the extension from it (``_nystrom_core``);
* ``fused=True`` never materializes C: the column sum, the rotated SᵀS
  Gram and the row-normalized extension each rebuild C tile by tile
  inside a kernel (``_nystrom_core_fused``; CUDA on the card, the plain
  versions on the CPU), and W = A(z, z) goes through the same quantized
  tile math.

The m-sized products between the passes (``u = W⁻¹ᐟ²(W⁻¹ᐟ² col)`` and the
projector) stay ``torch.matmul``.  The tiled summation order rotates the
degenerate leading eigenspace, so compare rotation-invariant quantities
(eigenvalues, the ``y·yᵀ`` projector, partitions), not raw embeddings.

Both cores are written as steps split at the JAX package's two ``psum``
points: the column sum ``col`` (m,) and the rotated Gram (m, m) are the
only quantities summed over client rows.  The mesh-sharded twin
(``cohort/sharded.py``) runs the row-sized steps once per shard and the
m-sized ones (``_degree_direction``, ``_solve_operator``,
``_extension_factors``) once, between the two sums.
"""

from __future__ import annotations

import torch

from repro_torch.cohort.eigensolver import isqrt_from_eigs, topk_eigh
from repro_torch.core.kmeans import pairwise_sq_dists
from repro_torch.core.spectral import (cross_affinity, row_normalize,
                                      split_generator)
from repro_torch.kernels import ops as kernel_ops

_EPS = 1e-12


def _degree_direction(w_isqrt, col):
    """``u = W⁻¹ᐟ²(W⁻¹ᐟ² col)``: the approximate degrees are ``d̂ = C u``."""
    return w_isqrt @ (w_isqrt @ col)


def _degree_normalize(c, u):
    """S = C with each row scaled by ``rsqrt(d̂)``, ``d̂ = C u``."""
    return c * torch.rsqrt(torch.clamp_min(c @ u, _EPS))[:, None]


def _solve_operator(mm, k: int, *, mm_solver: str, mm_iters: int, mm_q0,
                    generator, block_rows: int, use_pallas: bool = False):
    """Symmetrize the summed operator M and take its top-k eigenpairs:
    ``(lam descending, basis (m, k))``."""
    mm = 0.5 * (mm + mm.T)
    r = mm.shape[0] if mm_solver == "eigh" else k
    lam, top = topk_eigh(mm, r, solver=mm_solver, iters=mm_iters, q0=mm_q0,
                         generator=generator, block_rows=block_rows,
                         use_pallas=use_pallas)
    return lam, top[:, :k]


def _extension_factors(w_isqrt, basis, lam, k: int):
    """``(W⁻¹ᐟ² basis, rsqrt(λ))``: V = S (W⁻¹ᐟ² basis) diag(rsqrt(λ))."""
    return (w_isqrt @ basis,
            torch.rsqrt(torch.clamp_min(lam[:k], _EPS))[None, :])


def _nystrom_core(c, w_isqrt, k: int, *, mm_solver: str = "eigh",
                  mm_iters: int = 30, mm_q0=None, generator=None,
                  block_rows: int = 2048):
    """Degree-normalize C, solve the m×m operator, extend to all rows.

    Returns ``(y_rownormed, evals_of_L_norm_ascending, mm_basis)``.
    """
    col = c.sum(0)                                             # (m,)
    s = _degree_normalize(c, _degree_direction(w_isqrt, col))
    mm = w_isqrt @ (s.T @ s) @ w_isqrt
    lam, basis = _solve_operator(mm, k, mm_solver=mm_solver,
                                 mm_iters=mm_iters, mm_q0=mm_q0,
                                 generator=generator, block_rows=block_rows)
    wb, scale = _extension_factors(w_isqrt, basis, lam, k)
    return row_normalize((s @ wb) * scale), 1.0 - lam, basis


def _nystrom_core_fused(x, z, gamma, w_isqrt, k: int, *, mask=None,
                        affinity_dtype: str = "f32",
                        mm_solver: str = "eigh", mm_iters: int = 30,
                        mm_q0=None, generator=None, block_rows: int = 2048):
    """Streaming twin of ``_nystrom_core``: C never hits device memory.

    colsum → rotated SᵀS Gram → row-normalized extension, each a kernel
    that rebuilds its C tiles from the raw rows ``x``.  ``mask`` zeroes
    rows; ``affinity_dtype`` picks the tile precision.
    """
    col = kernel_ops.nystrom_colsum(x, z, gamma, mask,
                                    affinity_dtype=affinity_dtype)
    u = _degree_direction(w_isqrt, col)                        # (m,)
    mm = kernel_ops.nystrom_gram(x, z, gamma, u, w_isqrt, mask,
                                 affinity_dtype=affinity_dtype)
    lam, basis = _solve_operator(mm, k, mm_solver=mm_solver,
                                 mm_iters=mm_iters, mm_q0=mm_q0,
                                 generator=generator, block_rows=block_rows,
                                 use_pallas=True)
    proj = _fused_projection(w_isqrt, basis, lam, k)           # (m, k)
    v = kernel_ops.nystrom_extension(x, z, gamma, u, proj, mask,
                                     affinity_dtype=affinity_dtype)
    return v, 1.0 - lam, basis


def _fused_projection(w_isqrt, basis, lam, k: int):
    """The extension kernel's (m, k) projector ``W⁻¹ᐟ² basis rsqrt(λ)``."""
    wb, scale = _extension_factors(w_isqrt, basis, lam, k)
    return (wb * scale).contiguous()


def landmark_block_isqrt(z, gamma, *, w=None, w_solver: str = "eigh",
                         w_rank: int | None = None, iters: int = 30,
                         w_q0=None, generator=None, block_rows: int = 2048,
                         use_pallas: bool = False):
    """W^{-1/2} of the landmark affinity block, plus its eigenbasis.

    ``w`` overrides the affinity block (callers pass the block built on
    the same route as C).  Returns ``(w_isqrt (m, m), w_basis (m, r))``.
    """
    m = z.shape[0]
    if w is None:
        w = torch.exp(-gamma * pairwise_sq_dists(z, z))
    w = 0.5 * (w + w.T)
    r = m if w_solver == "eigh" else min(m, w_rank or m)
    ew, uw = topk_eigh(w, r, solver=w_solver, iters=iters, q0=w_q0,
                       generator=generator, block_rows=block_rows,
                       use_pallas=use_pallas)
    return isqrt_from_eigs(ew, uw), uw


def nystrom_from_landmarks(x, idx, k: int, gamma, *,
                           use_pallas: bool = False,
                           fused: bool = False,
                           affinity_dtype: str = "f32",
                           w_solver: str = "eigh",
                           w_rank: int | None = None,
                           mm_solver: str = "eigh", iters: int = 30,
                           w_q0=None, mm_q0=None, generator=None,
                           block_rows: int = 2048):
    """Nyström normalized-Laplacian embedding from an explicit landmark set.

    x: (n, d) points; idx: (m,) landmark indices into x (on x's device);
    gamma: RBF bandwidth.  Returns ``(y, evals, mm_basis, w_basis)``:

    * ``y`` — (n, k) row-normalized embedding;
    * ``evals`` — ascending spectrum of the approximate L_norm (length m
      for ``mm_solver="eigh"``, k for ``"subspace"``);
    * ``mm_basis`` / ``w_basis`` — the eigenbases a later call can
      warm-start from (``mm_q0`` / ``w_q0``).

    ``generator`` (CPU) seeds the subspace solvers' cold ranges.
    """
    x = x.float()
    z = x[idx].contiguous()
    w_gen, mm_gen = split_generator(generator)
    if fused:
        # W through the same quantized tile math as the streamed C tiles
        w = kernel_ops.quantized_cross_affinity(
            z, z, gamma, affinity_dtype=affinity_dtype)
        w_isqrt, w_basis = landmark_block_isqrt(
            z, gamma, w=w, w_solver=w_solver, w_rank=w_rank, iters=iters,
            w_q0=w_q0, generator=w_gen, block_rows=block_rows,
            use_pallas=True)
        y, evals, basis = _nystrom_core_fused(
            x, z, gamma, w_isqrt.contiguous(), k,
            affinity_dtype=affinity_dtype, mm_solver=mm_solver,
            mm_iters=iters, mm_q0=mm_q0, generator=mm_gen,
            block_rows=block_rows)
        return y, evals, basis, w_basis
    c = cross_affinity(x, z, gamma=gamma, use_pallas=use_pallas)  # (n, m)
    # W = the landmark rows of C, on the same route as C
    w_isqrt, w_basis = landmark_block_isqrt(
        z, gamma, w=c[idx], w_solver=w_solver, w_rank=w_rank, iters=iters,
        w_q0=w_q0, generator=w_gen, block_rows=block_rows)
    y, evals, basis = _nystrom_core(
        c, w_isqrt, k, mm_solver=mm_solver, mm_iters=iters, mm_q0=mm_q0,
        generator=mm_gen, block_rows=block_rows)
    return y, evals, basis, w_basis
