"""Spectral clustering pieces of Algorithm I that the cohort engine uses.

  A       = affinity matrix (RBF over pairwise distances)
  L_norm  = I - D^{-1/2} A D^{-1/2}    (normalized Laplacian)
  X       = first k eigenvectors of L_norm (smallest eigenvalues)
  Y       = row-normalized X

The dense path (``affinity_matrix`` + ``spectral_embedding``) is plain
PyTorch; its Pallas affinity kernel (``use_pallas=True``) is not ported
yet.  The Nyström path lives in :mod:`repro_torch.cohort.nystrom`.
"""

from __future__ import annotations

import torch

from repro_torch.core.kmeans import pairwise_sq_dists

_EPS = 1e-12
# gamma estimation subsamples the distance matrix beyond this many rows
_GAMMA_SAMPLE_ROWS = 4096


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} has no CUDA kernel in the port yet (ROADMAP {item}); "
        f"use use_pallas=False")


def auto_gamma(d2):
    """Median heuristic: gamma = 1 / (2 · median of positive distances).

    The median averages the two middle values of an even-count sample,
    as ``jnp.nanmedian`` does (``torch.nanmedian`` would return the lower
    one).  No positive entry gives a median of 1.
    """
    if d2.shape[0] > _GAMMA_SAMPLE_ROWS:
        d2 = d2[:_GAMMA_SAMPLE_ROWS]
    vals = d2[d2 > 0]
    count = vals.numel()
    if count == 0:
        med = torch.ones((), dtype=d2.dtype, device=d2.device)
    else:
        vals, _ = torch.sort(vals)
        lo = vals[(count - 1) // 2]
        hi = vals[count // 2]
        med = 0.5 * lo + 0.5 * hi
    return 1.0 / torch.clamp_min(2.0 * med, _EPS)


def affinity_matrix(x, *, gamma: float | None = None,
                    use_pallas: bool = False):
    """RBF affinity A_ij = exp(-gamma ||x_i - x_j||^2), zero diagonal."""
    if use_pallas:
        raise _not_ported("the dense pairwise-distance path", "B7")
    d2 = pairwise_sq_dists(x, x)
    eye = torch.eye(x.shape[0], dtype=d2.dtype, device=d2.device)
    if gamma is None:
        # zero the diagonal first: the matmul form leaves tiny positive
        # self-distances that would bias the median low
        gamma = auto_gamma(d2 * (1.0 - eye))
    return torch.exp(-gamma * d2) * (1.0 - eye)


def cross_affinity(x, z, *, gamma, use_pallas: bool = False):
    """Rectangular RBF affinity exp(-gamma ||x_i - z_j||²), (n, m)."""
    if use_pallas:
        raise _not_ported("the unfused cross-affinity path", "B6")
    return torch.exp(-gamma * pairwise_sq_dists(x, z))


def normalized_laplacian(a):
    d = a.sum(1)
    inv_sqrt = torch.rsqrt(torch.clamp_min(d, _EPS))
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    return eye - a * inv_sqrt[:, None] * inv_sqrt[None, :]


def row_normalize(x):
    """Rows scaled to unit norm (the Y step of Algorithm I)."""
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp_min(norms, _EPS)


def spectral_embedding(a, k: int, *, solver: str = "eigh", iters: int = 60):
    """First-k eigenvectors of L_norm (ascending eigenvalues), row-normed.

    ``solver="eigh"`` — exact; ``solver="subspace"`` — orthogonal
    iteration on 2I − L_norm plus a Rayleigh–Ritz rotation, returning
    only k eigenvalues.
    """
    if solver == "eigh":
        evals, evecs = torch.linalg.eigh(normalized_laplacian(a))
        x = evecs[:, :k]
    elif solver == "subspace":
        x, evals = _subspace_smallest_k(a, k, iters=iters)
    else:
        raise ValueError(f"unknown solver: {solver!r}")
    return row_normalize(x), evals


def _subspace_smallest_k(a, k: int, *, iters: int = 60):
    """Smallest-k eigenpairs of L_norm = I − A_norm without full eigh."""
    n = a.shape[0]
    d = a.sum(1)
    inv_sqrt = torch.rsqrt(torch.clamp_min(d, _EPS))
    a_norm = a * inv_sqrt[:, None] * inv_sqrt[None, :]
    # fixed range start: subspace iteration converges from any full-rank
    # start, and a fixed seed keeps the solver reproducible
    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn((n, k), generator=gen, dtype=a.dtype).to(a.device)
    q, _ = torch.linalg.qr(q0)
    for _ in range(iters):
        q, _ = torch.linalg.qr(q + a_norm @ q)
    t = q.T @ (q - a_norm @ q)
    t = 0.5 * (t + t.T)
    evals, u = torch.linalg.eigh(t)
    return q @ u, evals


def default_num_landmarks(n: int, k: int) -> int:
    return min(n, max(8 * k, 64))


def eigengap_k(evals, max_k: int = 10) -> int:
    """Paper §3.4: number of eigenvalues before the first large gap."""
    evals = torch.as_tensor(evals)
    gaps = torch.diff(evals[: max_k + 1])
    return int(torch.argmax(gaps)) + 1
