"""Spectral clustering — Algorithm I of the paper, in PyTorch.

  A       = affinity matrix (RBF over pairwise distances)
  L_norm  = I - D^{-1/2} A D^{-1/2}    (normalized Laplacian)
  X       = first k eigenvectors of L_norm (smallest eigenvalues)
  Y       = row-normalized X
  cluster rows of Y with k-means; assign point i to cluster of row i.

``use_pallas=True`` routes the affinity through the hand-written kernels
(:mod:`repro_torch.kernels.ops`: CUDA on the card, the plain versions on
the CPU).  ``method="dense"`` is the exact path; ``method="nystrom"``
samples m landmarks and delegates to the landmark-explicit core in
:mod:`repro_torch.cohort.nystrom`.  Random draws come from explicit CPU
``torch.Generator``s, so the same generator picks the same landmarks and
k-means++ seeds on the card and on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.kmeans import kmeans, pairwise_sq_dists
from repro_torch.kernels import ops as kernel_ops

_EPS = 1e-12
# gamma estimation subsamples the distance matrix beyond this many rows
_GAMMA_SAMPLE_ROWS = 4096


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
        xc = x.contiguous()
        d2 = kernel_ops.pairwise_sq_dists(xc, xc)
    else:
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
        return kernel_ops.rbf_cross_affinity(x.contiguous(), z.contiguous(),
                                             gamma)
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
    # start, and a fixed seed keeps the solver reproducible without
    # plumbing a generator through the public API
    # repro-lint: ignore[torch-constant-seed]
    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn((n, k), generator=gen, dtype=a.dtype).to(a.device)
    q, _ = torch.linalg.qr(q0)
    for _ in range(iters):
        q, _ = torch.linalg.qr(q + a_norm @ q)
    t = q.T @ (q - a_norm @ q)
    t = 0.5 * (t + t.T)
    evals, u = torch.linalg.eigh(t)
    return q @ u, evals


def nystrom_spectral_embedding(generator, x, k: int, num_landmarks: int, *,
                               gamma: float | None = None,
                               use_pallas: bool = False):
    """Approximate normalized-Laplacian embedding via Nyström landmarks.

    Samples m UNIFORM landmarks (without replacement, from the CPU
    ``generator``) and delegates the one-shot Nyström extension to
    :func:`repro_torch.cohort.nystrom.nystrom_from_landmarks`.  Returns
    (Y row-normalized (n, k), evals of L_norm ascending (m,)).
    """
    # deferred import: cohort builds on core, not the other way around
    from repro_torch.cohort.nystrom import nystrom_from_landmarks

    n = x.shape[0]
    m = min(int(num_landmarks), n)
    if m < k:
        raise ValueError(f"num_landmarks={m} must be >= k={k}")
    x = x.float()
    idx = torch.randperm(n, generator=generator)[:m].to(x.device)
    if gamma is None:
        rows = x[:min(n, _GAMMA_SAMPLE_ROWS)]
        gamma = auto_gamma(pairwise_sq_dists(rows, x[idx]))
    y, evals, _, _ = nystrom_from_landmarks(x, idx, k, gamma,
                                            use_pallas=use_pallas)
    return y, evals


def default_num_landmarks(n: int, k: int) -> int:
    return min(n, max(8 * k, 64))


def eigengap_k(evals, max_k: int = 10) -> int:
    """Paper §3.4: number of eigenvalues before the first large gap."""
    evals = torch.as_tensor(evals)
    gaps = torch.diff(evals[: max_k + 1])
    return int(torch.argmax(gaps)) + 1


def split_generator(generator):
    """Two independent CPU generators seeded from ``generator`` (or two
    ``None``s for a ``None``)."""
    if generator is None:
        return None, None
    seeds = torch.randint(0, 2 ** 62, (2,), generator=generator)
    return tuple(torch.Generator().manual_seed(int(v)) for v in seeds)


def spectral_cluster(generator, x, k: int, *, gamma: float | None = None,
                     use_pallas: bool = False, method: str = "dense",
                     num_landmarks: int | None = None, solver: str = "eigh",
                     landmark_generator=None):
    """Full Algorithm I.  x: (n, d) points -> (assignments, Y, evals).

    ``method="dense"`` computes the exact n×n affinity (``solver`` picks
    the eigensolver); ``method="nystrom"`` uses ``num_landmarks`` sampled
    landmarks (default min(n, max(8k, 64))).  ``generator`` (CPU) is
    split into a k-means and a landmark generator; ``landmark_generator``
    pins the landmark draw independently of k-means.
    """
    km_gen, lm_gen = split_generator(generator)
    if landmark_generator is not None:
        if method != "nystrom":
            raise ValueError(
                "landmark_generator only applies to method='nystrom'")
        lm_gen = landmark_generator
    if method == "dense":
        if num_landmarks is not None:
            raise ValueError("num_landmarks only applies to method='nystrom'")
        a = affinity_matrix(x, gamma=gamma, use_pallas=use_pallas)
        y, evals = spectral_embedding(a, k, solver=solver)
    elif method == "nystrom":
        if solver != "eigh":
            raise ValueError("solver only applies to method='dense' "
                             "(the Nyström eigenproblem is m×m and always "
                             "uses eigh)")
        m = num_landmarks or default_num_landmarks(x.shape[0], k)
        y, evals = nystrom_spectral_embedding(
            lm_gen, x, k, m, gamma=gamma, use_pallas=use_pallas)
    else:
        raise ValueError(f"unknown method: {method!r}")
    assign, _ = kmeans(km_gen, y, k)
    return assign, y, evals
