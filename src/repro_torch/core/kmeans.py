"""K-means(++) — the final stage of Algorithm I (spectral clustering).

Fixed-iteration Lloyd loop; k-means++ seeding by D² sampling.  Random
draws come from an explicit CPU ``torch.Generator``: the uniforms are
drawn on the CPU and the inverse-CDF lookup runs on the data's device,
so the same generator picks the same seeds on the card and on the CPU
(up to ties at a CDF boundary).
"""

from __future__ import annotations

import torch


def pairwise_sq_dists(x, y):
    """(n, d), (m, d) -> (n, m) squared euclidean distances."""
    xn = (x * x).sum(-1)[:, None]
    yn = (y * y).sum(-1)[None, :]
    return torch.clamp_min(xn + yn - 2.0 * (x @ y.T), 0.0)


def weighted_draw(weights, u):
    """Index drawn ∝ ``weights`` (1-D, ≥ 0) by the uniform(s) ``u``.

    Inverse CDF in float64 on the weights' device; the result stays on
    the device (no host sync).
    """
    cdf = torch.cumsum(weights.double(), 0)
    idx = torch.searchsorted(cdf, (u.double() * cdf[-1]).reshape(1),
                             right=True)
    return torch.clamp_max(idx, weights.shape[0] - 1)[0]


def kmeans_plus_plus_init(generator, x, k: int):
    """k-means++ seeding: first center uniform, then D² sampling."""
    n = x.shape[0]
    first = torch.randint(n, (), generator=generator)
    draws = torch.rand(max(k - 1, 0), generator=generator).to(x.device)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first.to(x.device)]
    dmin = pairwise_sq_dists(x, centers[:1])[:, 0]
    for i in range(1, k):
        idx = weighted_draw(dmin / torch.clamp_min(dmin.sum(), 1e-12),
                            draws[i - 1])
        centers[i] = x[idx]
        dmin = torch.minimum(dmin, pairwise_sq_dists(x, centers[i:i + 1])[:, 0])
    return centers


def _lloyd(x, centers, iters: int):
    """Lloyd iterations from ``centers``; returns (assign (n,), centers).

    A cluster that empties keeps its old center.
    """
    k = centers.shape[0]
    for _ in range(iters):
        assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ x) / torch.clamp_min(counts[:, None], 1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)
    assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
    return assign, centers


def kmeans(generator, x, k: int, iters: int = 25):
    """k-means++ seeding + Lloyd.  Returns (assignments (n,), centers)."""
    return _lloyd(x, kmeans_plus_plus_init(generator, x, k), iters)
