"""Landmark selection strategies for the Nyström cohort path.

* ``"uniform"`` — m indices without replacement.
* ``"kmeans++"`` — D² (farthest-point-weighted) sampling over a uniform
  pool of ``32·m`` points, with an incrementally maintained min-distance
  vector, so every well-separated mode gets a landmark whatever its
  population.
* ``"leverage"`` — approximate ridge leverage scores (Musco & Musco,
  2017) against a uniform pilot set, then m landmarks ∝ ℓ without
  replacement (Gumbel top-m).

Every draw comes from an explicit CPU ``torch.Generator`` and the indices
are moved to the data's device afterwards, so a strategy is a pure
function of its generator's state and gives the same landmarks on the
card and on the CPU (the data-dependent strategies up to ties at a
sampling boundary).
"""

from __future__ import annotations

import torch

from repro_torch.core.kmeans import pairwise_sq_dists, weighted_draw

_EPS = 1e-12

#: pool oversampling factor for the kmeans++ strategy
_KPP_POOL_FACTOR = 32
#: pilot-set size cap for approximate leverage scores
_LEVERAGE_PILOT_CAP = 512


def uniform_landmarks(generator, x, m: int):
    """m indices sampled uniformly without replacement."""
    n = x.shape[0]
    return torch.randperm(n, generator=generator)[:m].to(x.device)


def kmeanspp_landmarks(generator, x, m: int):
    """D²-sampled landmark indices (k-means++ seeding over a pool)."""
    n = x.shape[0]
    pool_n = min(n, max(_KPP_POOL_FACTOR * m, 4 * m))
    pool_idx = torch.randperm(n, generator=generator)[:pool_n].to(x.device)
    first = torch.randint(pool_n, (), generator=generator)
    draws = torch.rand(max(m - 1, 0), generator=generator).to(x.device)
    pool = x[pool_idx].float()
    picked = torch.zeros((m,), dtype=torch.long, device=x.device)
    picked[0] = first.to(x.device)
    dmin = ((pool - pool[picked[0]]) ** 2).sum(1)
    for i in range(1, m):
        nxt = weighted_draw(dmin / torch.clamp_min(dmin.sum(), _EPS),
                            draws[i - 1])
        picked[i] = nxt
        dmin = torch.minimum(dmin, ((pool - pool[nxt]) ** 2).sum(1))
    return pool_idx[picked]


def leverage_landmarks(generator, x, m: int, *, gamma=None):
    """Indices sampled ∝ approximate ridge leverage of the RBF kernel.

    ℓ_i = c_iᵀ (W_P + λI)⁻¹ c_i with c_i the affinity of point i to a
    uniform pilot set P (|P| ≤ 512) and λ = tr(W_P)/|P|.
    """
    from repro_torch.core.spectral import auto_gamma

    n = x.shape[0]
    x = x.float()
    p = min(n, max(m, 256), _LEVERAGE_PILOT_CAP)
    pilot = x[torch.randperm(n, generator=generator)[:p].to(x.device)]
    gumbel = -torch.log(-torch.log(
        torch.rand(n, generator=generator, dtype=torch.float64)
        .clamp(1e-300, 1.0 - 1e-16))).to(x.device)
    d2 = pairwise_sq_dists(x, pilot)                       # (n, p)
    if gamma is None:
        gamma = auto_gamma(d2)
    c = torch.exp(-gamma * d2)
    w = torch.exp(-gamma * pairwise_sq_dists(pilot, pilot))
    lam = torch.trace(w) / p
    eye = torch.eye(p, dtype=w.dtype, device=w.device)
    ew, uw = torch.linalg.eigh(w + lam * eye)
    cu = c @ uw                                            # (n, p)
    scores = (cu * cu / torch.clamp_min(ew, _EPS)[None, :]).sum(1)
    keys = torch.log(scores.double()) + gumbel
    return torch.topk(keys, m).indices


LANDMARK_STRATEGIES = ("uniform", "kmeans++", "leverage")


def select_landmarks(generator, x, m: int, strategy: str = "uniform", *,
                     gamma=None):
    """Dispatch to a landmark strategy; returns (m,) indices into x."""
    if strategy == "uniform":
        return uniform_landmarks(generator, x, m)
    if strategy == "kmeans++":
        return kmeanspp_landmarks(generator, x, m)
    if strategy == "leverage":
        return leverage_landmarks(generator, x, m, gamma=gamma)
    raise ValueError(
        f"unknown landmark strategy {strategy!r}; "
        f"expected one of {LANDMARK_STRATEGIES}")
