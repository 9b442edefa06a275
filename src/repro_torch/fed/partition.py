"""Non-IID partitioning of a dataset across federated clients.

A copy of the JAX package's ``fed/partition.py`` (pure numpy): the same
seed gives the same shards, bit for bit.

The paper parameterizes heterogeneity with σ ∈ {0, 0.5, 0.8, 1} but never
defines it; we map it onto the standard Dirichlet(α) label-skew knob
(Hsu et al. 2019), preserving the paper's ordering "σ=1 ⇒ hardest
non-IID":

    σ:    0.0    0.5    0.8    1.0
    α:  1000.0   1.0    0.3    0.1
"""

from __future__ import annotations

import numpy as np

_SIGMA_TABLE = {0.0: 1000.0, 0.5: 1.0, 0.8: 0.3, 1.0: 0.1}


def sigma_to_alpha(sigma: float) -> float:
    if sigma in _SIGMA_TABLE:
        return _SIGMA_TABLE[sigma]
    # smooth interpolation for off-grid sigmas
    return float(np.interp(sigma, [0.0, 0.5, 0.8, 1.0],
                           [1000.0, 1.0, 0.3, 0.1]))


def partition_non_iid(y: np.ndarray, num_clients: int, sigma: float,
                      *, seed: int = 0, min_per_client: int = 8):
    """Dirichlet label-skew split.  Returns list of index arrays."""
    alpha = sigma_to_alpha(sigma)
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    idx_by_class = [np.flatnonzero(y == c) for c in classes]
    for idx in idx_by_class:
        rng.shuffle(idx)

    client_indices = [[] for _ in range(num_clients)]
    for idx in idx_by_class:
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            client_indices[cid].append(part)
    out = [np.concatenate(parts) for parts in client_indices]

    # guarantee a minimum shard size so local SGD is well-defined
    pool = np.concatenate(out)
    for cid in range(num_clients):
        if len(out[cid]) < min_per_client:
            extra = rng.choice(pool, size=min_per_client - len(out[cid]),
                               replace=False)
            out[cid] = np.concatenate([out[cid], extra])
        rng.shuffle(out[cid])
    return out


def label_histogram(y: np.ndarray, indices, num_classes: int) -> np.ndarray:
    """Per-client class histograms — used by tests & the K-Center policy."""
    return np.stack([np.bincount(y[idx], minlength=num_classes)
                     for idx in indices]).astype(np.float32)
