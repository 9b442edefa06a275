"""Server-side aggregation (FedAvg) and weight-delta embeddings.

Port of the JAX package's ``fed/server.py`` over parameter dictionaries.
"""

from __future__ import annotations

import torch


def fedavg_aggregate(stacked_params, weights):
    """Weighted FedAvg.  stacked_params: {name: (K, ...)}; weights: (K,),
    normalized inside (client shard sizes, per McMahan)."""
    any_param = next(iter(stacked_params.values()))
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=any_param.device)
    w = w / torch.clamp_min(w.sum(), 1e-12)

    def mean(x):
        return (x * w.reshape((-1,) + (1,) * (x.dim() - 1))).sum(0)

    return {name: mean(x) for name, x in stacked_params.items()}


def params_delta(stacked_params, global_params):
    """Per-client parameter deltas vs the global model."""
    return {name: c - global_params[name][None]
            for name, c in stacked_params.items()}


def weight_delta_embedding(embedder, stacked_params, global_params):
    """Embed each cohort member's weight delta -> (K, dim) numpy."""
    return embedder.embed_many(params_delta(stacked_params, global_params))
