"""Serving-state statistics for the cluster-level DQN policy.

Copies of the numpy helpers of the JAX package's ``fed/metrics.py`` that
the cohort server feeds :class:`repro_torch.policy.ClusterPolicy` with,
plus FAVOR's reward shaping (``core/selection.py::favor_reward`` there).
Pure numpy: the state vector is built on the host either way.

* ``"basic"`` — ``3k + 1``: population fraction ‖ participation
  fraction ‖ reward EMA ‖ previous accuracy.
* ``"rich"``  — ``5k + 1``: the basic features plus per-cluster
  embedding dispersion and staleness.
* ``"system"`` — ``7k + 1``: the rich features plus per-cluster
  availability and latency EMAs from client-realism round outcomes
  (the server does not take outcomes yet, see ``launch/serve.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: recognised feature sets for :func:`cluster_policy_state`.
STATE_FEATURES = ("basic", "rich", "system")

#: per-cluster feature count of each layout (+1 for prev_accuracy).
_FEATURES_PER_CLUSTER = {"basic": 3, "rich": 5, "system": 7}


def favor_reward(accuracy: float, target: float, xi: float = 64.0) -> float:
    """FAVOR's reward shaping ``Ξ^(acc − target) − 1`` (paper §3.3)."""
    return float(xi ** (accuracy - target) - 1.0)


def serving_state_dim(k: int, features: str = "rich") -> int:
    """State-vector length of :func:`cluster_policy_state`."""
    if features not in STATE_FEATURES:
        raise ValueError(f"unknown state features {features!r}; "
                         f"expected one of {STATE_FEATURES}")
    return _FEATURES_PER_CLUSTER[features] * k + 1


def _check_per_cluster(name: str, arr: np.ndarray, k: int) -> np.ndarray:
    """A per-cluster stat vector must cover all k clusters (longer ones
    are sliced to ``[:k]``)."""
    arr = np.asarray(arr, np.float64).reshape(-1)
    if len(arr) < k:
        raise ValueError(
            f"cluster_policy_state: {name} has length {len(arr)} but "
            f"k={k} clusters; per-cluster stats must cover every "
            f"cluster (pad missing clusters with zeros upstream)")
    return arr[:k]


def cluster_dispersion(embeds: np.ndarray, assign: np.ndarray,
                       k: int) -> np.ndarray:
    """Per-cluster embedding spread, scale-free and bounded to [0, 1).

    Mean squared distance of a cluster's members to its centroid over the
    global mean squared distance to the global centroid, squashed through
    ``x / (1 + x)``.  Empty clusters report 0.
    """
    embeds = np.asarray(embeds, np.float64)
    assign = np.asarray(assign)
    global_var = float(
        np.mean(np.sum((embeds - embeds.mean(axis=0)) ** 2, axis=1)))
    out = np.zeros(k, np.float64)
    if global_var <= 0.0:
        return out
    for c in range(k):
        members = embeds[assign == c]
        if len(members) == 0:
            continue
        var = float(np.mean(
            np.sum((members - members.mean(axis=0)) ** 2, axis=1)))
        ratio = var / global_var
        out[c] = ratio / (1.0 + ratio)
    return out


def cluster_policy_state(assign: np.ndarray, k: int,
                         participation: np.ndarray,
                         reward_ema: np.ndarray,
                         prev_accuracy: float,
                         *,
                         embeds: Optional[np.ndarray] = None,
                         staleness: Optional[np.ndarray] = None,
                         availability: Optional[np.ndarray] = None,
                         latency_s: Optional[np.ndarray] = None,
                         features: str = "rich") -> np.ndarray:
    """Serving-side DQN state: per-cluster stats + last global accuracy.

    Returns the float32 vector ``[population_frac ‖ participation_frac ‖
    reward_ema ( ‖ dispersion ‖ staleness_frac ( ‖ availability ‖
    latency_frac )) ‖ prev_accuracy]``; participation is uniform 1/k
    before any draw, staleness and latency are squashed to [0, 1).
    """
    if features not in STATE_FEATURES:
        raise ValueError(f"unknown state features {features!r}; "
                         f"expected one of {STATE_FEATURES}")
    n = max(len(assign), 1)
    pop = np.bincount(np.asarray(assign), minlength=k)[:k] / n
    participation = _check_per_cluster("participation", participation, k)
    reward = _check_per_cluster("reward_ema", reward_ema, k)
    total = participation.sum()
    part = (participation / total) if total > 0 else np.full(k, 1.0 / k)
    parts = [pop, part, reward]
    if features in ("rich", "system"):
        if embeds is None:
            raise ValueError(
                f"cluster_policy_state: features={features!r} needs the "
                "embedding table (embeds=) for the dispersion features; "
                "pass features='basic' for the participation-only state")
        if staleness is None:
            raise ValueError(
                f"cluster_policy_state: features={features!r} needs the "
                "per-cluster staleness counts (staleness=)")
        stale = _check_per_cluster("staleness", staleness, k)
        parts.append(cluster_dispersion(embeds, assign, k))
        parts.append(stale / (1.0 + stale))
    if features == "system":
        if availability is None or latency_s is None:
            raise ValueError(
                "cluster_policy_state: features='system' needs the "
                "per-cluster availability (availability=) and mean "
                "latency (latency_s=) EMAs")
        avail = np.clip(
            _check_per_cluster("availability", availability, k), 0.0, 1.0)
        lat = np.maximum(
            _check_per_cluster("latency_s", latency_s, k), 0.0)
        parts.append(avail)
        parts.append(lat / (1.0 + lat))
    parts.append([prev_accuracy])
    return np.concatenate(parts).astype(np.float32)
