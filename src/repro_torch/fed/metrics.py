"""Serving-state statistics and evaluation criteria.

Copies of the numpy helpers of the JAX package's ``fed/metrics.py``: the
serving state the cohort server feeds
:class:`repro_torch.policy.ClusterPolicy` with, the paper's Table 3
criteria (:func:`classification_metrics`), plus FAVOR's reward shaping
(``core/selection.py::favor_reward`` there).  Pure numpy: all of it is
computed on the host.

* ``"basic"`` — ``3k + 1``: population fraction ‖ participation
  fraction ‖ reward EMA ‖ previous accuracy.
* ``"rich"``  — ``5k + 1``: the basic features plus per-cluster
  embedding dispersion and staleness.
* ``"system"`` — ``7k + 1``: the rich features plus per-cluster
  availability and latency EMAs from client-realism round outcomes
  (``CohortServer.observe_round(outcome=...)``).
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


def confusion(y_true: np.ndarray, y_pred: np.ndarray, k: int) -> np.ndarray:
    cm = np.zeros((k, k), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def _midranks(scores: np.ndarray) -> np.ndarray:
    """1-based midranks: tied scores share the mean of their positions.

    The double-argsort trick assigns ties arbitrary *ordinal* ranks
    (whichever came first in memory wins), which biases the
    Mann–Whitney U statistic whenever logits tie — e.g. saturated
    softmax outputs or integer-ish scores.  Midranks are the standard
    tie correction: AUC under ties is then the probability of a correct
    ranking with ties counted as 1/2.
    """
    order = np.argsort(scores, kind="stable")
    sorted_scores = scores[order]
    n = len(scores)
    ranks = np.empty(n, np.float64)
    i = 0
    while i < n:
        j = i
        while j < n and sorted_scores[j] == sorted_scores[i]:
            j += 1
        ranks[i:j] = 0.5 * (i + j - 1) + 1.0     # mean of 1-based i+1..j
        i = j
    out = np.empty(n, np.float64)
    out[order] = ranks
    return out


def classification_metrics(y_true: np.ndarray, logits: np.ndarray) -> dict:
    k = logits.shape[-1]
    y_pred = np.argmax(logits, axis=-1)
    cm = confusion(y_true, y_pred, k)
    total = cm.sum()
    acc = np.trace(cm) / max(total, 1)

    per_class_recall = np.divide(np.diag(cm), cm.sum(axis=1),
                                 out=np.zeros(k), where=cm.sum(axis=1) > 0)
    per_class_prec = np.divide(np.diag(cm), cm.sum(axis=0),
                               out=np.zeros(k), where=cm.sum(axis=0) > 0)
    balanced_acc = per_class_recall.mean()
    recall = per_class_recall.mean()
    precision = per_class_prec.mean()

    # Cohen's kappa
    pe = float((cm.sum(axis=0) * cm.sum(axis=1)).sum()) / max(total ** 2, 1)
    kappa = (acc - pe) / max(1 - pe, 1e-12)

    # macro one-vs-rest AUC via the Mann–Whitney rank statistic, with
    # midranks so tied logits contribute 1/2 instead of an order-of-
    # appearance bias
    aucs = []
    for c in range(k):
        pos = logits[y_true == c, c]
        neg = logits[y_true != c, c]
        if len(pos) == 0 or len(neg) == 0:
            continue
        ranks = _midranks(np.concatenate([pos, neg]))
        auc = (ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2) \
            / (len(pos) * len(neg))
        aucs.append(auc)
    auc = float(np.mean(aucs)) if aucs else 0.5

    return {"balanced_accuracy": float(balanced_acc), "accuracy": float(acc),
            "recall": float(recall), "kappa": float(kappa),
            "precision": float(precision), "auc": auc}
