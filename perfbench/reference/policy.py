"""Plain reference of a tenant's cluster policy, followed round by round
from the start (Algorithm II as the cohort server serves it).

A round is a draw and, once the round's accuracy is reported, an
update.  The draw: the serving state of the solve's partition (each
cluster's population share, its share of the clients drawn so far, its
reward average, its dispersion, its staleness squashed to [0, 1), and
the last accuracy); the action values of that state; one epsilon-greedy
cluster a cohort slot, the greedy one the first non-empty cluster in
the order of the action values; each slot's client popped from its
cluster's pool, the pools shuffled first.  The update: the reward
``XI^(accuracy - target) - 1`` (FAVOR's shaping, paper section 3.3)
into the average of each cluster the round drew from, one transition a
slot into a ring buffer, and one TD minibatch drawn uniformly from it.

The draws of the server's random generator (seeded with the tenant's
seed) are followed in the order the server makes them, so the reference
draws the same minibatches and the same epsilon coins.  The partition a
round drew from and the order of the action values are the program's
outputs, which the reference reads only to judge the draw: the
partition is judged against the reference's solve elsewhere, and the
action values here.  Everything else (the state, the rewards, the
buffer, the networks and their updates) is worked out again.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import dqn

XI = 64.0            # FAVOR's reward base
REWARD_EMA = 0.2     # the server's per-cluster reward average's step


def dispersion(table: np.ndarray, assign: np.ndarray, k: int,
               dtype) -> np.ndarray:
    """Each cluster's mean squared distance to its centroid over the
    table's to its own, squashed by x / (1 + x); 0 for an empty one.
    A mean squared distance is taken as the mean squared norm less the
    centroid's squared norm."""
    y = np.asarray(table, dtype)
    assign = np.asarray(assign, np.intp)
    sq = np.einsum("ij,ij->i", y, y)
    counts = np.bincount(assign, minlength=k)[:k]
    sums = np.stack([np.bincount(assign, weights=y[:, j], minlength=k)[:k]
                     for j in range(y.shape[1])], axis=1)
    mean = sums.sum(axis=0) / len(y)
    total = sq.mean() - mean @ mean
    out = np.zeros(k, dtype)
    if total <= 0:
        return out
    per = np.maximum(counts, 1)
    centers = sums / per[:, None]
    var = (np.bincount(assign, weights=sq, minlength=k)[:k] / per
           - np.einsum("ij,ij->i", centers, centers))
    ratio = var / total
    out[counts > 0] = (ratio / (1.0 + ratio))[counts > 0]
    return out


class TenantPolicy:
    """One tenant's policy and its serving state, followed in
    ``dtype`` (float64: the judge; float32 with ``tf32``: the
    control)."""

    def __init__(self, seed: int, k: int, target_accuracy: float,
                 cfg: dict, *, dtype=torch.float64, tf32: bool = False):
        self.k, self.target, self.cfg = k, target_accuracy, cfg
        self.dtype, self.tf32 = dtype, tf32
        self.np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.rng = np.random.default_rng(seed)
        self.state_dim = 5 * k + 1
        dims = [self.state_dim, *cfg["hidden"], k]
        self.initial = dqn.initial_weights(seed, dims)
        self.net = [(w.to(dtype), b.to(dtype)) for w, b in self.initial]
        self.target_net = [(w.clone(), b.clone()) for w, b in self.net]
        self.momentum = None
        cap = cfg["buffer_size"]
        self.buf = {"s": torch.zeros((cap, self.state_dim), dtype=dtype),
                    "a": torch.zeros(cap, dtype=torch.long),
                    "r": torch.zeros(cap, dtype=dtype),
                    "s2": torch.zeros((cap, self.state_dim), dtype=dtype),
                    "done": torch.zeros(cap, dtype=dtype)}
        self.size = self.ptr = 0
        self.steps = self.train_calls = 0
        self.grad_sq = [0.0] * (2 * len(self.net))
        self.participation = np.zeros(k)
        self.reward_ema = np.zeros(k)
        self.staleness = np.zeros(k)
        self.prev_accuracy = 0.0
        self.pending = None

    # -- the state and the action values -------------------------------
    def state(self, pop: np.ndarray, disp: np.ndarray) -> np.ndarray:
        """The state of a partition with population shares ``pop`` and
        dispersions ``disp``, at the serving statistics held now."""
        k = self.k
        total = self.participation.sum()
        part = (self.participation / total if total > 0
                else np.full(k, 1.0 / k))
        parts = [pop, part, self.reward_ema, disp,
                 self.staleness / (1.0 + self.staleness),
                 [self.prev_accuracy]]
        return np.concatenate(parts).astype(self.np_dtype)

    def q_values(self, state: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(state, dtype=self.dtype)[None]
        return dqn.forward(self.net, x, tf32=self.tf32)[0][0].numpy()

    def epsilon(self) -> float:
        c = self.cfg
        frac = min(self.steps / max(c["eps_decay_steps"], 1), 1.0)
        return float(c["eps_start"] + (c["eps_end"] - c["eps_start"]) * frac)

    # -- a round ---------------------------------------------------------
    def draw(self, assign: np.ndarray, table: np.ndarray, order_q,
             cohort_size: int) -> tuple:
        """(state, action values, ids, actions) of a select answered
        with ``assign``; the greedy order is that of ``order_q``, the
        action values the program drew with."""
        k = self.k
        pop = np.bincount(assign, minlength=k)[:k] / max(len(assign), 1)
        disp = dispersion(table, assign, k, self.np_dtype)
        state = self.state(pop, disp)
        q = self.q_values(state)
        self.steps += 1
        eps = self.epsilon()
        pools = [np.flatnonzero(assign == c) for c in range(k)]
        for pool in pools:
            self.rng.shuffle(pool)
        left = [len(pool) for pool in pools]
        order = np.argsort(-np.asarray(order_q))
        ids, actions = [], []
        while len(ids) < cohort_size:
            if self.rng.random() < eps:
                c = int(self.rng.integers(k))
            else:
                c = int(next((c for c in order if left[c]), order[0]))
            if not left[c]:
                nonempty = [cc for cc in range(k) if left[cc]]
                if not nonempty:
                    break
                c = int(self.rng.choice(nonempty))
            left[c] -= 1
            ids.append(int(pools[c][left[c]]))
            actions.append(c)
        drawn = np.asarray(ids, np.int64)
        if len(drawn):
            np.add.at(self.participation, assign[drawn], 1.0)
        self.staleness += 1.0
        if len(drawn):
            self.staleness[np.unique(assign[drawn])] = 0.0
        self.pending = (state, actions, pop, disp)
        return state, q, drawn, actions

    def observe(self, accuracy: float) -> None:
        """The round's report: the reward, the transitions, one update."""
        state, actions, pop, disp = self.pending
        self.pending = None
        reward = XI ** (accuracy - self.target) - 1.0
        for c in set(actions):
            self.reward_ema[c] += REWARD_EMA * (reward - self.reward_ema[c])
        self.prev_accuracy = accuracy
        nxt = self.state(pop, disp)
        cap = self.cfg["buffer_size"]
        for a in actions:
            i = self.ptr
            self.buf["s"][i] = torch.as_tensor(state, dtype=self.dtype)
            self.buf["a"][i] = int(a)
            self.buf["r"][i] = reward
            self.buf["s2"][i] = torch.as_tensor(nxt, dtype=self.dtype)
            self.buf["done"][i] = 0.0
            self.ptr = (i + 1) % cap
            self.size = min(self.size + 1, cap)
        self.train()

    def train(self) -> None:
        c = self.cfg
        if self.size < 8:
            return
        idx = torch.as_tensor(self.rng.integers(
            0, self.size, size=min(c["batch_size"], self.size)))
        batch = {key: v[idx] for key, v in self.buf.items()}
        _, grads = dqn.td_gradient(self.net, self.target_net, batch,
                                   c["gamma"], c["double_dqn"],
                                   tf32=self.tf32)
        flat = [g for pair in grads for g in pair]
        for j, g in enumerate(flat):
            self.grad_sq[j] += float((g.double() ** 2).sum())
        if self.momentum is None:
            self.momentum = [g.clone() for g in flat]
        else:
            self.momentum = [0.9 * m + g for m, g in zip(self.momentum, flat)]
        params = [p for pair in self.net for p in pair]
        params = [p - c["lr"] * m for p, m in zip(params, self.momentum)]
        self.net = list(zip(params[::2], params[1::2]))
        self.train_calls += 1
        if self.train_calls % c["target_sync_every"] == 0:
            self.target_net = [(w.clone(), b.clone()) for w, b in self.net]

    def leaves(self) -> list:
        return [p for pair in self.net for p in pair]

    def initial_leaves(self) -> list:
        return [p for pair in self.initial for p in pair]
