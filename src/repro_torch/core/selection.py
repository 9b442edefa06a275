"""Client-selection policies: FedAvg(random), K-Center, FAVOR, DQRE-SCnet.

Port of the JAX package's ``core/selection.py``: the paper's baselines
(Table 2) and its contribution behind one interface.  A policy sees a
``RoundState`` (client weight-delta embeddings + global-model embedding)
and returns the cohort for the next communication round; learning
policies also consume a reward after the round (FAVOR-style
r = Ξ^(acc − target) − 1, Ξ = 64).

Every draw the policies make on the host comes from their numpy
``rng`` (``np.random.default_rng(seed)``), as in the JAX package, so a
policy fed the same states picks the same ids.  The policies that own
torch state (the Q-networks, the cohort engine) take a ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.cohort import CohortConfig, CohortEngine
from repro_torch.core.dqn import DQNAgent, DQNConfig
from repro_torch.core.kmeans import pairwise_sq_dists
from repro_torch.fed.metrics import favor_reward
from repro_torch.policy import ClusterPolicy

__all__ = ["RoundState", "Feedback", "SelectionPolicy", "RandomSelection",
           "KCenterSelection", "FavorSelection", "StratifiedSelection",
           "DQREScSelection", "POLICIES", "make_policy", "favor_reward"]


@dataclasses.dataclass
class RoundState:
    round_idx: int
    client_embeds: np.ndarray          # (N, dim)
    global_embed: np.ndarray           # (dim,)
    prev_accuracy: float


@dataclasses.dataclass
class Feedback:
    accuracy: float
    reward: float
    selected: np.ndarray


class SelectionPolicy:
    name = "base"

    def __init__(self, num_clients: int, clients_per_round: int,
                 embed_dim: int, seed: int = 0):
        self.num_clients = num_clients
        self.clients_per_round = clients_per_round
        self.embed_dim = embed_dim
        self.rng = np.random.default_rng(seed)

    def select(self, state: RoundState) -> np.ndarray:
        raise NotImplementedError

    def update(self, state: RoundState, next_state: RoundState,
               feedback: Feedback) -> None:
        pass


class RandomSelection(SelectionPolicy):
    """FedAvg: uniform random cohort (McMahan et al.)."""
    name = "fedavg"

    def select(self, state: RoundState) -> np.ndarray:
        return self.rng.choice(self.num_clients, self.clients_per_round,
                               replace=False)


def _sq_dists(x, y):
    """(n, d), (m, d) numpy -> (n, m) squared distances, numpy."""
    return pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(y)).numpy()


class KCenterSelection(SelectionPolicy):
    """Greedy k-center (farthest-point) over client embeddings."""
    name = "kcenter"

    def select(self, state: RoundState) -> np.ndarray:
        x = np.ascontiguousarray(state.client_embeds, np.float32)
        n, k = self.num_clients, self.clients_per_round
        chosen = [int(self.rng.integers(n))]
        d2 = _sq_dists(x, x[chosen])[:, 0]
        while len(chosen) < k:
            nxt = int(np.argmax(d2))
            chosen.append(nxt)
            d2 = np.minimum(d2, _sq_dists(x, x[nxt:nxt + 1])[:, 0])
        return np.asarray(chosen)


class FavorSelection(SelectionPolicy):
    """FAVOR (Wang et al. 2020): per-client DQN, no clustering.

    State = [global embed ‖ all client embeds]; the Q head scores each
    client; the cohort is the top-K by Q with ε-greedy exploration.
    """
    name = "favor"

    def __init__(self, num_clients, clients_per_round, embed_dim, seed=0,
                 dqn_overrides: Optional[dict] = None, device=None):
        super().__init__(num_clients, clients_per_round, embed_dim, seed)
        cfg = DQNConfig(state_dim=(num_clients + 1) * embed_dim,
                        num_actions=num_clients,
                        **(dqn_overrides or {}))
        self.agent = DQNAgent(cfg, seed=seed, device=device)

    def _state_vec(self, state: RoundState) -> np.ndarray:
        return np.concatenate([state.global_embed.ravel(),
                               state.client_embeds.ravel()]).astype(np.float32)

    def select(self, state: RoundState) -> np.ndarray:
        s = self._state_vec(state)
        self.agent.steps += 1
        q = self.agent.q_values(s)
        k = self.clients_per_round
        eps = self.agent.epsilon()
        n_rand = int(round(eps * k))
        top = np.argsort(-q)
        picked = list(top[: k - n_rand])
        if n_rand:
            rest = np.setdiff1d(np.arange(self.num_clients), picked)
            picked += list(self.rng.choice(rest, n_rand, replace=False))
        return np.asarray(picked[:k])

    def update(self, state, next_state, feedback):
        s, s2 = self._state_vec(state), self._state_vec(next_state)
        for a in feedback.selected:
            self.agent.observe(s, int(a), feedback.reward, s2)
        self.agent.train_step(self.rng)


def _make_cohort_config(num_clusters, approx_method, num_landmarks,
                        landmarks, use_pallas, auto_k, warm_start):
    """Engine config shared by the cluster-based policies (stratified +
    dqre_sc); approx_method maps 1:1 onto the engine's methods."""
    return CohortConfig(num_clusters=num_clusters, method=approx_method,
                        num_landmarks=num_landmarks, landmarks=landmarks,
                        use_pallas=use_pallas, auto_k=auto_k,
                        warm_start=warm_start)


class StratifiedSelection(SelectionPolicy):
    """Cluster-stratified uniform draw: Algorithm I without Algorithm II.

    Clusters the client embeddings through the same
    :class:`repro_torch.cohort.CohortEngine` as DQRE-SCnet, then draws the
    cohort round-robin across clusters (pools shuffled, popped without
    replacement).
    """
    name = "stratified"

    def __init__(self, num_clients, clients_per_round, embed_dim, seed=0,
                 num_clusters: int = 8, use_pallas: bool = False,
                 auto_k: bool = False, approx_method: str = "dense",
                 num_landmarks: Optional[int] = None,
                 landmarks: str = "uniform", warm_start: bool = True,
                 device=None):
        super().__init__(num_clients, clients_per_round, embed_dim, seed)
        self.num_clusters = num_clusters
        self.engine = CohortEngine(
            _make_cohort_config(num_clusters, approx_method, num_landmarks,
                                landmarks, use_pallas, auto_k, warm_start),
            seed=seed + 1, device=device)

    def select(self, state: RoundState) -> np.ndarray:
        assign = self.engine.select(state.client_embeds).assign
        pools = [list(np.flatnonzero(assign == c))
                 for c in range(self.num_clusters)]
        for pool in pools:
            self.rng.shuffle(pool)
        picked: list = []
        while len(picked) < self.clients_per_round and any(pools):
            for pool in pools:
                if pool and len(picked) < self.clients_per_round:
                    picked.append(pool.pop())
        return np.asarray(picked)


class DQREScSelection(SelectionPolicy):
    """DQRE-SCnet (the paper): spectral clustering + cluster-level DQN.

    Algorithm I (clustering) is the :class:`repro_torch.cohort.CohortEngine`;
    Algorithm II (the cluster-level DQN and the ε-greedy cohort draw) is
    :class:`repro_torch.policy.ClusterPolicy`, fed the simulation state
    [global embed ‖ cluster centroids].
    """
    name = "dqre_sc"

    def __init__(self, num_clients, clients_per_round, embed_dim, seed=0,
                 num_clusters: int = 8, use_pallas: bool = False,
                 auto_k: bool = False, approx_method: str = "dense",
                 num_landmarks: Optional[int] = None,
                 landmarks: str = "uniform", warm_start: bool = True,
                 cohort_config=None,
                 dqn_overrides: Optional[dict] = None, device=None):
        super().__init__(num_clients, clients_per_round, embed_dim, seed)
        self.num_clusters = num_clusters
        if cohort_config is None:
            cohort_config = _make_cohort_config(
                num_clusters, approx_method, num_landmarks, landmarks,
                use_pallas, auto_k, warm_start)
        else:
            if cohort_config.num_clusters != num_clusters:
                # the DQN action space, the pool loop in select() and the
                # engine's assignment range must agree
                raise ValueError(
                    f"cohort_config.num_clusters="
                    f"{cohort_config.num_clusters} must equal the "
                    f"policy's num_clusters={num_clusters}")
            overlapping = dict(approx_method=(approx_method, "dense"),
                               num_landmarks=(num_landmarks, None),
                               landmarks=(landmarks, "uniform"),
                               use_pallas=(use_pallas, False),
                               auto_k=(auto_k, False),
                               warm_start=(warm_start, True))
            clash = [name for name, (got, default) in overlapping.items()
                     if got != default]
            if clash:
                raise ValueError(
                    f"pass {clash} inside cohort_config, not alongside "
                    f"it — an explicit cohort_config replaces those "
                    f"constructor arguments entirely")
        self.engine = CohortEngine(cohort_config, seed=seed + 1,
                                   device=device)
        self.cluster_policy = ClusterPolicy(
            num_clusters, state_dim=(num_clusters + 1) * embed_dim,
            seed=seed, dqn_overrides=dqn_overrides, device=device)
        self.agent = self.cluster_policy.agent
        self._last_assign: Optional[np.ndarray] = None
        self._last_state_vec: Optional[np.ndarray] = None
        self._last_actions: Optional[list] = None

    @property
    def cluster_computes(self) -> int:
        """Algorithm I solves actually executed (engine cache hits excluded)."""
        return self.engine.stats["solves"]

    def _cluster(self, embeds: np.ndarray):
        return self.engine.select(embeds).assign

    def _state_vec(self, state: RoundState, assign: np.ndarray) -> np.ndarray:
        cents = np.zeros((self.num_clusters, self.embed_dim), np.float32)
        for c in range(self.num_clusters):
            m = assign == c
            if m.any():
                cents[c] = state.client_embeds[m].mean(axis=0)
        return np.concatenate([state.global_embed.ravel(),
                               cents.ravel()]).astype(np.float32)

    def select(self, state: RoundState) -> np.ndarray:
        assign = self._cluster(state.client_embeds)
        s = self._state_vec(state, assign)
        self._last_assign, self._last_state_vec = assign, s
        pools = {c: list(np.flatnonzero(assign == c))
                 for c in range(self.num_clusters)}
        picked, actions = self.cluster_policy.draw(
            self.rng, s, pools, self.clients_per_round)
        self._last_actions = actions
        return np.asarray(picked)

    def update(self, state, next_state, feedback):
        assign2 = self._cluster(next_state.client_embeds)
        s2 = self._state_vec(next_state, assign2)
        self.cluster_policy.observe(self._last_state_vec,
                                    self._last_actions or [],
                                    feedback.reward, s2)
        self.cluster_policy.train(self.rng)


POLICIES = {
    "fedavg": RandomSelection,
    "kcenter": KCenterSelection,
    "favor": FavorSelection,
    "stratified": StratifiedSelection,
    "dqre_sc": DQREScSelection,
}
# the policies that hold tensors and so take a device
_DEVICE_POLICIES = ("favor", "stratified", "dqre_sc")


def make_policy(name: str, num_clients: int, clients_per_round: int,
                embed_dim: int, seed: int = 0, *, device=None,
                **kw) -> SelectionPolicy:
    if name in _DEVICE_POLICIES:
        kw["device"] = device
    return POLICIES[name](num_clients, clients_per_round, embed_dim,
                          seed=seed, **kw)
