"""Algorithm II as a reusable component: a Deep-Q policy over clusters.

Port of the JAX package's ``policy/cluster_policy.py``.  The action space
is the cluster index: one ε-greedy cluster choice per cohort slot, so a
round's ``actions`` are the per-slot cluster draws and the induced
per-cluster draw weights are ``ε/k + (1-ε)·1[argmax Q]``.  The reward is
the paper's accuracy-delta signal ``Ξ^(acc − target) − 1`` (FAVOR
shaping, §3.3), computed by the caller.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dqn import DQNAgent, DQNConfig


class ClusterPolicy:
    """Deep-Q policy over ``num_clusters`` discrete cluster actions.

    Args:
        num_clusters: size of the action space (k of Algorithm I).
        state_dim:    length of the caller's state vectors.
        seed:         seeds the Q-network init and the fallback rng.
        dqn_overrides: optional :class:`DQNConfig` field overrides.
        state_features: descriptive label of the state layout (reported
            by :meth:`stats` and echoed in the shape-mismatch error).
        device:       where the Q-networks live (``"cuda"`` by default).
    """

    def __init__(self, num_clusters: int, state_dim: int, *, seed: int = 0,
                 dqn_overrides: Optional[dict] = None,
                 state_features: Optional[str] = None, device=None):
        self.num_clusters = num_clusters
        self.state_dim = state_dim
        self.state_features = state_features
        cfg = DQNConfig(state_dim=state_dim, num_actions=num_clusters,
                        **(dqn_overrides or {}))
        self.agent = DQNAgent(cfg, seed=seed, device=device)
        self.rng = np.random.default_rng(seed)
        self._last_loss = 0.0              # device scalar after train()

    def _check_state(self, state_vec: np.ndarray, caller: str) -> np.ndarray:
        """Fail fast on a wrong-length state with a readable error."""
        s = np.asarray(state_vec, np.float32).reshape(-1)
        if len(s) != self.state_dim:
            layout = (f" (policy built for state_features="
                      f"{self.state_features!r})" if self.state_features
                      else "")
            raise ValueError(
                f"ClusterPolicy.{caller}: state vector has length "
                f"{len(s)} but the policy expects state_dim="
                f"{self.state_dim}{layout}")
        return s

    # -- acting -----------------------------------------------------------
    def epsilon(self) -> float:
        """Current exploration rate of the underlying agent's schedule."""
        return self.agent.epsilon()

    def draw_weights(self, state_vec: np.ndarray) -> np.ndarray:
        """Expected per-cluster draw distribution at the current ε.

        ``ε/k`` everywhere plus ``1-ε`` on the greedy (argmax-Q) cluster.
        Pure readout: does not advance the ε schedule.
        """
        q = self.agent.q_values(self._check_state(state_vec, "draw_weights"))
        k = self.num_clusters
        eps = self.agent.epsilon()
        w = np.full(k, eps / k, np.float64)
        w[int(np.argmax(q))] += 1.0 - eps
        return w

    def draw(self, rng: np.random.Generator, state_vec: np.ndarray,
             pools: Dict[int, List[int]], cohort_size: int,
             ) -> Tuple[List[int], List[int]]:
        """Draw a cohort: one ε-greedy cluster choice per slot.

        ``pools`` maps every cluster id in ``range(num_clusters)`` to a
        mutable list of member client ids; drawn clients are popped.
        Returns ``(picked, actions)``, the client ids (fewer than
        ``cohort_size`` if the pools run dry) and the cluster of each
        slot.  Advances the agent's ε schedule by one step.
        """
        self.agent.steps += 1
        q = self.agent.q_values(self._check_state(state_vec, "draw"))
        eps = self.agent.epsilon()
        for pool in pools.values():
            rng.shuffle(pool)
        order = np.argsort(-q)
        picked: List[int] = []
        actions: List[int] = []
        while len(picked) < cohort_size:
            if rng.random() < eps:
                c = int(rng.integers(self.num_clusters))
            else:
                c = int(next((c for c in order if pools[c]), order[0]))
            if not pools[c]:
                nonempty = [cc for cc in range(self.num_clusters)
                            if pools[cc]]
                if not nonempty:
                    break
                c = int(rng.choice(nonempty))
            picked.append(pools[c].pop())
            actions.append(c)
        return picked, actions

    # -- learning ---------------------------------------------------------
    def observe(self, state_vec: np.ndarray, actions: Sequence[int],
                reward: float, next_state_vec: np.ndarray) -> None:
        """Record one round: every slot's cluster choice shares the
        round's scalar reward."""
        s = self._check_state(state_vec, "observe")
        s2 = self._check_state(next_state_vec, "observe")
        for a in actions:
            self.agent.observe(s, int(a), reward, s2)

    def train(self, rng: Optional[np.random.Generator] = None):
        """One TD minibatch step; returns (and remembers) the loss as a
        device scalar (no host sync: the server calls this under its
        select lock)."""
        self._last_loss = self.agent.train_step(
            rng if rng is not None else self.rng)
        return self._last_loss

    @property
    def last_loss(self) -> float:
        """Most recent TD loss, materialized on demand (syncs here)."""
        return float(self._last_loss)

    def stats(self) -> dict:
        """Serving-dashboard counters: ε, steps, replay fill, last loss."""
        buf = self.agent.buffer
        return {"epsilon": self.agent.epsilon(),
                "state_dim": self.state_dim,
                "state_features": self.state_features,
                "steps": self.agent.steps,
                "train_calls": self.agent.train_calls,
                "buffer_fill": buf.size / buf.capacity,
                "buffer_size": buf.size,
                "last_loss": self.last_loss}
