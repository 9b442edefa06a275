"""The cohort-selection service, in PyTorch.

Port of ``CohortServer`` from the JAX package's ``launch/serve.py``: it
owns the live client-embedding table (versioned, copy-on-write, so an
update never tears a selection in flight) and a
:class:`repro_torch.cohort.CohortEngine`, and answers cohort requests
with a cluster-stratified draw (``policy="stratified"``) or with the
paper's Algorithm II (``policy="dqn"``): a
:class:`repro_torch.policy.ClusterPolicy` scores the clusters and draws
the cohort ε-greedily, trained online from the accuracy reported back
through ``observe_round``.  The engine and the Q-networks run on
``device`` (``"cuda"`` unless the caller passes ``device="cpu"``).

Not ported yet (they raise ``NotImplementedError``): background
streaming re-clustering (``streaming=``), client-realism outcomes
(``observe_round(outcome=...)``) and the ``"system"`` state features
that feed on them.

  PYTHONPATH=src python -m repro_torch.launch.serve --cohort 100000 \
      --cohort-size 64 --policy dqn --use-pallas --num-landmarks 512
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.cohort import CohortConfig, CohortEngine
from repro_torch.fed.metrics import (cluster_policy_state, favor_reward,
                                     serving_state_dim)
from repro_torch.policy import ClusterPolicy

#: smoothing factor for the server's per-phase latency EMAs.
_LATENCY_EMA = 0.2
#: smoothing factor for the per-cluster reward EMAs in the policy state.
_REWARD_EMA = 0.2


class ServiceClosedError(RuntimeError):
    """A select reached a server after :meth:`CohortServer.close`."""


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP: streaming and "
        f"client-realism slice)")


class CohortServer:
    """Cohort-selection service backed by a :class:`CohortEngine`.

    Selections are serialized on ``_select_lock`` and engine entries on
    ``_solve_lock`` (the engine's warm-start state is single-writer);
    ``update_embeddings`` appends O(delta) rows under ``_write_lock`` and
    :meth:`snapshot` materializes them lazily into a fresh immutable
    table.  Dashboard counters live under the innermost ``_stats_lock``.

    Args:
        num_clients:  N, rows of the embedding table.
        embed_dim:    d, embedding width.
        config:       :class:`CohortConfig` for the engine.
        seed:         seeds the engine, the draw rng and the Q-network.
        policy:       "stratified" | "dqn".
        target_accuracy: reward pivot for the DQN policy's shaping.
        dqn_overrides: DQNConfig field overrides for ``policy="dqn"``.
        state_features: DQN serving-state layout, ``"rich"`` (``5k + 1``)
            or ``"basic"`` (``3k + 1``).
        device:       ``"cuda"`` (default) or ``"cpu"``.
    """

    POLICIES = ("stratified", "dqn")

    def __init__(self, num_clients: int, embed_dim: int, *,
                 config=None, seed: int = 0, policy: str = "stratified",
                 target_accuracy: float = 0.85,
                 dqn_overrides: Optional[dict] = None,
                 state_features: str = "rich",
                 streaming=None, solver=None, deduper=None, device=None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"expected one of {self.POLICIES}")
        if streaming is not None or solver is not None or deduper is not None:
            raise _not_ported("streaming re-clustering (streaming=, "
                              "solver=, deduper=)")
        if state_features == "system":
            raise _not_ported("state_features='system'")
        self.config = config or CohortConfig()
        self.engine = CohortEngine(self.config, seed=seed, device=device)
        self.device = self.engine.device
        self.rng = np.random.default_rng(seed)
        self.policy_name = policy
        self.target_accuracy = target_accuracy
        self.state_features = state_features
        k = self.config.num_clusters
        state_dim = serving_state_dim(k, state_features)  # validates knob
        if policy == "dqn":
            self.policy = ClusterPolicy(k, state_dim=state_dim, seed=seed,
                                        dqn_overrides=dqn_overrides,
                                        state_features=state_features,
                                        device=self.device)
        else:
            self.policy = None

        table = np.zeros((num_clients, embed_dim), np.float32)
        table.setflags(write=False)       # snapshots must stay immutable
        self._write_lock = threading.Lock()
        self._select_lock = threading.Lock()
        self._solve_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._version = 0                 # guarded-by: _write_lock
        self._base = table                # guarded-by: _write_lock
        self._delta_ids: List[np.ndarray] = []    # guarded-by: _write_lock
        self._delta_rows: List[np.ndarray] = []   # guarded-by: _write_lock
        self._delta_pending = 0           # guarded-by: _write_lock
        self._materializations = 0        # guarded-by: _write_lock
        self._closed = False              # guarded-by: _select_lock

        self._participation = np.zeros(k, np.float64)   # guarded-by: _select_lock
        self._reward_ema = np.zeros(k, np.float32)      # guarded-by: _select_lock
        # selects since each cluster last contributed a served client
        self._staleness = np.zeros(k, np.float64)       # guarded-by: _select_lock
        self.prev_accuracy = 0.0                        # guarded-by: _select_lock
        # parked (state_vec, actions, assign, table) until observe_round
        self._pending = None                            # guarded-by: _select_lock
        self._latency = {  # guarded-by: _stats_lock
            "solve_s": 0.0, "draw_s": 0.0, "total_s": 0.0}
        self._round_timings: dict = {}                  # guarded-by: _stats_lock
        self._counters = {  # guarded-by: _stats_lock
            "requests": 0, "batches": 0, "updates": 0,
            "rounds_observed": 0, "dropped_transitions": 0,
            # the streaming counters of the JAX server, always 0 here
            "warm_ahead": 0, "served_warm": 0, "forced_inline": 0,
            "dedupe_hit": 0}
        self.last_select_s = 0.0                        # guarded-by: _select_lock

    # -- embedding table (versioned copy-on-write + delta buffer) --------
    @property
    def embeds(self) -> np.ndarray:
        """Current (read-only) embedding-table snapshot."""
        return self.snapshot()[1]

    @property
    def version(self) -> int:
        """Table version; bumps on every ``update_embeddings``."""
        return self._version

    def snapshot(self):
        """A consistent ``(version, table)``; the table is immutable."""
        with self._write_lock:
            if self._delta_pending:
                table = self._base.copy()
                for ids, rows in zip(self._delta_ids, self._delta_rows):
                    table[ids] = rows
                table.setflags(write=False)
                self._base = table
                self._delta_ids = []
                self._delta_rows = []
                self._delta_pending = 0
                self._materializations += 1
            return self._version, self._base

    def update_embeddings(self, client_ids, new_embeds) -> None:
        """Replace the embedding rows of ``client_ids``.

        O(delta): the rows join a pending-delta buffer and the version
        bumps; the next :meth:`snapshot` applies them in arrival order.
        """
        ids = np.array(client_ids, dtype=np.int64)   # copy: deferred apply
        rows = np.array(new_embeds, dtype=np.float32)
        n, d = self._base.shape
        if rows.ndim != 2 or rows.shape != (len(ids), d):
            raise ValueError(f"rows shape {rows.shape} != ({len(ids)}, {d})")
        if len(ids) and (ids.min() < -n or ids.max() >= n):
            raise IndexError(f"client_ids out of range for {n} clients")
        with self._write_lock:
            self._delta_ids.append(ids)
            self._delta_rows.append(rows)
            self._delta_pending += len(ids)
            self._version += 1
            # once pending rows rival the table a materialization is no
            # longer a saving, only deferred work
            flush_now = self._delta_pending >= n
        if flush_now:
            self.snapshot()
        with self._stats_lock:
            self._counters["updates"] += 1

    def close(self) -> None:
        """Stop serving: later selects raise :class:`ServiceClosedError`."""
        with self._select_lock:
            self._closed = True

    # -- serving ----------------------------------------------------------
    def _ema(self, name: str, value: float) -> None:
        """Fold one latency sample into the EMA (takes the stats lock)."""
        with self._stats_lock:
            prev = self._latency[name]
            self._latency[name] = (
                value if self._counters["requests"] == 0
                else prev + _LATENCY_EMA * (value - prev))

    def _policy_state(self, assign: np.ndarray,
                      table: np.ndarray) -> np.ndarray:
        rich = self.state_features == "rich"
        return cluster_policy_state(
            assign, self.config.num_clusters,
            self._participation, self._reward_ema, self.prev_accuracy,
            embeds=table if rich else None,
            staleness=self._staleness if rich else None,
            features=self.state_features)

    def select_cohort(self, cohort_size: int):
        """Serve one cohort; returns ``(client_ids, CohortResult)``.

        With ``policy="dqn"`` the draw's (state, actions) pair is parked
        until :meth:`observe_round` reports the round's accuracy.
        """
        return self.select_cohorts([cohort_size])[0]

    def select_cohorts(self, cohort_sizes: Optional[List[int]] = None, *,
                       sizes_fn=None):
        """Serve a batch of cohort requests from ONE engine solve.

        Every request draws from the same cluster pools, popped without
        replacement across the batch.  ``sizes_fn`` (exclusive with
        ``cohort_sizes``) decides the batch once the select lock is held.
        With ``policy="dqn"`` the batch parks ONE combined transition.
        """
        if (cohort_sizes is None) == (sizes_fn is None):
            raise ValueError(
                "select_cohorts takes exactly one of cohort_sizes or "
                "sizes_fn")
        if cohort_sizes is not None and not len(cohort_sizes):
            return []
        with self._select_lock:
            if self._closed:
                raise ServiceClosedError("CohortServer is closed")
            sizes = [int(s) for s in (cohort_sizes if sizes_fn is None
                                      else sizes_fn())]
            if not sizes:
                return []
            t0 = time.perf_counter()
            _, table = self.snapshot()
            with self._solve_lock:
                res = self.engine.select_batched(table, requests=len(sizes))
            t_solve = time.perf_counter()
            k = self.config.num_clusters
            pools = {c: list(np.flatnonzero(res.assign == c))
                     for c in range(k)}
            cohorts: List[np.ndarray] = []
            if self.policy is not None:
                state = self._policy_state(res.assign, table)
                all_actions: List[int] = []
                for size in sizes:
                    picked, actions = self.policy.draw(
                        self.rng, state, pools, size)
                    cohorts.append(np.asarray(picked[:size], np.int64))
                    all_actions.extend(actions[: len(picked)])
                if self._pending is not None:
                    # a second select before the round report replaces
                    # the parked transition; count the lost one
                    with self._stats_lock:
                        self._counters["dropped_transitions"] += 1
                self._pending = (state, all_actions, res.assign, table)
            else:
                for pool in pools.values():
                    self.rng.shuffle(pool)
                for size in sizes:
                    ordered = [pools[c] for c in range(res.k)]
                    picked: List[int] = []
                    while len(picked) < size and any(ordered):
                        for pool in ordered:
                            if pool and len(picked) < size:
                                picked.append(pool.pop())
                    cohorts.append(np.asarray(picked[:size], np.int64))
            flat = (np.concatenate(cohorts) if cohorts
                    else np.empty(0, np.int64))
            if len(flat):
                np.add.at(self._participation, res.assign[flat], 1.0)
            # staleness: every cluster ages one select; those that just
            # contributed a client reset to fresh
            self._staleness += 1.0
            if len(flat):
                self._staleness[np.unique(res.assign[flat])] = 0.0
            t1 = time.perf_counter()
            self._ema("solve_s", t_solve - t0)
            self._ema("draw_s", t1 - t_solve)
            self._ema("total_s", t1 - t0)
            with self._stats_lock:
                self._counters["requests"] += len(sizes)
                self._counters["batches"] += 1
            self.last_select_s = t1 - t0
            return [(picked, res) for picked in cohorts]

    def observe_round(self, accuracy: float, timings: Optional[dict] = None,
                      outcome=None) -> float:
        """Report a completed round back to the server; returns the reward.

        The reward is ``Ξ^(acc − target) − 1``.  With ``policy="dqn"`` the
        parked (state, actions) plus the new state go into the replay
        buffer and one TD minibatch runs.  ``timings`` are folded into
        the per-phase running means of :meth:`stats`.
        """
        if outcome is not None:
            raise _not_ported("observe_round(outcome=...)")
        reward = favor_reward(accuracy, self.target_accuracy)
        # same lock as select_cohorts: a racing selection must not park a
        # new transition between our read of _pending and its clear
        with self._select_lock:
            if self.policy is not None and self._pending is not None:
                state, actions, assign, table = self._pending
                for c in set(actions):
                    self._reward_ema[c] += _REWARD_EMA * (
                        reward - self._reward_ema[c])
                self.prev_accuracy = accuracy
                next_state = self._policy_state(assign, table)
                self.policy.observe(state, actions, reward, next_state)
                self.policy.train(self.rng)
                self._pending = None
            else:
                self.prev_accuracy = accuracy
            with self._stats_lock:
                if timings:
                    n = self._counters["rounds_observed"]
                    for phase, seconds in timings.items():
                        prev = self._round_timings.get(phase, 0.0)
                        self._round_timings[phase] = (
                            prev + (seconds - prev) / (n + 1))
                self._counters["rounds_observed"] += 1
        return reward

    def stats(self) -> dict:
        """One dict for the serving dashboard, with the JAX server's keys.

        Counters, ``shed`` (always 0: no admission control), table
        version and size, ``engine`` counters, a ``streaming`` sub-dict
        (``enabled`` False), EMA latencies, round-timing means, the last
        solve's provenance and the policy's ε / replay fill.
        """
        last = self.engine.state.result
        policy = {"kind": self.policy_name}
        if self.policy is not None:
            policy.update(self.policy.stats())
        with self._stats_lock:
            counters = dict(self._counters)
            latency = dict(self._latency)
            round_timings = dict(self._round_timings)
        with self._write_lock:
            materializations = self._materializations
            num_clients = self._base.shape[0]
        return {
            **counters,
            "shed": 0,
            "table_version": self.version,
            "num_clients": num_clients,
            "state_features": self.state_features,
            "engine": dict(self.engine.stats),
            "streaming": {"enabled": False, "max_stale_versions": None,
                          "served_version": None,
                          "materializations": materializations,
                          "admission": None},
            "latency_s": latency,
            "round_timings_s": round_timings,
            "last_select": None if last is None else {
                "method": last.method, "source": last.source,
                "drift": last.drift, "k": last.k,
                "seconds": last.seconds},
            "policy": policy,
        }


def _cohort_main(args) -> None:
    """Cohort-service demo loop: N synthetic clients, drifting embeddings.

    Clients of true cluster 0 are "stale": round accuracy rises with the
    share of the cohort drawn outside it, which is the reward the DQN
    policy learns from.
    """
    rng = np.random.default_rng(args.seed)
    d = 8
    centers = rng.normal(size=(args.num_clusters, d)).astype(np.float32) * 6
    assign_true = rng.integers(0, args.num_clusters, args.cohort)
    embeds = (centers[assign_true]
              + rng.normal(size=(args.cohort, d)).astype(np.float32))
    num_landmarks = args.num_landmarks
    if num_landmarks not in (None, "auto"):
        num_landmarks = int(num_landmarks)
    server = CohortServer(
        args.cohort, d, seed=args.seed, policy=args.policy,
        target_accuracy=0.85, device=args.device,
        config=CohortConfig(num_clusters=args.num_clusters,
                            landmarks=args.landmarks,
                            num_landmarks=num_landmarks,
                            use_pallas=args.use_pallas,
                            affinity_dtype=args.affinity_dtype))
    server.update_embeddings(np.arange(args.cohort), embeds)
    for r in range(args.rounds):
        ids, res = server.select_cohort(args.cohort_size)
        useful = float(np.mean(assign_true[ids] != 0)) if len(ids) else 0.0
        reward = server.observe_round(0.5 + 0.4 * useful)
        # the selected cohort trains and drifts; everyone else is static
        server.update_embeddings(
            ids, server.embeds[ids]
            + 0.01 * rng.normal(size=(len(ids), d)).astype(np.float32))
        print(f"round {r}: {len(ids)} clients from {res.k} clusters "
              f"({res.method}/{res.source}) in {server.last_select_s:.3f}s "
              f"({args.cohort / max(server.last_select_s, 1e-9):,.0f} "
              f"clients/s, reward {reward:+.3f})")
    server.close()
    print("server stats:", json.dumps(server.stats(), indent=2,
                                      default=float))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cohort", type=int, required=True, metavar="N",
                    help="serve cohort selection for N clients")
    ap.add_argument("--cohort-size", type=int, default=64)
    ap.add_argument("--num-clusters", type=int, default=8)
    ap.add_argument("--num-landmarks", default=None,
                    help="Nyström landmark count: an int, or 'auto'")
    ap.add_argument("--landmarks", default="uniform",
                    choices=["uniform", "leverage", "kmeans++"])
    ap.add_argument("--policy", default="stratified",
                    choices=["stratified", "dqn"])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the landmark solve through the fused CUDA "
                         "kernels (the JAX package's use_pallas knob)")
    ap.add_argument("--affinity-dtype", default="f32",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    _cohort_main(ap.parse_args(argv))


if __name__ == "__main__":
    main()
