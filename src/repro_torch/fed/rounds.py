"""The federated communication-round loop (Algorithm II outer loop).

Port of the JAX package's ``fed/rounds.py``.  One ``FederatedRunner`` =
one experiment: a dataset partitioned non-IID across N simulated
clients, a selection policy, and the FedAvg server.  Each round: select
cohort -> parallel local SGD (vmapped) -> aggregate -> evaluate ->
reward the policy.  Rounds-to-target-accuracy is the paper's headline
metric (Table 2).

Where the randomness comes from, so that a round replays bit for bit:

* the data, the shards, the client batches and the policies' draws are
  numpy generators, exactly as in the JAX package;
* the model and the embedding projection are drawn from CPU torch
  generators seeded ``cfg.seed``;
* the stochastic-pooling noise of a cohort comes from a CPU generator
  seeded ``cfg.seed * 100003 + round``, drawn one local step at a time
  and moved to the device.  As in the JAX package, every warm-up chunk
  reuses round 0's seed.

So the same configuration gives the same round on the card and on the
CPU, up to the summation order of the convolutions.  That order can still
flip a pooling decision whose two best scores tie to the last f32 bit,
and any change in the embeddings' bytes changes the cohort engine's
fingerprint-seeded k-means draws, so a ``dqre_sc`` cohort can differ
between devices.

Client realism (``realism``, ``round_spec``, :meth:`FederatedRunner.
attach_trace`) runs the round through :mod:`repro_torch.fed.realism`, as
in the JAX package: only the clients that complete the simulated round
train and aggregate, the reward may blend in deadline attainment, and the
round's timings read a :class:`~repro_torch.fed.realism.SimClock`.  The
trace's draws are numpy, so the same seed drops the same clients in both
packages.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.embedding import WeightEmbedder
from repro_torch.core.selection import (Feedback, RoundState, favor_reward,
                                        make_policy)
from repro_torch.device import resolve_device
from repro_torch.fed.client import evaluate, local_train_cohort
from repro_torch.fed.datasets import make_dataset
from repro_torch.fed.metrics import classification_metrics
from repro_torch.fed.partition import partition_non_iid
from repro_torch.fed.realism import (ClientTrace, RoundOutcome, RoundSpec,
                                     SimClock, TraceSpec, blended_reward)
from repro_torch.fed.server import fedavg_aggregate, weight_delta_embedding
from repro_torch.models.cnn import CNN, gumbel_noise, pool_noise_shape

_WARMUP_CHUNK = 32          # clients trained together during warm-up


@dataclasses.dataclass
class RoundResult:
    round_idx: int
    accuracy: float
    loss: float
    reward: float
    selected: np.ndarray
    seconds: float
    # per-phase wall times through the runner's injectable clock
    # (perf_counter by default, the SimClock once a trace is attached):
    # select / train / aggregate / evaluate / update
    timings: dict = dataclasses.field(default_factory=dict)
    # client-realism accounting: how many of the cohort made aggregation,
    # how many were dropped (unavailable / past the deadline / mid-round
    # dropout), how many were stragglers, the round's simulated wall time
    # and the full outcome.  Without a trace every selected client
    # completes and sim_seconds is the host-measured round.
    num_completed: int = 0
    num_dropped: int = 0
    num_stragglers: int = 0
    sim_seconds: float = 0.0
    outcome: Optional[RoundOutcome] = None


@dataclasses.dataclass
class RunnerConfig:
    dataset: str = "mnist"
    num_clients: int = 100
    clients_per_round: int = 10
    sigma: float = 0.5
    local_steps: int = 10
    batch_size: int = 16
    lr: float = 0.05
    embed_dim: int = 8
    num_clusters: int = 8
    target_accuracy: float = 0.85
    eval_size: int = 1024
    train_size: Optional[int] = 8192
    seed: int = 0
    policy: str = "fedavg"
    use_pallas: bool = False
    # Algorithm I scale regime, resolved by the cohort engine:
    # "dense" | "nystrom" | "sharded" | "auto"
    approx_method: str = "dense"
    num_landmarks: Optional[int] = None
    landmarks: str = "uniform"
    warm_start: bool = True
    # ε-greedy schedule of the learning policies (favor / dqre_sc);
    # explicit dqn_overrides in policy_kwargs win over these
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 200
    policy_kwargs: Optional[dict] = None
    # client realism (fed/realism.py): a TraceSpec puts the runner on the
    # fault-injection layer driven by an owned SimClock; round_spec adds
    # the deadline and the deadline-blended reward.  None keeps the ideal
    # simulation bit for bit.
    realism: Optional[TraceSpec] = None
    round_spec: Optional[RoundSpec] = None


class FederatedRunner:
    """One federated experiment on ``device`` (``"cuda"`` unless the
    caller passes another)."""

    def __init__(self, cfg: RunnerConfig, *,
                 clock: Optional[Callable[[], float]] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        data = make_dataset(cfg.dataset, seed=cfg.seed,
                            train_size=cfg.train_size,
                            test_size=cfg.eval_size)
        self.spec = data["spec"]
        self.x_train, self.y_train = data["x_train"], data["y_train"]
        self.x_test, self.y_test = data["x_test"], data["y_test"]
        self.shards = partition_non_iid(self.y_train, cfg.num_clients,
                                        cfg.sigma, seed=cfg.seed)
        self.shard_sizes = np.array([len(s) for s in self.shards], np.float32)
        dev = self.device
        # the data lives on the device once; batches are gathered there
        self._x_train = torch.as_tensor(self.x_train, device=dev)
        self._y_train = torch.as_tensor(self.y_train, device=dev).long()
        self._x_test = torch.as_tensor(self.x_test, device=dev)
        self._y_test = torch.as_tensor(self.y_test, device=dev).long()

        self.model = CNN(in_channels=self.spec.channels,
                         num_classes=self.spec.num_classes,
                         image_size=self.spec.image_size,
                         generator=torch.Generator().manual_seed(cfg.seed)
                         ).to(dev)
        self.model.requires_grad_(False)
        self.global_params = {k: v.detach().clone()
                              for k, v in self.model.named_parameters()}
        self.embedder = WeightEmbedder(self.global_params, dim=cfg.embed_dim,
                                       seed=cfg.seed, device=dev)
        self.client_embeds = np.zeros((cfg.num_clients, cfg.embed_dim),
                                      np.float32)
        kw = dict(cfg.policy_kwargs or {})
        if cfg.policy in ("dqre_sc", "stratified"):
            kw.setdefault("num_clusters", cfg.num_clusters)
            kw.setdefault("use_pallas", cfg.use_pallas)
            kw.setdefault("approx_method", cfg.approx_method)
            kw.setdefault("num_landmarks", cfg.num_landmarks)
            kw.setdefault("landmarks", cfg.landmarks)
            kw.setdefault("warm_start", cfg.warm_start)
        if cfg.policy in ("dqre_sc", "favor"):
            sched = dict(eps_start=cfg.eps_start, eps_end=cfg.eps_end,
                         eps_decay_steps=cfg.eps_decay_steps)
            sched.update(kw.get("dqn_overrides") or {})
            kw["dqn_overrides"] = sched
        self.policy = make_policy(cfg.policy, cfg.num_clients,
                                  cfg.clients_per_round, cfg.embed_dim,
                                  seed=cfg.seed, device=dev, **kw)
        self.prev_acc = 0.0
        self.round_idx = 0
        self.history: List[RoundResult] = []
        self._warmed_up = False
        # the clock behind RoundResult.timings: perf_counter by default,
        # the simulated clock once a trace is attached
        self.sim_clock: Optional[SimClock] = None
        self.trace: Optional[ClientTrace] = None
        self.round_spec = cfg.round_spec or RoundSpec()
        self._clock: Callable[[], float] = clock or time.perf_counter
        if cfg.realism is not None:
            self.attach_trace(
                ClientTrace(cfg.num_clients, cfg.realism, seed=cfg.seed),
                cfg.round_spec)

    def attach_trace(self, trace: ClientTrace,
                     spec: Optional[RoundSpec] = None) -> None:
        """Enable client realism: fault-inject rounds from ``trace``.

        Must be called before any round runs.  Switches the timing clock
        to an owned :class:`SimClock`, so every recorded time is
        simulated.
        """
        if self.round_idx or self.history:
            raise RuntimeError("attach_trace: rounds already ran")
        if trace.num_clients != self.cfg.num_clients:
            raise ValueError(
                f"trace covers {trace.num_clients} clients but the "
                f"runner simulates {self.cfg.num_clients}")
        self.trace = trace
        if spec is not None:
            self.round_spec = spec
        self.sim_clock = SimClock()
        self._clock = self.sim_clock

    # ------------------------------------------------------------------
    def _client_batches(self, client_ids):
        """(K, steps, B, H, W, C) images and (K, steps, B) labels on the
        device; the indices are the JAX package's numpy draws."""
        c = self.cfg
        idx = np.concatenate([
            self.rng.choice(self.shards[cid],
                            size=c.local_steps * c.batch_size, replace=True)
            for cid in client_ids])
        idx = torch.as_tensor(idx, device=self.device)
        k = len(client_ids)
        xs = self._x_train[idx].reshape(k, c.local_steps, c.batch_size,
                                        *self.x_train.shape[1:])
        ys = self._y_train[idx].reshape(k, c.local_steps, c.batch_size)
        return xs, ys

    def _pool_noise(self, k: int):
        """``noise(step)`` of a k-client cohort in the current round."""
        c = self.cfg
        shape = (k, *pool_noise_shape(c.batch_size, self.spec.image_size))
        return gumbel_noise(c.seed * 100_003 + self.round_idx, shape,
                            self.device)

    def _train_cohort(self, client_ids):
        xs, ys = self._client_batches(client_ids)
        return local_train_cohort(self.model, self.global_params, xs, ys,
                                  self._pool_noise(len(client_ids)),
                                  lr=self.cfg.lr)

    def warmup(self):
        """One local pass on EVERY client to initialize the weight-state
        embeddings (FAVOR's initialization round; paper §3.4)."""
        ids = np.arange(self.cfg.num_clients)
        for lo in range(0, len(ids), _WARMUP_CHUNK):
            chunk = ids[lo: lo + _WARMUP_CHUNK]
            stacked, _ = self._train_cohort(chunk)
            self.client_embeds[chunk] = weight_delta_embedding(
                self.embedder, stacked, self.global_params)
        self._warmed_up = True

    def _round_state(self) -> RoundState:
        return RoundState(self.round_idx, self.client_embeds.copy(),
                          self.embedder(self.global_params),
                          self.prev_acc)

    # ------------------------------------------------------------------
    def run_round(self) -> RoundResult:
        if not self._warmed_up:
            self.warmup()
        c = self.cfg
        clock = self._clock
        t0 = clock()
        state = self._round_state()
        selected = np.asarray(self.policy.select(state))
        t_select = clock()

        outcome = None
        survivors = selected
        if self.trace is not None:
            # fault-inject the round: only the clients that complete it
            # train, update their embeddings and aggregate (FedAvg
            # renormalizes the weights over them); an all-dropped round
            # leaves the global model as it was
            outcome = self.trace.simulate_round(
                self.round_idx, self.sim_clock.now(), selected,
                self.round_spec)
            survivors = outcome.completed
            self.sim_clock.advance(outcome.elapsed_s)
        if len(survivors):
            stacked, _ = self._train_cohort(survivors)
            # the embeddings come back to the host: the train phase ends
            # synced
            self.client_embeds[survivors] = weight_delta_embedding(
                self.embedder, stacked, self.global_params)
        t_train = clock()
        if len(survivors):
            self.global_params = fedavg_aggregate(
                stacked, self.shard_sizes[survivors])
        t_aggregate = clock()
        acc, loss, _ = evaluate(self.model, self.global_params,
                                self._x_test, self._y_test)
        # round boundary: accuracy immediately drives the host-side reward
        # shaping and policy update, and the loss the round's record, so
        # this sync is inherent
        # repro-lint: ignore[torch-blocking-sync]
        acc, loss = float(acc), float(loss)
        t_evaluate = clock()
        blend = self.round_spec.reward_blend
        if outcome is not None and blend > 0.0:
            reward = blended_reward(acc, c.target_accuracy,
                                    outcome.attainment, blend=blend)
        else:
            reward = favor_reward(acc, c.target_accuracy)
        next_state = self._round_state()
        self.policy.update(state, next_state,
                           Feedback(acc, reward, selected))
        self.prev_acc = acc
        t_update = clock()
        res = RoundResult(self.round_idx, acc, loss, reward, selected,
                          t_update - t0,
                          timings={"select": t_select - t0,
                                   "train": t_train - t_select,
                                   "aggregate": t_aggregate - t_train,
                                   "evaluate": t_evaluate - t_aggregate,
                                   "update": t_update - t_evaluate},
                          num_completed=len(survivors),
                          num_dropped=(0 if outcome is None
                                       else len(outcome.dropped)),
                          num_stragglers=(0 if outcome is None
                                          else len(outcome.straggler_ids)),
                          sim_seconds=(t_update - t0 if outcome is None
                                       else outcome.elapsed_s),
                          outcome=outcome)
        self.history.append(res)
        self.round_idx += 1
        return res

    def run(self, num_rounds: int, stop_at_target: bool = False):
        for _ in range(num_rounds):
            res = self.run_round()
            if stop_at_target and res.accuracy >= self.cfg.target_accuracy:
                break
        return self.history

    # ------------------------------------------------------------------
    def rounds_to_accuracy(self, target: Optional[float] = None):
        target = target if target is not None else self.cfg.target_accuracy
        for res in self.history:
            if res.accuracy >= target:
                return res.round_idx + 1
        return None

    def sim_seconds_to_accuracy(self, target: Optional[float] = None):
        """Cumulative simulated wall-clock seconds to the target accuracy.

        The realism benchmarks' headline metric: under stragglers or
        dropout a policy can match rounds-to-target yet pay the full
        deadline every round.  ``None`` if the target was never reached.
        Without an attached trace the per-round ``sim_seconds`` are
        host-measured seconds.
        """
        target = target if target is not None else self.cfg.target_accuracy
        total = 0.0
        for res in self.history:
            total += res.sim_seconds
            if res.accuracy >= target:
                return total
        return None

    def final_metrics(self) -> dict:
        _, _, logits = evaluate(self.model, self.global_params,
                                self._x_test, self._y_test)
        # the run's end: the logits come to the host once, for the report
        # repro-lint: ignore[torch-blocking-sync]
        return classification_metrics(self.y_test, logits.cpu().numpy())
