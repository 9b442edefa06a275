"""Trace-driven client realism: availability, stragglers, dropout, churn.

Port of the JAX package's ``fed/realism.py``.  The traces and outcomes
are numpy, drawn exactly as there, so a ``(seed, trace)`` gives the same
bits in both packages; only :func:`filter_survivors` works on the port's
stacked parameter tensors.

The simulation in ``fed/rounds.py`` historically assumed every selected
client responds instantly — exactly the idealization the FL systems
literature flags as the gap between simulations and deployments.  This
module closes it with a **seeded, injectable-clock** fault-injection
layer:

* **Diurnal availability** — each client follows a sinusoidal
  availability curve over a simulated day, with a per-client phase (so
  "time zones" exist); an unavailable client refuses the round.
* **Stragglers** — per-client compute tiers stretch the simulated
  round-trip latency; a straggler past the round deadline is dropped
  from aggregation and the server eats the full deadline wait.
* **Mid-round dropout** — a configurable hazard rate turns exposure
  time into a drop probability; a mid-round dropout disconnects partway
  through its latency and contributes nothing.
* **Population churn** — clients join/leave the population between
  rounds (per-round join/leave probabilities); a departed client
  refuses selection, and the join/leave delta stream is exactly what
  the serving path's ``update_embeddings`` delta buffer ingests.

Everything is a pure function of ``(seed, trace parameters, round
index)``: per-round randomness comes from
``np.random.SeedSequence([seed, stream, round])`` — never from global
RNG state, never from host time — so a fixed ``(seed, trace)`` replays
**bit-identically** and every chaos scenario is a deterministic test.
Simulated time lives in :class:`SimClock`, which doubles as the
injectable clock ``FederatedRunner`` routes its per-phase
``RoundResult.timings`` through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: integer stream labels feeding np.random.SeedSequence — one
#: independent deterministic stream per failure mode per round.
_STREAMS = {"availability": 1, "latency": 2, "dropout": 3,
            "drop_frac": 4, "churn": 5, "static": 6}


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    """Per-round serving contract the simulated server enforces.

    Args:
        deadline_s: wall-clock budget for the round in simulated
            seconds.  Clients whose latency exceeds it are dropped from
            aggregation and the server waits the full deadline for
            them.  ``None`` = no deadline (today's behavior): the
            server waits for every responding client.
        reward_blend: weight of the deadline-attainment term in the
            DQN reward: ``(1-b)·favor + b·(attainment − 1)`` with
            attainment = completed/selected.  0 keeps the paper's pure
            accuracy shaping.
        straggler_mult: a responding client counts as a straggler when
            its latency exceeds this multiple of the cohort's median
            latency.
    """
    deadline_s: Optional[float] = None
    reward_blend: float = 0.0
    straggler_mult: float = 2.0


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Knobs of the :class:`ClientTrace` failure-mode model.

    Per-client assignments (``phase_assign`` / ``tier_assign`` /
    ``hazard_assign``) are optional: when omitted they are drawn
    deterministically from the trace seed; benchmarks pass explicit
    assignments to correlate failure modes with data heterogeneity
    (e.g. "clients holding labels 5–9 are on the slow tier").
    """
    availability: str = "none"           # "none" | "diurnal"
    day_period_s: float = 240.0          # simulated seconds per "day"
    avail_floor: float = 0.05            # trough availability
    avail_amplitude: float = 0.9         # peak - trough
    phase_assign: Optional[Tuple[float, ...]] = None   # per-client [0,1)
    tiers: Tuple[float, ...] = (1.0,)    # latency stretch per tier
    tier_assign: Optional[Tuple[int, ...]] = None
    base_latency_s: float = 1.0          # tier-1.0 mean round latency
    latency_jitter: float = 0.1          # lognormal sigma on latency
    dropout_hazard: float = 0.0          # drops per simulated second
    hazard_assign: Optional[Tuple[float, ...]] = None  # per-client mult
    p_join: float = 0.0                  # per-round rejoin probability
    p_leave: float = 0.0                 # per-round leave probability


@dataclasses.dataclass
class RoundOutcome:
    """What the simulated server observed for one round's cohort.

    ``completed`` and ``dropped`` partition ``selected`` (asserted by
    the property suite); ``reasons`` breaks the drops down by failure
    mode (``unavailable`` / ``deadline`` / ``dropout``).
    """
    round_idx: int
    selected: np.ndarray                 # (K,) client ids as selected
    completed: np.ndarray                # ids that made aggregation
    dropped: np.ndarray                  # ids that did not
    straggler_ids: np.ndarray            # responders slower than mult×median
    latencies_s: np.ndarray              # (K,) per-selected simulated latency
    elapsed_s: float                     # simulated round wall time
    deadline_s: Optional[float]
    reasons: Dict[str, int]

    @property
    def attainment(self) -> float:
        """Fraction of the cohort that beat the deadline: completed/selected."""
        return len(self.completed) / max(len(self.selected), 1)


class SimClock:
    """Injectable monotonic clock for the simulation.

    Starts at 0.0 and only moves when :meth:`advance` is called — the
    realism layer advances it by each round's simulated wall time, so
    ``RoundResult.timings`` measured through it report *simulated*
    seconds, bit-identical across replays (no host time anywhere).
    Calling the instance reads it, so it is drop-in for
    ``time.perf_counter``.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    __call__ = now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"SimClock.advance: dt={dt} must be >= 0")
        self._now += float(dt)
        return self._now


class ClientTrace:
    """Deterministic per-client failure-mode model over a population.

    All randomness is derived from ``SeedSequence([seed, stream,
    round])`` — one independent stream per failure mode per round, each
    drawn as a full (N,) vector and indexed by the selected cohort, so
    outcomes do not depend on cohort composition or selection order.

    Args:
        num_clients: N, the population ceiling (client ids 0..N-1).
        spec:        :class:`TraceSpec` failure-mode knobs.
        seed:        trace seed; ``(seed, spec)`` fixes every replay.
    """

    def __init__(self, num_clients: int, spec: TraceSpec = TraceSpec(), *,
                 seed: int = 0):
        if num_clients <= 0:
            raise ValueError("ClientTrace needs num_clients >= 1")
        if spec.availability not in ("none", "diurnal"):
            raise ValueError(f"unknown availability model "
                             f"{spec.availability!r}")
        if not spec.tiers or any(t <= 0 for t in spec.tiers):
            raise ValueError("TraceSpec.tiers must be positive stretches")
        self.num_clients = num_clients
        self.spec = spec
        self.seed = seed
        rng = self._rng("static", 0)
        n = num_clients
        if spec.phase_assign is not None:
            self.phase = self._per_client("phase_assign",
                                          spec.phase_assign, np.float64)
        else:
            self.phase = rng.random(n)
        if spec.tier_assign is not None:
            tier = self._per_client("tier_assign", spec.tier_assign, np.int64)
            if len(spec.tiers) and (tier.min() < 0
                                    or tier.max() >= len(spec.tiers)):
                raise ValueError(f"tier_assign indexes outside "
                                 f"{len(spec.tiers)} tiers")
            self.tier = tier
        else:
            self.tier = rng.integers(0, len(spec.tiers), n)
        if spec.hazard_assign is not None:
            self.hazard_mult = self._per_client("hazard_assign",
                                                spec.hazard_assign,
                                                np.float64)
        else:
            self.hazard_mult = np.ones(n)
        self.stretch = np.asarray(spec.tiers, np.float64)[self.tier]
        # membership history: _membership[r] is the active mask BEFORE
        # round r; computed lazily round by round so it is a pure
        # function of (seed, spec, r)
        self._membership: List[np.ndarray] = [np.ones(n, bool)]

    def _per_client(self, name: str, values, dtype) -> np.ndarray:
        arr = np.asarray(values, dtype)
        if arr.shape != (self.num_clients,):
            raise ValueError(f"TraceSpec.{name} must have one entry per "
                             f"client ({self.num_clients}), got shape "
                             f"{arr.shape}")
        return arr

    def _rng(self, stream: str, round_idx: int) -> np.random.Generator:
        """Independent deterministic generator per (stream, round)."""
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, _STREAMS[stream], round_idx]))

    # -- availability ------------------------------------------------------
    def availability(self, t_s: float) -> np.ndarray:
        """(N,) per-client availability probability at simulated time t.

        ``"none"`` is all-ones; ``"diurnal"`` is a floor+amplitude
        sinusoid over ``day_period_s`` with each client's own phase.
        Always clipped to [0, 1] regardless of the knob values.
        """
        s = self.spec
        if s.availability == "none":
            return np.ones(self.num_clients)
        wave = 0.5 * (1.0 + np.sin(
            2.0 * np.pi * (t_s / max(s.day_period_s, 1e-9) + self.phase)))
        return np.clip(s.avail_floor + s.avail_amplitude * wave, 0.0, 1.0)

    # -- churn -------------------------------------------------------------
    def membership(self, round_idx: int) -> np.ndarray:
        """(N,) bool: who is in the population going into ``round_idx``.

        Round 0 starts with everyone active; each subsequent round every
        active client leaves w.p. ``p_leave`` and every departed client
        rejoins w.p. ``p_join`` (independent deterministic draws).
        """
        if round_idx < 0:
            raise ValueError("round_idx must be >= 0")
        s = self.spec
        while len(self._membership) <= round_idx:
            r = len(self._membership)
            prev = self._membership[-1]
            if s.p_leave <= 0.0 and s.p_join <= 0.0:
                self._membership.append(prev)
                continue
            u = self._rng("churn", r).random(self.num_clients)
            nxt = np.where(prev, u >= s.p_leave, u < s.p_join)
            self._membership.append(nxt)
        return self._membership[round_idx]

    def churn_step(self, round_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(joined_ids, left_ids) between rounds ``r-1`` and ``r``.

        This is the delta stream the serving path feeds straight into
        ``CohortServer.update_embeddings`` (joins carry fresh embedding
        rows, leaves tombstone theirs) — O(delta) by construction.
        Round 0 reports no churn.
        """
        if round_idx == 0:
            empty = np.empty(0, np.int64)
            return empty, empty
        prev = self.membership(round_idx - 1)
        cur = self.membership(round_idx)
        return (np.flatnonzero(~prev & cur).astype(np.int64),
                np.flatnonzero(prev & ~cur).astype(np.int64))

    # -- latency -----------------------------------------------------------
    def latencies(self, round_idx: int) -> np.ndarray:
        """(N,) simulated round-trip latency had each client been selected.

        ``base_latency_s × tier stretch × lognormal(σ=latency_jitter)``
        — the jitter draw is independent of the tier, so stretching a
        tier stretches every latency monotonically (the property suite
        pins this).
        """
        s = self.spec
        jitter = np.exp(s.latency_jitter
                        * self._rng("latency", round_idx)
                        .standard_normal(self.num_clients))
        return s.base_latency_s * self.stretch * jitter

    # -- the round ---------------------------------------------------------
    def simulate_round(self, round_idx: int, now_s: float,
                       selected: Sequence[int],
                       spec: Optional[RoundSpec] = None) -> RoundOutcome:
        """Run one round's failure modes over the selected cohort.

        Per selected client, in order: (1) departed or unavailable →
        dropped immediately (connection refused, costs no wall time);
        (2) latency past the deadline → dropped, server waits the full
        deadline; (3) mid-round dropout with probability
        ``1 − exp(−hazard × exposure)`` → dropped, disconnect partway
        through; (4) otherwise completed.  The round's simulated wall
        time is the latest event the server observes: completions at
        their latency, dropouts at their disconnect, deadline-misses at
        the deadline.
        """
        rs = spec or RoundSpec()
        sel = np.asarray(selected, np.int64)
        k = len(sel)
        if k == 0:
            empty = np.empty(0, np.int64)
            return RoundOutcome(round_idx, sel, empty, empty, empty,
                                np.empty(0), 0.0, rs.deadline_s,
                                {"unavailable": 0, "deadline": 0,
                                 "dropout": 0})
        s = self.spec
        member = self.membership(round_idx)[sel]
        avail_p = self.availability(now_s)[sel]
        u_avail = self._rng("availability", round_idx).random(
            self.num_clients)[sel]
        responds = member & (u_avail < avail_p)

        lat = self.latencies(round_idx)[sel]
        missed = (np.zeros(k, bool) if rs.deadline_s is None
                  else lat > rs.deadline_s)

        exposure = (lat if rs.deadline_s is None
                    else np.minimum(lat, rs.deadline_s))
        hazard = s.dropout_hazard * self.hazard_mult[sel]
        p_drop = 1.0 - np.exp(-np.maximum(hazard, 0.0) * exposure)
        u_drop = self._rng("dropout", round_idx).random(self.num_clients)[sel]
        drop_frac = self._rng("drop_frac", round_idx).random(
            self.num_clients)[sel]
        dropped_mid = responds & ~missed & (u_drop < p_drop)

        completed_mask = responds & ~missed & ~dropped_mid
        # what the server observes, per selected client: nothing for a
        # refused connection, the disconnect for a dropout, the full
        # deadline for a miss, the latency for a completion
        event = np.zeros(k)
        event[completed_mask] = lat[completed_mask]
        event[dropped_mid] = (lat * drop_frac)[dropped_mid]
        if rs.deadline_s is not None:
            event[responds & missed] = rs.deadline_s
        elapsed = float(event.max()) if k else 0.0

        median = float(np.median(lat[responds])) if responds.any() else 0.0
        stragglers = responds & (lat > rs.straggler_mult * max(median, 1e-12))
        reasons = {
            "unavailable": int(np.count_nonzero(~responds)),
            "deadline": int(np.count_nonzero(responds & missed)),
            "dropout": int(np.count_nonzero(dropped_mid)),
        }
        return RoundOutcome(
            round_idx, sel,
            completed=sel[completed_mask],
            dropped=sel[~completed_mask],
            straggler_ids=sel[stragglers],
            latencies_s=lat, elapsed_s=elapsed,
            deadline_s=rs.deadline_s, reasons=reasons)


# -- aggregation + reward helpers the round driver wires in ----------------

def filter_survivors(stacked_params, weights: np.ndarray,
                     survivor_mask: np.ndarray):
    """Drop non-surviving cohort members before FedAvg.

    Indexes the leading cohort axis of the stacked client parameters
    (a dict of tensors, each on its own device) down to the survivors;
    ``fedavg_aggregate`` renormalizes the surviving weights internally,
    so a dropped client contributes exactly nothing (even NaN partial
    work cannot poison the mean).  Raises if nobody survived: the caller
    must skip aggregation entirely for an all-dropped round.
    """
    mask = np.asarray(survivor_mask, bool)
    if not mask.any():
        raise ValueError("filter_survivors: no survivors to aggregate")
    if mask.all():
        return stacked_params, weights
    idx = np.flatnonzero(mask)
    index = {}                      # one index tensor per device

    def take(x):
        if x.device not in index:
            index[x.device] = torch.as_tensor(idx, device=x.device)
        return x.index_select(0, index[x.device])

    return ({name: take(x) for name, x in stacked_params.items()},
            np.asarray(weights)[idx])


def blended_reward(accuracy: float, target: float, attainment: float, *,
                   blend: float = 0.5, xi: float = 64.0) -> float:
    """Deadline-aware FAVOR shaping: accuracy blended with attainment.

    ``(1−b)·(Ξ^(acc−target) − 1) + b·(attainment − 1)`` — the
    attainment term is 0 when every selected client beat the deadline
    and −1 when none did, so a policy that wastes cohort slots on
    slow/flaky clusters pays for it every round even before the
    accuracy signal moves.  ``blend=0`` is exactly the paper's reward.
    """
    if not 0.0 <= blend <= 1.0:
        raise ValueError(f"blend={blend} must be in [0, 1]")
    base = float(xi ** (accuracy - target) - 1.0)
    return (1.0 - blend) * base + blend * (float(attainment) - 1.0)
