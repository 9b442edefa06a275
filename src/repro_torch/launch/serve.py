"""Serving launchers in PyTorch: the LM decode engine and the cohort server.

``Server`` is the continuous-batching LM server, a port of the JAX
package's ``launch/serve.py::Server``.  A :class:`DecodeScheduler` owns a
**slot table** (one KV-cache or SSM-state slot per batch lane,
independently resettable) and a request queue.  Finished or cache-full
requests retire their slot mid-decode and the next queued request is
admitted into it by a slot-targeted prefill (``lm_prefill_slot``), so
decode keeps running at full batch width with per-slot active masking.
Decode uses per-request cache positions: row i writes its token's KV at
``pos[i]`` and attends only ``[0, pos[i]]``, so each request's
continuation equals decoding it alone.  The weights are drawn from an
explicit generator on ``device`` (``"cuda"`` unless the caller passes
``device="cpu"``).  With ``--use-pallas`` (``ops.set_use_pallas``) every
prefill runs the flash-attention kernel (attention layers) or the SSD
kernel (Mamba-2 layers); decode is plain PyTorch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --reduced --device cpu --batch 2 --requests 5 --mixed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --use-pallas --batch 4 --prompt-len 1024 --gen-len 32 --requests 6

``CohortServer`` is the port of the JAX package's cohort-selection
service: it owns the live client-embedding table (versioned,
copy-on-write, so an update never tears a selection in flight) and a
:class:`repro_torch.cohort.CohortEngine`, and answers cohort requests
with a cluster-stratified draw (``policy="stratified"``) or with the
paper's Algorithm II (``policy="dqn"``): a
:class:`repro_torch.policy.ClusterPolicy` scores the clusters and draws
the cohort ε-greedily, trained online from the accuracy reported back
through ``observe_round``.  The engine and the Q-networks run on
``device``.  ``streaming=StreamingSpec(...)`` moves re-clustering onto a
:class:`repro_torch.streaming.BackgroundSolver` thread (serve version v
while v+1 warms; on the card its solves launch the kernels from that
thread), and ``observe_round(outcome=...)`` takes a client-realism
``RoundOutcome`` (``repro_torch.fed.realism``), which feeds the
``"system"`` state's per-cluster availability and latency EMAs and
blends deadline attainment into the reward.

  PYTHONPATH=src python -m repro_torch.launch.serve --cohort 100000 \
      --cohort-size 64 --policy dqn --use-pallas --num-landmarks 512 \
      --streaming

``--tenants T`` serves the ``--cohort`` demo through the multi-tenant
``repro_torch.launch.frontend.CohortFrontend``, which coalesces
concurrent selects of one tenant and table version behind one solve:

  PYTHONPATH=src python -m repro_torch.launch.serve --cohort 2000 \
      --tenants 4 --concurrency 16 --streaming --policy dqn --device cpu
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import threading
import time
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.cohort import CohortConfig, CohortEngine
from repro_torch.device import resolve_device
from repro_torch.fed.metrics import (cluster_policy_state, favor_reward,
                                     serving_state_dim)
from repro_torch.fed.realism import blended_reward
from repro_torch.models import transformer as T
from repro_torch.policy import ClusterPolicy
# ServiceClosedError lives in streaming/admission.py, as in the JAX
# package; importing it here keeps repro_torch.launch.serve's name
from repro_torch.streaming import (AdmissionController, BackgroundSolver,
                                   ServiceClosedError, StreamingSpec)

#: smoothing factor for the decode tokens/sec EMA in DecodeScheduler.stats().
_TOK_S_EMA = 0.2


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    generated: Optional[List[int]] = None


class DecodeScheduler:
    """Continuous-batching decode engine: slot table + request queue.

    One cache **slot** per batch lane (``repro_torch.models.transformer.
    init_lm_cache``: every leaf has the slot on axis 0).  Per
    :meth:`step`:

    1. **admit**: every free slot pops the queue; the new request's prompt
       is prefilled into that slot only (``lm_prefill_slot`` zeroes the
       lane and fills it), its first token is sampled from its own
       last-prompt-position logits, and the slot's position starts at the
       true (unpadded) prompt length.
    2. **decode**: ONE ``lm_decode_step`` over the full batch with
       per-request positions; empty slots ride along masked inactive
       (their logits are dropped and they generate nothing).
    3. **retire**: requests that produced ``max_new_tokens`` tokens, or
       filled the cache (``truncated``), free their slot for the next
       admit.

    Sampling is greedy argmax, or Gumbel-max for temperature sampling
    (``argmax(logits/T + Gumbel)``, one exact softmax draw per row) from a
    numpy generator: the JAX package's numbers under the same seed.

    Prompts are right-padded to a multiple of ``prefill_bucket``, as in
    the JAX package (there it bounds jit retraces).  For attention the
    padding changes nothing: the first token is sampled at the true last
    prompt position and each padded KV entry is overwritten before the
    mask exposes it.  The SSM recurrence and conv tail do run over the
    padding, so for SSM archs the continuation depends on the bucket —
    the JAX package's behaviour, reproduced here (ROADMAP §C).

    Thread-safe: ``submit`` may race ``step``/``drain`` from another
    thread.  ``_sched_lock`` (slot table + queue) ranks before
    ``_stats_lock`` (counters), as in the JAX package's serving lock
    order; a prefill under ``_sched_lock`` reads the ``use_pallas``
    toggle, whose lock ranks after both
    (``repro_torch.analysis.watchdog.SERVING_LOCK_ORDER``).
    """

    def __init__(self, cfg, params, batch: int, max_seq: int, *,
                 seed: int = 0, temperature: float = 0.0,
                 prefill_bucket: int = 8, device=None):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.prefill_bucket = max(1, int(prefill_bucket))
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)

        self._sched_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        caches = T.init_lm_cache(cfg, batch, max_seq, device=self.device)
        self.caches = caches                        # guarded-by: _sched_lock
        self._reqs: List[Optional[Request]] = [None] * batch  # guarded-by: _sched_lock
        self._pos = np.zeros(batch, np.int32)       # guarded-by: _sched_lock
        self._tok = np.zeros(batch, np.int32)       # guarded-by: _sched_lock
        self._need = np.zeros(batch, np.int64)      # guarded-by: _sched_lock
        self._queue: Deque[Request] = collections.deque()  # guarded-by: _sched_lock
        self._completed: List[Request] = []         # guarded-by: _sched_lock
        self._counters = {  # guarded-by: _stats_lock
            "admitted": 0, "retired": 0, "truncated": 0, "prefills": 0,
            "decode_steps": 0, "decode_tokens": 0, "tokens_generated": 0}
        self._decode_seconds = 0.0                  # guarded-by: _stats_lock
        self._prefill_seconds = 0.0                 # guarded-by: _stats_lock
        self._tok_s_ema = 0.0                       # guarded-by: _stats_lock

    # -- sampling ---------------------------------------------------------
    def _sample(self, logits: np.ndarray) -> np.ndarray:
        """Greedy argmax, or one vectorized Gumbel-max softmax draw per
        row (identical in distribution to ``rng.choice(p=softmax)``)."""
        if self.temperature <= 0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        z = logits / self.temperature
        g = self._rng.gumbel(size=z.shape)
        return np.argmax(z + g, axis=-1).astype(np.int32)

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long, device=self.device)

    # -- request intake ---------------------------------------------------
    def submit(self, request: Request) -> None:
        """Enqueue one request; it is admitted when a slot frees up."""
        plen = len(request.prompt)
        if plen < 1:
            raise ValueError(f"request {request.uid}: empty prompt")
        if plen > self.max_seq:
            raise ValueError(
                f"request {request.uid}: prompt length {plen} exceeds "
                f"max_seq {self.max_seq}")
        with self._sched_lock:
            self._queue.append(request)

    # -- scheduler core ---------------------------------------------------
    def step(self) -> bool:
        """One scheduler tick: admit, decode once, retire.

        A request with ``max_new_tokens <= 0`` completes at admission
        without touching a slot.  Returns False only when the engine is
        idle (no queued requests, no active slots).
        """
        with self._sched_lock:
            # -- admit -------------------------------------------------
            worked = False
            for i in range(self.batch):
                if self._reqs[i] is not None:
                    continue
                if not self._queue:
                    break
                req = self._queue.popleft()
                worked = True
                req.generated = []
                if req.max_new_tokens <= 0:
                    self._completed.append(req)
                    with self._stats_lock:
                        self._counters["retired"] += 1
                    continue
                plen = len(req.prompt)
                bucket = self.prefill_bucket
                padded = min(self.max_seq, -(-plen // bucket) * bucket)
                toks = np.zeros((1, padded), np.int32)
                toks[0, :plen] = req.prompt
                t0 = time.perf_counter()
                logits, self.caches = T.lm_prefill_slot(
                    self.params, self.cfg, {"tokens": self._tokens(toks)},
                    self.caches, i, last_pos=[plen - 1])
                first = int(self._sample(logits.cpu().numpy())[0])
                dt_prefill = time.perf_counter() - t0
                req.generated.append(first)
                # done at admit: single-token request, or no cache room
                # left to write the first token's KV for further decode
                done_now = req.max_new_tokens == 1 or plen >= self.max_seq
                with self._stats_lock:
                    self._counters["admitted"] += 1
                    self._counters["prefills"] += 1
                    self._counters["tokens_generated"] += 1
                    self._prefill_seconds += dt_prefill
                    if done_now:
                        self._counters["retired"] += 1
                        if req.max_new_tokens > 1:
                            self._counters["truncated"] += 1
                if done_now:
                    self._completed.append(req)
                    continue
                self._reqs[i] = req
                self._pos[i] = plen
                self._tok[i] = first
                self._need[i] = req.max_new_tokens - 1

            # -- decode ------------------------------------------------
            active = np.flatnonzero(self._need > 0)
            if active.size == 0:
                return worked
            t0 = time.perf_counter()
            logits, self.caches = T.lm_decode_step(
                self.params, self.cfg, self._tokens(self._tok[:, None]),
                self.caches, self._tokens(self._pos))
            nxt = self._sample(logits.cpu().numpy())
            dt = time.perf_counter() - t0

            # -- retire ------------------------------------------------
            retired = truncated = 0
            for i in active:
                req = self._reqs[i]
                req.generated.append(int(nxt[i]))
                self._tok[i] = nxt[i]
                self._pos[i] += 1
                self._need[i] -= 1
                if self._need[i] <= 0:
                    self._reqs[i] = None
                    self._need[i] = 0
                    self._completed.append(req)
                    retired += 1
                elif self._pos[i] >= self.max_seq:
                    # cache full: retire mid-decode with what we have
                    self._reqs[i] = None
                    self._need[i] = 0
                    self._completed.append(req)
                    retired += 1
                    truncated += 1
            with self._stats_lock:
                # only REAL generated tokens count: inactive slots
                # produce nothing
                self._counters["retired"] += retired
                self._counters["truncated"] += truncated
                self._counters["decode_steps"] += 1
                self._counters["decode_tokens"] += int(active.size)
                self._counters["tokens_generated"] += int(active.size)
                self._decode_seconds += dt
                rate = active.size / max(dt, 1e-9)
                self._tok_s_ema = (
                    rate if self._counters["decode_steps"] == 1
                    else self._tok_s_ema
                    + _TOK_S_EMA * (rate - self._tok_s_ema))
        return True

    def completed(self) -> List[Request]:
        """Harvest requests finished so far without driving the engine."""
        with self._sched_lock:
            done, self._completed = self._completed, []
        return done

    def drain(self) -> List[Request]:
        """Run the scheduler until idle; return newly completed requests."""
        while self.step():
            pass
        return self.completed()

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        """Serving dashboard: slot occupancy, queue depth, counters.

        The JAX package's keys, plus ``prefill_seconds`` (host clock from
        the prefill call to the first token's sample, which waits for the
        device).  ``decode_tokens`` counts only tokens generated by decode
        steps; ``tokens_generated`` adds each request's first token;
        ``tok_s_ema`` smooths the per-step decode rate.
        """
        with self._sched_lock:
            occupied = sum(r is not None for r in self._reqs)
            queue_depth = len(self._queue)
            with self._stats_lock:
                counters = dict(self._counters)
                decode_seconds = self._decode_seconds
                prefill_seconds = self._prefill_seconds
                tok_s_ema = self._tok_s_ema
        return {
            **counters,
            "slots": self.batch,
            "occupied": occupied,
            "queue_depth": queue_depth,
            "decode_seconds": decode_seconds,
            "prefill_seconds": prefill_seconds,
            "tok_s_ema": tok_s_ema,
        }


class Server:
    """Continuous-batching LM server over a :class:`DecodeScheduler`.

    The weights are drawn from a ``torch.Generator`` on ``device`` seeded
    with ``seed``.  ``serve_batch`` submits every request, drains, and
    returns them (mutated in place, original order).
    """

    def __init__(self, cfg, batch: int, max_seq: int, *, seed: int = 0,
                 temperature: float = 0.0, prefill_bucket: int = 8,
                 device=None):
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = T.init_lm(gen, cfg, device=self.device)
        self.scheduler = DecodeScheduler(
            cfg, self.params, batch, max_seq, seed=seed,
            temperature=temperature, prefill_bucket=prefill_bucket,
            device=self.device)
        self.last_decode_tok_s = 0.0

    def submit(self, request: Request) -> None:
        self.scheduler.submit(request)

    def drain(self) -> List[Request]:
        return self.scheduler.drain()

    def stats(self) -> dict:
        """Scheduler stats plus the last ``serve_batch`` decode rate."""
        return {**self.scheduler.stats(),
                "last_decode_tok_s": self.last_decode_tok_s}

    def serve_batch(self, requests: List[Request]) -> List[Request]:
        """Serve ``requests`` to completion and return them in order.

        ``last_decode_tok_s`` counts only real generated tokens over the
        decode wall time of this call.
        """
        if not requests:
            return []
        before = self.scheduler.stats()
        for req in requests:
            self.scheduler.submit(req)
        self.scheduler.drain()
        after = self.scheduler.stats()
        toks = after["decode_tokens"] - before["decode_tokens"]
        secs = after["decode_seconds"] - before["decode_seconds"]
        self.last_decode_tok_s = toks / max(secs, 1e-9)
        return list(requests)

#: smoothing factor for the server's per-phase latency EMAs.
_LATENCY_EMA = 0.2
#: smoothing factor for the per-cluster reward EMAs in the policy state
#: (and for the "system" state's availability and latency EMAs).
_REWARD_EMA = 0.2


class CohortServer:
    """Cohort-selection service backed by a :class:`CohortEngine`.

    Selections are serialized on ``_select_lock`` and engine entries,
    inline or background, on ``_solve_lock`` (the engine's warm-start
    state is single-writer); ``update_embeddings`` appends O(delta) rows
    under ``_write_lock`` and :meth:`snapshot` materializes them lazily
    into a fresh immutable table.  Dashboard counters live under the
    innermost serving lock, ``_stats_lock``.  The lock names and ranks
    are the JAX package's, in the port's
    ``repro_torch.analysis.watchdog.SERVING_LOCK_ORDER`` (where only the
    kernel locks rank after ``_stats_lock``).

    Streaming (``streaming=StreamingSpec(...)``): every
    ``update_embeddings`` marks the table dirty on a
    :class:`repro_torch.streaming.BackgroundSolver`, whose worker
    snapshots the freshest table, runs ``engine.prepare`` + ``publish``
    under ``_solve_lock`` and parks ``(version, table, result)`` in the
    ``_published`` mailbox.  The next select swaps it into ``_served`` and
    draws from it with no solve inline, unless the served version has
    fallen more than ``max_stale_versions`` behind the table, which forces
    one inline solve.  A failed background solve is counted in the
    solver's ``stats["errors"]`` and never reaches a caller.

    Args:
        num_clients:  N, rows of the embedding table.
        embed_dim:    d, embedding width.
        config:       :class:`CohortConfig` for the engine.
        seed:         seeds the engine, the draw rng and the Q-network.
        policy:       "stratified" | "dqn".
        target_accuracy: reward pivot for the DQN policy's shaping.
        dqn_overrides: DQNConfig field overrides for ``policy="dqn"``.
        state_features: DQN serving-state layout, ``"rich"`` (``5k + 1``),
            ``"system"`` (``7k + 1``: plus per-cluster availability and
            latency EMAs fed by ``observe_round(outcome=...)``) or
            ``"basic"`` (``3k + 1``).
        streaming:    :class:`repro_torch.streaming.StreamingSpec` enabling
            background re-clustering (and admission knobs for
            ``select_cohort``); None solves inline.
        solver:       a :class:`repro_torch.streaming.BackgroundSolver`
            shared across servers (the frontend's); None with
            ``streaming`` set creates and owns a private one.
        deduper:      a shared :class:`repro_torch.streaming.SolveDeduper`
            so identical-fingerprint tenants ride one solve; None
            disables dedupe for this server.
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
        # mailbox the background solver fills and the select path drains
        self._publish_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._version = 0                 # guarded-by: _write_lock
        self._base = table                # guarded-by: _write_lock
        self._delta_ids: List[np.ndarray] = []    # guarded-by: _write_lock
        self._delta_rows: List[np.ndarray] = []   # guarded-by: _write_lock
        self._delta_pending = 0           # guarded-by: _write_lock
        self._materializations = 0        # guarded-by: _write_lock

        # streaming double-buffer: _published is the background solver's
        # finished (version, table, result); _served is the triple selects
        # currently draw from
        self._streaming = streaming
        self._published = None            # guarded-by: _publish_lock
        self._served = None               # guarded-by: _select_lock
        self._closed = False              # guarded-by: _select_lock
        self._deduper = deduper
        self._own_solver = streaming is not None and solver is None
        if self._own_solver:
            solver = BackgroundSolver(streaming.solver_workers)
        self._solver = solver if streaming is not None else None
        self.admission = None
        if streaming is not None and (streaming.max_queue_depth is not None
                                      or streaming.rate_per_s is not None):
            self.admission = AdmissionController(
                max_queue_depth=streaming.max_queue_depth,
                rate_per_s=streaming.rate_per_s, burst=streaming.burst)

        self._participation = np.zeros(k, np.float64)   # guarded-by: _select_lock
        self._reward_ema = np.zeros(k, np.float32)      # guarded-by: _select_lock
        # selects since each cluster last contributed a served client
        self._staleness = np.zeros(k, np.float64)       # guarded-by: _select_lock
        # client-realism EMAs behind the "system" state: per-cluster
        # completion rate and mean simulated latency, fed by
        # observe_round(outcome=...); availability starts optimistic (1)
        self._avail_ema = np.ones(k, np.float64)        # guarded-by: _select_lock
        self._latency_ema_s = np.zeros(k, np.float64)   # guarded-by: _select_lock
        # cluster assignment of the latest served solve (any policy):
        # maps an outcome's client ids back to clusters
        self._last_assign = None                        # guarded-by: _select_lock
        self.prev_accuracy = 0.0                        # guarded-by: _select_lock
        # parked (state_vec, actions, assign, table) until observe_round
        self._pending = None                            # guarded-by: _select_lock
        self._latency = {  # guarded-by: _stats_lock
            "solve_s": 0.0, "draw_s": 0.0, "total_s": 0.0}
        self._round_timings: dict = {}                  # guarded-by: _stats_lock
        self._counters = {  # guarded-by: _stats_lock
            "requests": 0, "batches": 0, "updates": 0,
            "rounds_observed": 0, "dropped_transitions": 0,
            # streaming: background warms landed / selects answered from
            # a warmed result / selects that had to solve inline / warms
            # adopted from another tenant's identical-fingerprint solve
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
        """A consistent ``(version, table)``; the table is immutable.

        Pending deltas are materialized into a fresh table only when
        there are any; readers of an older snapshot are never affected.
        """
        return self._flush()

    def _flush(self):
        """Apply pending deltas to the base table (self-locking)."""
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
        With ``streaming`` the update also marks this server dirty on the
        background solver, so a fresh solve starts warming at once.
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
            self._flush()
        with self._stats_lock:
            self._counters["updates"] += 1
        if self._solver is not None:
            self._solver.submit(id(self), self._background_warm)

    # -- streaming (background warm + shutdown) ---------------------------
    def _background_warm(self) -> None:
        """Solve-ahead task run on a :class:`BackgroundSolver` worker.

        Snapshots the freshest table, computes (or, with dedupe, adopts)
        a :class:`repro_torch.cohort.PreparedSolve` for it, publishes it
        into the engine under ``_solve_lock`` and parks the finished
        ``(version, table, result)`` in the ``_published`` mailbox.
        Never takes ``_select_lock``.  The kernels launch from this thread
        on its current stream, which is the device's default stream
        unless the caller set another, so they are ordered with the
        select thread's work; no autograd graph is recorded.
        """
        version, table = self.snapshot()
        with self._publish_lock:
            pub = self._published
        if pub is not None and pub[0] >= version:
            return                      # already warmed this generation
        ticket = prep = None
        if self._deduper is not None:
            # key on (table content, engine config): identical tables
            # under different cluster counts or methods must not share a
            # solve, or the adopted result's k would be wrong
            ticket, prep = self._deduper.begin(
                (CohortEngine.fingerprint(table), repr(self.config)))
        if prep is not None:            # adopt another tenant's solve
            with self._solve_lock:
                res = self.engine.publish(prep, count=False)
            with self._stats_lock:
                self._counters["dedupe_hit"] += 1
        else:
            try:
                with self._solve_lock, torch.no_grad():
                    own = self.engine.prepare(table)
                    res = (None if own is None
                           else self.engine.publish(own))
            except BaseException:
                if ticket is not None:
                    self._deduper.abort(ticket)
                raise
            if ticket is not None:
                if own is not None:
                    self._deduper.complete(ticket, own)
                else:
                    self._deduper.abort(ticket)
            if res is None:
                return                  # engine already current: no-op
        with self._publish_lock:
            if self._published is None or version > self._published[0]:
                self._published = (version, table, res)
        with self._stats_lock:
            self._counters["warm_ahead"] += 1

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop serving: reject new selects, stop an owned solver.

        Later ``select_cohort(s)`` calls raise
        :class:`ServiceClosedError`; a background solver created by this
        server (not a shared one) is drained and joined within
        ``timeout`` seconds.  Idempotent.
        """
        with self._select_lock:
            self._closed = True
        if self._own_solver and self._solver is not None:
            self._solver.close(timeout)

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
        rich = self.state_features in ("rich", "system")
        system = self.state_features == "system"
        return cluster_policy_state(
            assign, self.config.num_clusters,
            self._participation, self._reward_ema, self.prev_accuracy,
            embeds=table if rich else None,
            staleness=self._staleness if rich else None,
            availability=self._avail_ema if system else None,
            latency_s=self._latency_ema_s if system else None,
            features=self.state_features)

    def select_cohort(self, cohort_size: int):
        """Serve one cohort; returns ``(client_ids, CohortResult)``.

        With ``policy="dqn"`` the draw's (state, actions) pair is parked
        until :meth:`observe_round` reports the round's accuracy.  When
        the streaming spec sets admission knobs this path sheds with a
        typed :class:`repro_torch.streaming.ShedError` before touching
        the engine.
        """
        if self.admission is not None:
            self.admission.try_admit()
            try:
                return self.select_cohorts([cohort_size])[0]
            finally:
                self.admission.release()
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
            version, table = self.snapshot()
            res = None
            if self._streaming is not None:
                # drain the background solver's mailbox: swap in the
                # warmed (version, table, result) if it is newer than what
                # is being served
                with self._publish_lock:
                    pub = self._published
                if pub is not None and (self._served is None
                                        or pub[0] > self._served[0]):
                    self._served = pub
                if self._served is not None:
                    max_stale = self._streaming.max_stale_versions
                    if (max_stale is None
                            or version - self._served[0] <= max_stale):
                        _, table, res = self._served
                        with self._stats_lock:
                            self._counters["served_warm"] += 1
            if res is None:
                # not streaming, nothing warmed yet, or the served version
                # is too stale: solve inline
                with self._solve_lock:
                    res = self.engine.select_batched(
                        table, requests=len(sizes))
                if self._streaming is not None:
                    self._served = (version, table, res)
                    with self._stats_lock:
                        self._counters["forced_inline"] += 1
            t_solve = time.perf_counter()
            k = self.config.num_clusters
            self._last_assign = res.assign
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

    def _outcome_cluster_rates(self, outcome):
        """Per-cluster completion and latency rates of a realism outcome.

        Maps ``outcome.selected`` through the last solve's assignment and
        bins the completed/dropped split and the simulated round trips per
        cluster.  Returns ``(seen, avail, latency)``: the clusters observed
        this round and this round's completion-rate and mean-latency
        vectors, or ``None`` when nothing maps.  Pure; the caller holds
        ``_select_lock`` and applies the EMA updates itself.
        """
        assign = self._last_assign
        if assign is None or not len(outcome.selected):
            return None
        k = self.config.num_clusters
        sel = np.asarray(outcome.selected)
        lat = np.asarray(outcome.latencies_s)
        in_table = (sel >= 0) & (sel < len(assign))
        sel, lat = sel[in_table], lat[in_table]
        if not len(sel):
            return None
        clusters = assign[sel]
        completed = np.isin(sel, np.asarray(outcome.completed))
        counts = np.bincount(clusters, minlength=k)[:k].astype(np.float64)
        hits = np.bincount(clusters, weights=completed.astype(np.float64),
                           minlength=k)[:k]
        lat_sum = np.bincount(clusters, weights=lat, minlength=k)[:k]
        seen = counts > 0
        avail = np.zeros(k)
        latency = np.zeros(k)
        avail[seen] = hits[seen] / counts[seen]
        latency[seen] = lat_sum[seen] / counts[seen]
        return seen, avail, latency

    def observe_round(self, accuracy: float, timings: Optional[dict] = None,
                      outcome=None) -> float:
        """Report a completed round back to the server; returns the reward.

        The reward is ``Ξ^(acc − target) − 1``.  With ``policy="dqn"`` the
        parked (state, actions) plus the new state go into the replay
        buffer and one TD minibatch runs.  ``timings`` are folded into
        the per-phase running means of :meth:`stats`.  ``outcome`` (a
        ``repro_torch.fed.realism.RoundOutcome``) feeds the per-cluster
        availability and latency EMAs of ``state_features="system"`` and
        blends the reward with deadline attainment (``blended_reward``).
        """
        if outcome is not None:
            reward = blended_reward(accuracy, self.target_accuracy,
                                    outcome.attainment)
        else:
            reward = favor_reward(accuracy, self.target_accuracy)
        # same lock as select_cohorts: a racing selection must not park a
        # new transition between our read of _pending and its clear
        with self._select_lock:
            if outcome is not None:
                rates = self._outcome_cluster_rates(outcome)
                if rates is not None:
                    seen, avail, latency = rates
                    self._avail_ema[seen] += _REWARD_EMA * (
                        avail[seen] - self._avail_ema[seen])
                    self._latency_ema_s[seen] += _REWARD_EMA * (
                        latency[seen] - self._latency_ema_s[seen])
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

        Counters (the streaming ones ``warm_ahead`` / ``served_warm`` /
        ``forced_inline`` / ``dedupe_hit`` always present, 0 when
        streaming is off), ``shed`` (selects rejected by admission
        control), table version and size, ``engine`` counters, a
        ``streaming`` sub-dict (enabled flag, ``max_stale_versions``, the
        served version, delta-buffer ``materializations``, the admission
        and, for an owned solver, the solver breakdowns), EMA latencies,
        round-timing means, the last solve's provenance and the policy's
        ε / replay fill.
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
        admission = (None if self.admission is None
                     else self.admission.stats())
        shed = (0 if admission is None
                else admission["shed_queue"] + admission["shed_rate"])
        spec = self._streaming
        served = self._served
        streaming = {
            "enabled": spec is not None,
            "max_stale_versions": (None if spec is None
                                   else spec.max_stale_versions),
            "served_version": None if served is None else served[0],
            "materializations": materializations,
            "admission": admission,
        }
        if self._own_solver and self._solver is not None:
            streaming["solver"] = dict(self._solver.stats)
        return {
            **counters,
            "shed": shed,
            "table_version": self.version,
            "num_clients": num_clients,
            "state_features": self.state_features,
            "engine": dict(self.engine.stats),
            "streaming": streaming,
            "latency_s": latency,
            "round_timings_s": round_timings,
            "last_select": None if last is None else {
                "method": last.method, "source": last.source,
                "drift": last.drift, "k": last.k,
                "seconds": last.seconds},
            "policy": policy,
        }


def cohort_config(args) -> CohortConfig:
    """The engine configuration of the ``--cohort`` demos' flags."""
    num_landmarks = args.num_landmarks
    if num_landmarks not in (None, "auto"):
        num_landmarks = int(num_landmarks)
    return CohortConfig(num_clusters=args.num_clusters,
                        landmarks=args.landmarks,
                        num_landmarks=num_landmarks,
                        use_pallas=args.use_pallas,
                        affinity_dtype=args.affinity_dtype)


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
    streaming = (StreamingSpec(max_stale_versions=args.max_stale)
                 if args.streaming else None)
    server = CohortServer(
        args.cohort, d, seed=args.seed, policy=args.policy,
        target_accuracy=0.85, device=args.device, streaming=streaming,
        config=cohort_config(args))
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


def _lm_main(args) -> None:
    """LM demo: random weights, random prompts, served to completion."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    server = Server(cfg, args.batch, args.prompt_len + args.gen_len,
                    temperature=args.temperature, seed=args.seed,
                    device=args.device)
    reqs = []
    for i in range(args.requests or args.batch):
        if args.mixed:
            plen = int(rng.integers(1, args.prompt_len + 1))
            gen = int(rng.integers(1, args.gen_len + 1))
        else:
            plen, gen = args.prompt_len, args.gen_len
        reqs.append(Request(i, rng.integers(0, cfg.vocab_size,
                                            plen).astype(np.int32), gen))
    t0 = time.perf_counter()
    with ops.use_pallas_scoped(args.use_pallas):
        done = server.serve_batch(reqs)
    stats = server.stats()
    print(f"served {len(done)} requests in {time.perf_counter() - t0:.1f}s "
          f"on {server.device} ({server.last_decode_tok_s:,.1f} decode "
          f"tok/s)")
    print(f"scheduler: admitted={stats['admitted']} "
          f"retired={stats['retired']} truncated={stats['truncated']} "
          f"decode_steps={stats['decode_steps']} "
          f"decode_tokens={stats['decode_tokens']} "
          f"tok_s_ema={stats['tok_s_ema']:,.1f}")
    for r in done[:2]:
        print(f"req {r.uid}: first 10 generated tokens {r.generated[:10]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=0, metavar="R",
                    help="total LM requests to serve (default: one per "
                         "batch slot); R > batch exercises the "
                         "admit/retire scheduler")
    ap.add_argument("--mixed", action="store_true",
                    help="draw mixed prompt/generation lengths instead "
                         "of uniform --prompt-len/--gen-len")
    ap.add_argument("--cohort", type=int, default=0, metavar="N",
                    help="serve cohort selection for N clients instead "
                         "of the LM loop")
    ap.add_argument("--cohort-size", type=int, default=64)
    ap.add_argument("--num-clusters", type=int, default=8)
    ap.add_argument("--num-landmarks", default=None,
                    help="Nyström landmark count: an int, or 'auto'")
    ap.add_argument("--landmarks", default="uniform",
                    choices=["uniform", "leverage", "kmeans++"])
    ap.add_argument("--policy", default="stratified",
                    choices=["stratified", "dqn"])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--tenants", type=int, default=0, metavar="T",
                    help="with --cohort: serve T model-family tenants "
                         "through the coalescing CohortFrontend instead "
                         "of one CohortServer")
    ap.add_argument("--concurrency", type=int, default=16,
                    help="concurrent select workers in --tenants mode")
    ap.add_argument("--batch-window", type=float, default=0.0,
                    help="extra coalescing wait (s) in --tenants mode; "
                         "0 = natural batching only")
    ap.add_argument("--streaming", action="store_true",
                    help="double-buffered background re-clustering: "
                         "serve version v while a BackgroundSolver "
                         "warms v+1 (repro_torch.streaming)")
    ap.add_argument("--max-stale", type=int, default=None, metavar="V",
                    help="with --streaming: force an inline solve when "
                         "the served version falls more than V table "
                         "versions behind (default: never)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the hand-written CUDA kernels: the fused "
                         "landmark solve (--cohort), or the flash-attention "
                         "and SSD prefill (LM mode); the JAX package's "
                         "use_pallas knob")
    ap.add_argument("--affinity-dtype", default="f32",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.cohort and args.tenants:
        from repro_torch.launch.frontend import run_demo
        run_demo(args)
    elif args.cohort:
        _cohort_main(args)
    else:
        _lm_main(args)


if __name__ == "__main__":
    main()
