"""Multi-tenant cohort-serving frontend: named tenants + request coalescing.

Port of the JAX package's ``launch/frontend.py`` over the port's
``CohortServer``, with the same names, lock names and counters.  Every
tenant's engine runs on the frontend's ``device`` (``"cuda"`` unless the
caller passes ``device="cpu"``); on the card the coalesced select runs
the fused Nyström kernels on the thread of the caller that seals the
batch, and background warms run them on the shared solver's thread.

``CohortServer`` (``repro_torch.launch.serve``) is a single-tenant service: one
embedding table, one engine, one policy, and a single-writer select path
— under concurrent traffic every ``select_cohort`` queues behind the
engine lock even when the callers would cluster the *same* table
version.  :class:`CohortFrontend` is the control-plane layer above it,
shaped like the shared selector service of the FL-systems literature
(FAVOR's device selector; the Kairouz et al. survey's cohort manager):

* **Tenants** — named ``(CohortEngine, ClusterPolicy)`` shards, one per
  model family, each a full :class:`~repro_torch.launch.serve.CohortServer`
  with its own embedding table, :class:`~repro_torch.cohort.CohortConfig`,
  seed, and policy.  Tenants are fully isolated: nothing is shared, so
  one family's drift or learning never perturbs another's.

* **Request coalescing** — concurrent ``select_cohort`` calls against
  the same tenant and embedding-table version are batched behind ONE
  engine entry: the first arrival becomes the batch *leader* and runs
  ``CohortServer.select_cohorts`` once; the batch stays open for
  joiners until the tenant's select lock is actually acquired (plus an
  optional ``batch_window_s`` pre-wait), so requests queuing behind an
  earlier solve ride the next batch together.  One fingerprint-cache-
  consistent :class:`~repro_torch.cohort.CohortResult` is fanned out to every
  waiter, with the cluster pools partitioned across the batch so no
  client is double-served within it.  A table-version bump opens a new
  batch (requests against different versions never coalesce).

Synchronous callers lose nothing: with no concurrency a batch is just
one request and the path degenerates to ``select_cohort``.

* **Streaming** (``streaming=StreamingSpec(...)``) — the frontend owns
  one shared :class:`repro_torch.streaming.BackgroundSolver` and
  :class:`repro_torch.streaming.SolveDeduper` and wires every streaming
  tenant's server to them: embedding updates warm the next table
  version off the select path, identical-fingerprint tenants ride one
  solve, and per-tenant admission control (bounded in-flight depth +
  token-bucket rate) sheds overload with typed
  :class:`repro_torch.streaming.ShedError`\\ s before it reaches the engine.
  ``close()`` (or the context manager) drains in-flight batches, joins
  the solver, and turns new selects into
  :class:`repro_torch.streaming.ServiceClosedError`.

  PYTHONPATH=src python -m repro_torch.launch.serve --cohort 20000 \
      --tenants 4 --cohort-size 64 --policy dqn --rounds 5 --streaming
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, Iterable, List, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.launch.serve import CohortServer, cohort_config
from repro_torch.streaming import (BackgroundSolver, ServiceClosedError,
                                   SolveDeduper, StreamingSpec)

#: default extra leader wait for followers, in seconds.  0 = rely on
#: natural batching alone: requests arriving while an earlier solve
#: holds the tenant's select lock coalesce into the next batch, and an
#: uncontended caller pays no added latency.  Set positive to also
#: coalesce bursty traffic that has no lock contention to queue behind.
DEFAULT_BATCH_WINDOW_S = 0.0


@dataclasses.dataclass
class TenantSpec:
    """Declarative description of one tenant shard (one model family).

    ``build()`` constructs the backing :class:`CohortServer`; every
    field after ``embed_dim`` mirrors the server's keyword of the same
    name.
    """
    name: str
    num_clients: int
    embed_dim: int
    config: Optional[object] = None       # CohortConfig
    seed: int = 0
    policy: str = "stratified"
    target_accuracy: float = 0.85
    dqn_overrides: Optional[dict] = None
    state_features: str = "rich"
    # repro_torch.streaming.StreamingSpec; None inherits the frontend's
    streaming: Optional[object] = None

    def build(self, *, streaming=None, solver=None, deduper=None,
              device=None) -> CohortServer:
        return CohortServer(
            self.num_clients, self.embed_dim, config=self.config,
            seed=self.seed, policy=self.policy,
            target_accuracy=self.target_accuracy,
            dqn_overrides=self.dqn_overrides,
            state_features=self.state_features,
            streaming=self.streaming or streaming,
            solver=solver, deduper=deduper, device=device)


class _Batch:
    """One in-flight coalesced select batch for a (tenant, version)."""

    __slots__ = ("version", "sizes", "closed", "done", "results", "error")

    def __init__(self, version: int):
        self.version = version
        self.sizes: List[int] = []
        self.closed = False
        self.done = threading.Event()
        self.results = None
        self.error: Optional[BaseException] = None


class _Tenant:
    """A named shard plus its coalescing state.

    Request/batch totals live in the server's own counters (one source
    of truth — ``CohortServer.stats()``); the only frontend-level
    extra is ``max_batch``, the largest coalesced batch realized.
    """

    def __init__(self, name: str, server: CohortServer):
        self.name = name
        self.server = server
        self.lock = threading.Lock()
        self.open_batch: Optional[_Batch] = None    # guarded-by: lock
        self.max_batch = 0                          # guarded-by: lock
        # selects currently inside select_cohort (leader or joiner);
        # close() drains on this
        self.inflight = 0                           # guarded-by: lock


class CohortFrontend:
    """Multi-tenant, request-batching cohort-selection service.

    Args:
        tenants: initial shards — a mapping ``name -> CohortServer`` or
            an iterable of :class:`TenantSpec`; more can be added later
            with :meth:`add_tenant`.
        batch_window_s: extra time a batch leader waits for concurrent
            requests to join before solving.  The default ``0`` relies
            on natural batching (requests arriving while a previous
            solve holds the select lock coalesce into the next batch);
            positive values also coalesce bursts with no lock
            contention, at that much added latency per batch.
        streaming: default :class:`repro_torch.streaming.StreamingSpec` for
            tenants built from :class:`TenantSpec`\\ s (a spec's own
            ``streaming`` field wins).  Streaming tenants share one
            frontend-owned background solver and solve deduper.
        device: the device of the tenants built from
            :class:`TenantSpec`\\ s: ``"cuda"`` unless ``"cpu"`` is passed.
    """

    def __init__(self, tenants: Union[Mapping[str, CohortServer],
                                      Iterable[TenantSpec], None] = None,
                 *, batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
                 streaming=None, device=None):
        self.batch_window_s = float(batch_window_s)
        self.streaming = streaming
        self.device = device
        self._registry_lock = threading.Lock()
        self._tenants: Dict[str, _Tenant] = {}  # guarded-by: _registry_lock
        # shared across streaming tenants, created on first need
        self._solver = None                     # guarded-by: _registry_lock
        self._deduper = None                    # guarded-by: _registry_lock
        self._closed = False                    # guarded-by: _registry_lock
        if tenants is not None:
            if isinstance(tenants, Mapping):
                for name, server in tenants.items():
                    self.add_tenant(name, server)
            else:
                for spec in tenants:
                    self.add_tenant(spec.name, spec)

    # -- tenant registry --------------------------------------------------
    def _shared_streaming(self, spec):
        """The frontend-wide (solver, deduper) pair, created lazily."""
        with self._registry_lock:
            if self._solver is None:
                self._solver = BackgroundSolver(spec.solver_workers)
            if self._deduper is None and spec.dedupe:
                self._deduper = SolveDeduper()
            return self._solver, self._deduper if spec.dedupe else None

    def add_tenant(self, name: str,
                   server: Union[CohortServer, TenantSpec]) -> CohortServer:
        """Register a shard; returns its :class:`CohortServer`.

        A :class:`TenantSpec` builds its server here — with the
        frontend's shared background solver and deduper when the spec
        (or the frontend default) enables streaming.  A pre-built
        :class:`CohortServer` is registered as-is.
        """
        if isinstance(server, TenantSpec):
            spec = server.streaming or self.streaming
            solver = deduper = None
            if spec is not None:
                solver, deduper = self._shared_streaming(spec)
            server = server.build(streaming=spec, solver=solver,
                                  deduper=deduper, device=self.device)
        with self._registry_lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = _Tenant(name, server)
        return server

    def _get(self, name: str) -> _Tenant:
        with self._registry_lock:
            try:
                return self._tenants[name]
            except KeyError:
                raise KeyError(
                    f"unknown tenant {name!r}; registered: "
                    f"{sorted(self._tenants)}") from None

    def tenant(self, name: str) -> CohortServer:
        """The backing :class:`CohortServer` of one shard."""
        return self._get(name).server

    @property
    def tenant_names(self) -> Tuple[str, ...]:
        with self._registry_lock:
            return tuple(self._tenants)

    # -- pass-throughs (per tenant, no coalescing needed) -----------------
    def update_embeddings(self, tenant: str, client_ids,
                          new_embeds) -> None:
        """Copy-on-write row update of one tenant's embedding table."""
        self._get(tenant).server.update_embeddings(client_ids, new_embeds)

    def observe_round(self, tenant: str, accuracy: float,
                      timings: Optional[dict] = None) -> float:
        """Report a completed round to one tenant; returns the reward."""
        return self._get(tenant).server.observe_round(accuracy, timings)

    # -- coalescing select ------------------------------------------------
    def select_cohort(self, tenant: str, cohort_size: int):
        """Serve one cohort from ``tenant``; returns ``(ids, result)``.

        Concurrent calls against the same tenant and table version
        coalesce: one caller (the leader) runs the engine once via
        ``CohortServer.select_cohorts`` and every waiter receives its
        own slice of the shared solve — cohorts within a batch are
        disjoint because they pop the same cluster pools.

        A streaming tenant's admission control runs first: past the
        configured in-flight depth or token-bucket rate the request is
        shed with a typed :class:`repro_torch.streaming.ShedError` before any
        batching or engine work.  After :meth:`close`, selects raise
        :class:`repro_torch.streaming.ServiceClosedError` instead.
        """
        if self._closed:
            raise ServiceClosedError("CohortFrontend is closed")
        t = self._get(tenant)
        adm = t.server.admission
        if adm is not None:
            adm.try_admit()                # raises ShedError on overload
        try:
            with t.lock:
                t.inflight += 1
                version = t.server.version
                batch = t.open_batch
                if (batch is not None and not batch.closed
                        and batch.version == version):
                    index = len(batch.sizes)
                    batch.sizes.append(int(cohort_size))
                    leader = False
                else:
                    batch = _Batch(version)
                    index = 0
                    batch.sizes.append(int(cohort_size))
                    t.open_batch = batch
                    leader = True
            try:
                if leader:
                    self._run_batch(t, batch)
                else:
                    batch.done.wait()
            finally:
                with t.lock:
                    t.inflight -= 1
        finally:
            if adm is not None:
                adm.release()
        if batch.error is not None:
            raise RuntimeError(
                f"coalesced select failed for tenant {t.name!r}"
            ) from batch.error
        return batch.results[index]

    def _run_batch(self, t: _Tenant, batch: _Batch) -> None:
        """Leader path: solve once for however many requests joined.

        The batch is sealed *inside* ``select_cohorts``, at the moment
        the tenant's select lock is actually acquired (``sizes_fn``
        callback) — so while an earlier batch's solve holds the lock,
        new arrivals keep coalescing into this one.  That is the natural
        batching that needs no waiting: an uncontended caller pays zero
        extra latency, a thundering herd rides one solve.  A positive
        ``batch_window_s`` adds an explicit pre-wait on top, for bursty
        traffic with no lock contention to lean on.
        """
        if self.batch_window_s > 0:
            time.sleep(self.batch_window_s)

        def seal() -> list:
            with t.lock:
                batch.closed = True        # no more joiners
                if t.open_batch is batch:
                    t.open_batch = None
                return list(batch.sizes)

        try:
            batch.results = t.server.select_cohorts(sizes_fn=seal)
            with t.lock:
                t.max_batch = max(t.max_batch, len(batch.results))
        except BaseException as exc:       # fan the failure out too
            batch.error = exc
        finally:
            with t.lock:                   # seal even on pre-seal failure
                batch.closed = True
                if t.open_batch is batch:
                    t.open_batch = None
            batch.done.set()

    # -- shutdown ---------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: reject, drain, join.  Idempotent.

        New ``select_cohort`` calls raise
        :class:`repro_torch.streaming.ServiceClosedError` immediately;
        in-flight coalesced batches are drained (bounded by
        ``timeout`` seconds overall), the shared background solver is
        drained and joined, and every tenant server is closed.
        """
        with self._registry_lock:
            if self._closed:
                return
            self._closed = True
            tenants = dict(self._tenants)
            solver = self._solver
        deadline = time.monotonic() + timeout
        for t in tenants.values():
            while True:
                with t.lock:
                    idle = t.inflight == 0 and t.open_batch is None
                if idle or time.monotonic() >= deadline:
                    break
                time.sleep(0.002)
        # tenant servers share the frontend's solver, so closing them
        # only flips their reject flag; the solver joins once, here
        for t in tenants.values():
            t.server.close()
        if solver is not None:
            solver.close(timeout=max(0.0, deadline - time.monotonic()))

    def __enter__(self) -> "CohortFrontend":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        """Aggregate + per-tenant serving stats.

        ``tenants`` maps each shard name to its full
        ``CohortServer.stats()`` dict plus ``max_batch`` (largest
        coalesced batch realized); ``frontend`` aggregates across
        shards — request/batch/solve totals come straight from the
        servers' own counters (single source of truth), and
        ``batch_factor = requests / batches`` is the mean realized
        coalescing per engine entry.  The streaming counters aggregate
        too: ``warm_ahead`` / ``served_warm`` / ``forced_inline`` /
        ``dedupe_hit`` / ``shed`` summed across shards.
        """
        with self._registry_lock:
            tenants = dict(self._tenants)
        per_tenant = {}
        agg = {"num_tenants": len(tenants), "requests": 0, "solves": 0,
               "cache_hits": 0, "batches": 0, "max_batch": 0,
               "rounds_observed": 0, "warm_ahead": 0, "served_warm": 0,
               "forced_inline": 0, "dedupe_hit": 0, "shed": 0}
        for name, t in tenants.items():
            st = t.server.stats()
            with t.lock:
                st["max_batch"] = t.max_batch
            per_tenant[name] = st
            agg["requests"] += st["requests"]
            agg["batches"] += st["batches"]
            agg["rounds_observed"] += st["rounds_observed"]
            agg["solves"] += st["engine"]["solves"]
            agg["cache_hits"] += st["engine"]["cache_hits"]
            agg["max_batch"] = max(agg["max_batch"], st["max_batch"])
            for key in ("warm_ahead", "served_warm", "forced_inline",
                        "dedupe_hit", "shed"):
                agg[key] += st[key]
        agg["batch_factor"] = agg["requests"] / max(agg["batches"], 1)
        return {"frontend": agg, "tenants": per_tenant}


def make_demo_frontend(num_tenants: int, num_clients: int, embed_dim: int,
                       *, config=None, seed: int = 0,
                       policy: str = "stratified",
                       batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
                       streaming=None, device=None) -> CohortFrontend:
    """Frontend with ``num_tenants`` synthetic model-family shards.

    Tenant ``family-i`` gets an independent seed (``seed + i``) so the
    shards' engines, draw rngs, and Q-networks are decorrelated — the
    isolation the tenant tests pin down.  ``streaming`` (a
    :class:`repro_torch.streaming.StreamingSpec`) applies to every shard,
    and every shard runs on ``device``.
    """
    specs = [TenantSpec(f"family-{i}", num_clients, embed_dim,
                        config=config, seed=seed + i, policy=policy)
             for i in range(num_tenants)]
    return CohortFrontend(specs, batch_window_s=batch_window_s,
                          streaming=streaming, device=device)


def run_demo(args) -> None:
    """`--cohort N --tenants T` CLI mode: concurrent multi-tenant serving.

    Spins up T tenant shards of N synthetic clients each and fires
    ``args.rounds`` waves of concurrent select requests (one thread per
    client worker, round-robin over tenants), reporting the realized
    coalescing factor and per-tenant serving stats.
    """
    rng = np.random.default_rng(args.seed)
    d = 8
    streaming = (StreamingSpec(max_stale_versions=args.max_stale)
                 if args.streaming else None)
    fe = make_demo_frontend(args.tenants, args.cohort, d,
                            config=cohort_config(args), seed=args.seed,
                            policy=args.policy,
                            batch_window_s=args.batch_window,
                            streaming=streaming, device=args.device)
    for name in fe.tenant_names:
        centers = rng.normal(size=(args.num_clusters, d)) * 6
        labels = rng.integers(0, args.num_clusters, args.cohort)
        fe.update_embeddings(
            name, np.arange(args.cohort),
            (centers[labels]
             + rng.normal(size=(args.cohort, d))).astype(np.float32))

    workers = max(args.concurrency, 1)
    for r in range(args.rounds):
        t0 = time.perf_counter()
        threads = []
        for w in range(workers):
            name = fe.tenant_names[w % len(fe.tenant_names)]
            th = threading.Thread(
                target=fe.select_cohort, args=(name, args.cohort_size))
            th.start()
            threads.append(th)
        for th in threads:
            th.join()
        dt = time.perf_counter() - t0
        for name in fe.tenant_names:
            fe.observe_round(name, 0.5 + 0.1 * rng.random())
        agg = fe.stats()["frontend"]
        print(f"round {r}: {workers} concurrent selects over "
              f"{args.tenants} tenants in {dt:.3f}s "
              f"({workers / max(dt, 1e-9):,.1f} selects/s, "
              f"batch factor {agg['batch_factor']:.2f})")
    fe.close()
    print("frontend stats:", json.dumps(fe.stats()["frontend"], indent=2,
                                        default=float))
