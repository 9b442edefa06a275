"""Drive one cell through the program: set-up, the measured window, and
the records the metrics and the comparison read.

The program under test is the port's multi-tenant cohort service,
``repro_torch.launch.frontend.CohortFrontend``: one tenant a task, each
a ``CohortServer`` with the DQN cluster policy.  One thread a tenant
plays that tenant's orchestrator in a closed loop: a round is a select
of its cohort, ``update_embeddings`` of the rows its clients report,
and ``observe_round`` with the round's accuracy.  The benchmark's own
spans time each of the three calls; two pass-through wrappers record
what the program produced for the comparison (the policy's draw with
the state and the action values it drew from, and each solve the engine
published), and every round of a tenant, set-up's included, is kept so
that the reference can follow its policy from the start.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from perfbench.harness.traffic import TableLog, TenantTraffic

JOIN_SLACK_S = 120.0          # past the window, the last rounds may finish


@dataclasses.dataclass
class Span:
    name: str
    tenant: int
    start: float
    end: float


@dataclasses.dataclass
class Draw:
    state: np.ndarray             # the state the policy was given
    q: np.ndarray                 # the action values it drew with
    actions: list
    picked: list


@dataclasses.dataclass
class SelectRecord:
    """One round of a tenant: its select and what closed it."""
    tenant: int
    window: bool                  # a select of the measured window
    start: float
    end: float
    ok: bool
    error: Optional[str]
    version: int                  # the table's version at the call
    ids: Optional[np.ndarray] = None
    assign: Optional[np.ndarray] = None      # the answering solve's labels
    draw: Optional[Draw] = None
    answer: Optional[int] = None  # the number of the solve it was given
    accuracy: Optional[float] = None         # reported by observe_round

    @property
    def latency_s(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(eq=False)
class Publish:
    """One solve the engine published."""
    tenant: int
    t: float
    fp: bytes
    warm: bool
    drift: float
    source: str
    seconds: float
    seq: int = 0                  # this solve's number, in the tenant's log
    version: Optional[int] = None   # the table version it solved (check)
    result: object = None         # CohortResult, kept for sampled solves


class _Sampler:
    """Keeps the results of a seed-drawn sample of the window's solves
    (reservoir sampling, so exactly ``size`` of however many come), and
    of each tenant's first cold solve in the window."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 77]))
        self.seen = 0
        self.sample: list = []
        self.first_cold: dict = {}
        self.lock = threading.Lock()

    @property
    def kept(self) -> list:
        return list(self.first_cold.values()) + self.sample

    def offer(self, pub: Publish, result) -> None:
        with self.lock:
            if not pub.warm and pub.tenant not in self.first_cold:
                self.first_cold[pub.tenant] = pub
            else:
                self.seen += 1
                if len(self.sample) >= self.size:
                    j = int(self.rng.integers(self.seen))
                    if j >= self.size:
                        return
                    self.sample.pop(j).result = None
                self.sample.append(pub)
            pub.result = result


@dataclasses.dataclass
class Run:
    """What one run measured: the readers' and the comparison's input."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: str
    t0: float = 0.0               # the window's start (perf_counter)
    t0_ns: int = 0                # the same instant, time.time_ns
    close: float = 0.0            # t0 + seconds
    stop: float = 0.0             # every round of the window done
    setup_s: float = 0.0
    selects: list = dataclasses.field(default_factory=list)  # every round
    spans: list = dataclasses.field(default_factory=list)
    publishes: dict = dataclasses.field(default_factory=dict)
    stats_before: dict = dataclasses.field(default_factory=dict)
    stats_after: dict = dataclasses.field(default_factory=dict)
    logs: dict = dataclasses.field(default_factory=dict)
    tenants: list = dataclasses.field(default_factory=list)
    trace: object = None
    memory_peak_bytes: int = 0
    initial_q: dict = dataclasses.field(default_factory=dict)
    final_q: dict = dataclasses.field(default_factory=dict)
    policy_counts: dict = dataclasses.field(default_factory=dict)
    tenants_seeds: dict = dataclasses.field(default_factory=dict)

    def window_selects(self):
        return [r for r in self.selects if r.window]

    def rounds_of(self, tenant: int):
        """Every round of ``tenant``, set-up's first, in its order."""
        return [r for r in self.selects if r.tenant == tenant]

    def window_publishes(self):
        return [p for pubs in self.publishes.values() for p in pubs
                if self.t0 <= p.t <= self.close]

    def spans_named(self, name):
        return [s for s in self.spans if s.name == name
                and self.t0 <= s.start < self.close]


def cohort_config(config: dict):
    from repro_torch.cohort.engine import CohortConfig
    return CohortConfig(num_clusters=config["num_clusters"],
                        num_landmarks=config["num_landmarks"],
                        **config["engine"])


def tenant_seed(seed: int, tenant: int) -> int:
    return int(seed) + tenant


def dqn_overrides(config: dict) -> dict:
    """The Q-network's settings as the configuration states them."""
    d = dict(config["dqn"])
    d["hidden"] = tuple(d["hidden"])
    return d


def _capture_draws(server, sink: dict) -> None:
    """Pass-through wrappers: each draw's state, action values, actions
    and ids."""
    policy, agent = server.policy, server.policy.agent
    draw, q_values = policy.draw, agent.q_values

    def recording_q(state):
        q = q_values(state)
        sink["q"] = (np.array(state, np.float32), np.array(q))
        return q

    def recording_draw(rng, state_vec, pools, cohort_size):
        picked, actions = draw(rng, state_vec, pools, cohort_size)
        state, q = sink.pop("q")
        sink["draw"] = Draw(state, q, list(actions), list(picked))
        return picked, actions

    agent.q_values = recording_q
    policy.draw = recording_draw


def _capture_publishes(server, tenant: int, run: Run,
                       sampler: _Sampler) -> None:
    """Pass-through wrapper of the engine's publish: every solve's
    fingerprint and drift decision; a sampled solve's result."""
    engine = server.engine
    publish = engine.publish
    log = run.publishes.setdefault(tenant, [])

    def recording_publish(prep, *, count: bool = True):
        t = time.perf_counter()
        res = prep.result
        pub = Publish(tenant, t, prep.fingerprint, prep.warm, prep.drift,
                      res.source, res.seconds, seq=len(log))
        # tags the answer, so a select can name the solve it was given
        res.perfbench_solve = pub.seq
        log.append(pub)
        if run.t0 and run.t0 <= t <= run.close:
            sampler.offer(pub, res)
        return publish(prep, count=count)

    engine.publish = recording_publish


def build(run: Run, *, device):
    """The frontend, its tenants' traffic and their tables loaded."""
    from repro_torch.launch.frontend import CohortFrontend, TenantSpec
    cfg, traffic = run.config, run.traffic
    names = cfg["tenants"]
    specs = [TenantSpec(name, cfg["num_clients"], cfg["embed_dim"],
                        config=cohort_config(cfg),
                        seed=tenant_seed(run.seed, i),
                        policy=cfg["policy"],
                        target_accuracy=cfg["target_accuracy"],
                        state_features=cfg["state_features"],
                        dqn_overrides=dqn_overrides(cfg))
             for i, name in enumerate(names)]
    if traffic["loop"] != "closed":
        raise ValueError(f"this harness drives a closed loop only; the mix "
                         f"asks for {traffic['loop']!r}")
    fe = CohortFrontend(specs, device=device)
    sampler = _Sampler(cfg["check"]["solves"], run.seed)
    tenants = []
    for i, name in enumerate(names):
        server = fe.tenant(name)
        tt = TenantTraffic(cfg, traffic, run.seed, i)
        run.logs[i] = TableLog(tt.initial)
        run.tenants_seeds[i] = tenant_seed(run.seed, i)
        run.initial_q[i] = [p.detach().cpu().clone()
                            for p in server.policy.agent.net.parameters()]
        sink: dict = {}
        _capture_draws(server, sink)
        _capture_publishes(server, i, run, sampler)
        fe.update_embeddings(name, np.arange(cfg["num_clients"]),
                             tt.initial)
        tenants.append((name, server, tt, sink))
    run.tenants = tenants
    return fe, sampler


def _round(run: Run, fe, tenant: int, window: bool, lock) -> None:
    name, server, tt, sink = run.tenants[tenant]
    cohort = run.config["cohort_size"]
    version = server.version
    start = time.perf_counter()
    try:
        ids, res = fe.select_cohort(name, cohort)
        ok, err = True, None
    except Exception as exc:          # a failed select: missing, and
        # a cohort that never came (the comparison counts it)
        ids = res = None
        ok, err = False, f"{type(exc).__name__}: {exc}"
    end = time.perf_counter()
    rec = SelectRecord(tenant, window, start, end, ok, err, version)
    spans = [Span("select", tenant, start, end)]
    if ok:
        rec.ids = np.asarray(ids, np.int64)
        rec.assign = np.asarray(res.assign).astype(np.int16)
        rec.draw = sink.pop("draw", None)
        rec.answer = getattr(res, "perfbench_solve", None)
        t = time.perf_counter()
        for up_ids, rows in tt.updates(rec.ids):
            run.logs[tenant].append(up_ids, rows)
            fe.update_embeddings(name, up_ids, rows)
        t1 = time.perf_counter()
        rec.accuracy = tt.accuracy(rec.ids)
        fe.observe_round(name, rec.accuracy)
        t2 = time.perf_counter()
        spans += [Span("update", tenant, t, t1), Span("observe", tenant, t1,
                                                       t2)]
    with lock:
        run.selects.append(rec)
        if window:
            run.spans.extend(spans)


def _worker(run: Run, fe, tenant: int, warmed, go, lock, errors) -> None:
    try:
        for _ in range(run.traffic["warmup_rounds"]):
            _round(run, fe, tenant, False, lock)
        warmed.wait()
        go.wait()
        while time.perf_counter() < run.close:
            _round(run, fe, tenant, True, lock)
    except BaseException as exc:      # reported by the main thread
        errors.append(exc)
        warmed.abort()
        go.abort()


def drive(run: Run, fe, *, on_warmed=None, on_start=None) -> None:
    """Set-up's warm-up rounds, then the window; fills ``run``.

    ``on_warmed()`` runs once every tenant is warmed, before the window
    (the trace starts there); ``on_start()`` right at the window's start.
    """
    n = len(run.tenants)
    lock = threading.Lock()
    errors: list = []

    def start():
        run.t0 = time.perf_counter()
        run.t0_ns = time.time_ns()
        run.close = run.t0 + run.seconds

    warmed = threading.Barrier(n + 1)
    go = threading.Barrier(n + 1, action=start)
    threads = [threading.Thread(target=_worker, name=f"tenant-{i}",
                                args=(run, fe, i, warmed, go, lock, errors))
               for i in range(n)]
    for t in threads:
        t.start()
    try:
        warmed.wait()
        run.stats_before = {i: server.stats()
                            for i, (_, server, _, _) in
                            enumerate(run.tenants)}
        if on_warmed is not None:
            on_warmed()
        go.wait()
    except threading.BrokenBarrierError:
        pass
    if on_start is not None and not errors:
        on_start()
    for t in threads:
        t.join(timeout=run.seconds + JOIN_SLACK_S + 600)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a tenant's rounds did not finish")
    run.stop = time.perf_counter()
    run.stats_after = {i: server.stats()
                       for i, (_, server, _, _) in enumerate(run.tenants)}
    for i, (_, server, _, _) in enumerate(run.tenants):
        agent = server.policy.agent
        run.final_q[i] = [p.detach().cpu().clone()
                          for p in agent.net.parameters()]
        run.policy_counts[i] = {"steps": agent.steps,
                                "train_calls": agent.train_calls}
