"""The port's streaming re-clustering (``repro_torch.streaming`` and the
server's double buffer) on the CPU: the cases of the JAX package's
``tests/test_streaming.py``, run on the port's stack.

* no select sees a torn (version, table, result) triple while a
  background solve is in flight, and the served version never moves
  backwards;
* after warm-up selects are answered from the warmed result, and
  ``max_stale_versions`` forces an inline solve deterministically;
* admission sheds deterministically at the configured depth and rate;
* identical-fingerprint tenants ride one engine solve;
* ``CohortFrontend.close()`` drains, joins and rejects;
* a background-warmed partition is the one an inline select of the same
  snapshot gives, bit for bit.

Every join, drain and close here has a timeout, and a test fails when it
runs out.  The lock-order cases instrument the port's objects, its
kernel locks included, with the port's watchdog
(``repro_torch.analysis``).
"""

import contextlib
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.analysis import instrument
from repro_torch.analysis.watchdog import OrderedLock
from repro_torch.cohort import CohortConfig, CohortEngine
from repro_torch.launch.frontend import CohortFrontend, TenantSpec
from repro_torch.launch.serve import CohortServer
from repro_torch.streaming import (AdmissionController, BackgroundSolver,
                                   QueueFullError, RateLimitError,
                                   ServiceClosedError, ShedError,
                                   SolveDeduper, StreamingSpec)

CFG = CohortConfig(num_clusters=3)
TIMEOUT = 30.0


def wait_until(predicate, timeout=20.0, step=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return predicate()


def join(thread):
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive(), f"{thread.name} did not finish"


def close_server(srv):
    srv.close(timeout=TIMEOUT)
    if srv._own_solver:
        assert not any(t.is_alive() for t in srv._solver._threads)


def close_frontend(fe):
    solver = fe._solver
    fe.close(timeout=TIMEOUT)
    if solver is not None:
        assert not any(t.is_alive() for t in solver._threads)


def mk_server(n=96, d=8, *, streaming=StreamingSpec(), solver=None,
              deduper=None, seed=0, policy="stratified"):
    srv = CohortServer(n, d, seed=seed, policy=policy, config=CFG,
                       streaming=streaming, solver=solver, deduper=deduper,
                       device="cpu")
    rng = np.random.default_rng(seed)
    srv.update_embeddings(np.arange(n),
                          rng.normal(size=(n, d)).astype(np.float32))
    return srv


def blob_table(n=120, k=3, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 8
    return (centers[rng.integers(0, k, n)]
            + rng.normal(size=(n, d)).astype(np.float32))


class DummySolver:
    """submit() records but never runs: the mailbox stays empty."""

    def __init__(self):
        self.submitted = []
        self.stats = {"submitted": 0, "runs": 0, "errors": 0,
                      "coalesced": 0}

    def submit(self, key, fn):
        self.submitted.append((key, fn))
        self.stats["submitted"] += 1
        return True


# -- delta ingest -------------------------------------------------------------

def test_delta_ingest_coalesces_updates_and_materializes_on_snapshot():
    n, d = 100, 4
    srv = CohortServer(n, d, seed=0, config=CFG, device="cpu")
    ref = np.zeros((n, d), np.float32)
    rng = np.random.default_rng(0)
    v0, before = srv.snapshot()
    for _ in range(5):
        ids = rng.integers(0, n, 7)
        rows = rng.normal(size=(7, d)).astype(np.float32)
        srv.update_embeddings(ids, rows)
        ref[ids] = rows                    # arrival order: later writes win
    assert srv.version == v0 + 5
    assert srv._materializations == 0
    version, table = srv.snapshot()
    assert version == v0 + 5
    assert srv._materializations == 1
    np.testing.assert_array_equal(table, ref)
    assert not table.flags.writeable
    np.testing.assert_array_equal(before, np.zeros((n, d), np.float32))
    assert srv.snapshot()[1] is table
    assert srv._materializations == 1


def test_delta_ingest_validates_ids_and_shapes_eagerly():
    srv = CohortServer(10, 4, seed=0, config=CFG, device="cpu")
    with pytest.raises(IndexError):
        srv.update_embeddings([10], np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError):
        srv.update_embeddings([0], np.zeros((1, 3), np.float32))
    assert srv.version == 0


def test_delta_ingest_flushes_inline_once_pending_rivals_table():
    n = 16
    srv = CohortServer(n, 4, seed=0, config=CFG, device="cpu")
    srv.update_embeddings(np.arange(n), np.ones((n, 4), np.float32))
    assert srv._materializations == 1


# -- the double buffer --------------------------------------------------------

def test_background_warm_lands_and_selects_stop_solving_inline():
    srv = mk_server()
    try:
        assert wait_until(lambda: srv.stats()["warm_ahead"] >= 1)
        inline0 = srv.stats()["forced_inline"]
        for _ in range(5):
            ids, _ = srv.select_cohort(8)
            assert len(ids) == 8
        st = srv.stats()
        assert st["forced_inline"] == inline0
        assert st["served_warm"] == 5
        assert st["streaming"]["served_version"] == srv.version
        assert st["streaming"]["solver"]["errors"] == 0
    finally:
        close_server(srv)


def test_background_warm_equals_inline_select_of_the_same_snapshot():
    """A warm solve is a pure function of (seed, tables solved): the
    worker's cold and warm-started results are the partitions a second
    engine with the same seed gives when it solves the same snapshots
    inline, bit for bit."""
    n, d = 400, 8
    x = blob_table(n, d=d)
    cfg = CohortConfig(num_clusters=3, method="nystrom", num_landmarks=48)
    srv = CohortServer(n, d, seed=1, config=cfg, streaming=StreamingSpec(),
                       device="cpu")
    try:
        warmed = []
        for step in range(2):
            table = x + np.float32(0.01 * step)
            srv.update_embeddings(np.arange(n), table)
            assert wait_until(
                lambda: srv.stats()["warm_ahead"] >= step + 1)
            _, res = srv.select_cohort(8)
            warmed.append((srv.snapshot()[1], res))
        st = srv.stats()
        assert st["forced_inline"] == 0 and st["served_warm"] == 2
        assert [res.source for _, res in warmed] == ["cold", "warm"]
        inline = CohortEngine(cfg, seed=1, device="cpu")
        for table, res in warmed:
            again = inline.select(table)
            assert again.source == res.source
            np.testing.assert_array_equal(again.assign, res.assign)
            np.testing.assert_array_equal(again.embedding, res.embedding)
    finally:
        close_server(srv)


def test_no_torn_tables_and_served_version_monotonic_under_churn():
    n, d = 64, 4
    srv = CohortServer(n, d, seed=0, config=CFG, streaming=StreamingSpec(),
                       device="cpu")
    violations, markers = [], {}
    spy_lock = threading.Lock()

    def checked(table):
        flat = np.asarray(table)
        if not np.all(flat == flat.flat[0]):
            violations.append("torn table")
        return float(flat.flat[0])

    orig_prepare = srv.engine.prepare
    orig_batched = srv.engine.select_batched

    def spy_prepare(table):
        marker = checked(table)
        prep = orig_prepare(table)
        if prep is not None:
            with spy_lock:
                markers[id(prep.result)] = (prep.result, marker)
        return prep

    def spy_batched(table, requests=1):
        marker = checked(table)
        res = orig_batched(table, requests=requests)
        with spy_lock:
            markers[id(res)] = (res, marker)
        return res

    srv.engine.prepare = spy_prepare
    srv.engine.select_batched = spy_batched
    base = np.zeros((n, d), np.float32)
    srv.update_embeddings(np.arange(n), base)
    stop = threading.Event()

    def churn():
        v = 0
        while not stop.is_set():
            v += 1
            srv.update_embeddings(np.arange(n), base + np.float32(v))

    writer = threading.Thread(target=churn)
    writer.start()
    try:
        seen = []
        for _ in range(60):
            _, res = srv.select_cohort(6)
            with spy_lock:
                seen.append(markers[id(res)][1])
        assert violations == []
        assert all(a <= b for a, b in zip(seen, seen[1:]))
    finally:
        stop.set()
        join(writer)
        close_server(srv)
    assert srv.stats()["warm_ahead"] >= 1


def test_max_stale_versions_bounds_staleness_deterministically():
    n, d = 48, 4
    srv = CohortServer(n, d, seed=0, config=CFG, solver=DummySolver(),
                       streaming=StreamingSpec(max_stale_versions=1),
                       device="cpu")
    srv.update_embeddings(np.arange(n), np.ones((n, d), np.float32))
    srv.select_cohort(4)                   # nothing warmed: inline (v1)
    assert srv.stats()["forced_inline"] == 1
    srv.select_cohort(4)                   # served v1 == table v1: warm
    srv.update_embeddings([0], np.zeros((1, d), np.float32))
    srv.select_cohort(4)                   # v2 - v1 == 1 <= max_stale
    assert srv.stats()["forced_inline"] == 1
    assert srv.stats()["served_warm"] == 2
    srv.update_embeddings([0], np.ones((1, d), np.float32))
    srv.select_cohort(4)                   # v3 - v1 == 2 > 1: inline
    st = srv.stats()
    assert st["forced_inline"] == 2
    assert st["streaming"]["served_version"] == 3


def test_unbounded_staleness_never_solves_inline_again():
    n, d = 48, 4
    srv = CohortServer(n, d, seed=0, config=CFG, solver=DummySolver(),
                       streaming=StreamingSpec(max_stale_versions=None),
                       device="cpu")
    srv.update_embeddings(np.arange(n), np.ones((n, d), np.float32))
    srv.select_cohort(4)
    for v in range(10):
        srv.update_embeddings([0], np.full((1, d), v, np.float32))
        srv.select_cohort(4)
    st = srv.stats()
    assert st["forced_inline"] == 1
    assert st["served_warm"] == 10


# -- admission control --------------------------------------------------------

def test_queue_depth_sheds_deterministically():
    adm = AdmissionController(max_queue_depth=2, name="t0")
    adm.try_admit()
    adm.try_admit()
    with pytest.raises(QueueFullError) as exc:
        adm.try_admit()
    assert exc.value.tenant == "t0"
    assert isinstance(exc.value, ShedError)
    adm.release()
    adm.try_admit()
    assert adm.stats() == {"admitted": 3, "shed_queue": 1, "shed_rate": 0,
                           "depth": 2}


def test_token_bucket_sheds_and_refills_on_a_fake_clock():
    now = [0.0]
    adm = AdmissionController(rate_per_s=2.0, burst=2, clock=lambda: now[0])
    adm.try_admit(), adm.release()
    adm.try_admit(), adm.release()
    with pytest.raises(RateLimitError):
        adm.try_admit()
    now[0] = 0.5
    adm.try_admit()
    adm.release()
    with pytest.raises(RateLimitError):
        adm.try_admit()
    assert adm.stats()["shed_rate"] == 2


def test_frontend_sheds_past_configured_depth_with_typed_error():
    spec = StreamingSpec(max_queue_depth=1)
    fe = CohortFrontend([TenantSpec("vision", 48, 4, config=CFG,
                                    streaming=spec)], device="cpu")
    fe.update_embeddings("vision", np.arange(48),
                         np.ones((48, 4), np.float32))
    srv = fe.tenant("vision")
    entered, release = threading.Event(), threading.Event()
    orig = srv.engine.select_batched

    def slow(table, requests=1):
        entered.set()
        release.wait(timeout=TIMEOUT)
        return orig(table, requests=requests)

    srv.engine.select_batched = slow
    out = []
    worker = threading.Thread(
        target=lambda: out.append(fe.select_cohort("vision", 4)))
    worker.start()
    try:
        assert entered.wait(timeout=TIMEOUT)
        with pytest.raises(QueueFullError):
            fe.select_cohort("vision", 4)
    finally:
        release.set()
        join(worker)
    assert len(out) == 1
    assert fe.stats()["frontend"]["shed"] == 1
    close_frontend(fe)


# -- cross-tenant dedupe ------------------------------------------------------

def test_identical_fingerprint_tenants_ride_one_engine_solve():
    n, d = 64, 4
    fe = CohortFrontend(
        [TenantSpec(f"family-{i}", n, d, config=CFG, seed=i)
         for i in range(2)],
        streaming=StreamingSpec(), device="cpu")
    try:
        x = np.random.default_rng(7).normal(size=(n, d)).astype(np.float32)
        for name in fe.tenant_names:
            fe.update_embeddings(name, np.arange(n), x)
        assert wait_until(
            lambda: all(fe.tenant(t).stats()["warm_ahead"] >= 1
                        for t in fe.tenant_names))
        stats = [fe.tenant(t).stats() for t in fe.tenant_names]
        assert sum(s["engine"]["cold_starts"] for s in stats) == 1
        assert sum(s["engine"]["solves"] for s in stats) == 1
        assert sum(s["dedupe_hit"] for s in stats) == 1
        assert fe.stats()["frontend"]["dedupe_hit"] == 1
        for name in fe.tenant_names:
            fe.select_cohort(name, 8)
        assert all(fe.tenant(t).stats()["forced_inline"] == 0
                   for t in fe.tenant_names)
        # the adopted solve is the leader's own result
        a, b = (fe.tenant(t).engine.state.result for t in fe.tenant_names)
        assert a is b
    finally:
        close_frontend(fe)


def test_different_configs_do_not_share_solves():
    n, d = 64, 4
    fe = CohortFrontend(
        [TenantSpec("a", n, d, config=CohortConfig(num_clusters=3)),
         TenantSpec("b", n, d, config=CohortConfig(num_clusters=4))],
        streaming=StreamingSpec(), device="cpu")
    try:
        x = np.random.default_rng(7).normal(size=(n, d)).astype(np.float32)
        for name in fe.tenant_names:
            fe.update_embeddings(name, np.arange(n), x)
        assert wait_until(
            lambda: all(fe.tenant(t).stats()["warm_ahead"] >= 1
                        for t in fe.tenant_names))
        stats = [fe.tenant(t).stats() for t in fe.tenant_names]
        assert sum(s["engine"]["cold_starts"] for s in stats) == 2
        assert sum(s["dedupe_hit"] for s in stats) == 0
    finally:
        close_frontend(fe)


# -- shutdown -----------------------------------------------------------------

def test_frontend_close_drains_joins_and_rejects():
    n, d = 48, 4
    fe = CohortFrontend([TenantSpec("vision", n, d, config=CFG)],
                        streaming=StreamingSpec(), device="cpu")
    fe.update_embeddings("vision", np.arange(n), np.ones((n, d), np.float32))
    fe.select_cohort("vision", 4)
    close_frontend(fe)
    with pytest.raises(ServiceClosedError):
        fe.select_cohort("vision", 4)
    with pytest.raises(ServiceClosedError):
        fe.tenant("vision").select_cohort(4)
    fe.close(timeout=TIMEOUT)              # idempotent


def test_frontend_context_manager_closes():
    n, d = 48, 4
    with CohortFrontend([TenantSpec("vision", n, d, config=CFG)],
                        streaming=StreamingSpec(), device="cpu") as fe:
        fe.update_embeddings("vision", np.arange(n),
                             np.ones((n, d), np.float32))
        ids, _ = fe.select_cohort("vision", 4)
        assert len(ids) == 4
        solver = fe._solver
    assert not any(t.is_alive() for t in solver._threads)
    with pytest.raises(ServiceClosedError):
        fe.select_cohort("vision", 4)


def test_server_close_joins_its_own_solver_and_keeps_the_old_import():
    from repro_torch.launch import serve
    assert serve.ServiceClosedError is ServiceClosedError
    srv = mk_server()
    assert srv._own_solver
    close_server(srv)
    with pytest.raises(serve.ServiceClosedError):
        srv.select_cohort(4)
    assert srv._solver.submit("late", lambda: None) is False


# -- the background solver ----------------------------------------------------

def test_background_solver_coalesces_per_key_latest_wins():
    ran = []
    gate = threading.Event()
    solver = BackgroundSolver(workers=1)
    try:
        solver.submit("block", lambda: gate.wait(TIMEOUT))
        for i in range(5):
            solver.submit("t", lambda i=i: ran.append(i))
        gate.set()
        assert solver.drain(timeout=TIMEOUT)
        assert ran == [4]
        assert solver.stats["coalesced"] == 4
    finally:
        solver.close(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in solver._threads)
    assert solver.submit("t", lambda: None) is False


def test_background_solver_task_error_is_counted_not_fatal():
    solver = BackgroundSolver(workers=1)
    try:
        solver.submit("bad", lambda: 1 / 0)
        assert wait_until(lambda: solver.stats["errors"] == 1)
        assert "ZeroDivisionError" in solver.last_error
        ran = []
        solver.submit("ok", lambda: ran.append(1))
        assert solver.drain(timeout=TIMEOUT)
        assert ran == [1]
    finally:
        solver.close(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in solver._threads)


def test_solve_deduper_lead_wait_adopt_and_abort():
    dd = SolveDeduper(capacity=2)
    ticket, prep = dd.begin(b"fp1")
    assert ticket is not None and prep is None
    dd.complete(ticket, "solved-1")
    assert dd.begin(b"fp1") == (None, "solved-1")
    t2, _ = dd.begin(b"fp2")
    dd.abort(t2)
    t3, prep3 = dd.begin(b"fp2")
    assert t3 is not None and prep3 is None
    dd.complete(t3, "solved-2")
    assert dd.stats["leads"] == 3 and dd.stats["aborts"] == 1


# -- realism's churn feeding the streaming path -------------------------------

def test_churn_trace_drives_streaming_updates_while_selects_run():
    from repro_torch.fed import ClientTrace, TraceSpec

    n, d, selectors, each = 64, 4, 4, 25
    srv = CohortServer(n, d, seed=0, config=CFG,
                       streaming=StreamingSpec(max_queue_depth=2),
                       device="cpu")
    rng = np.random.default_rng(0)
    srv.update_embeddings(np.arange(n),
                          rng.normal(size=(n, d)).astype(np.float32))
    trace = ClientTrace(n, TraceSpec(p_join=0.5, p_leave=0.3), seed=9)
    stop = threading.Event()
    churn_updates = []

    def churner():
        r = 1
        fresh = np.random.default_rng(1)
        while not stop.is_set():
            joined, left = trace.churn_step(r)
            delta = np.concatenate([joined, left])
            if len(delta):
                rows = np.zeros((len(delta), d), np.float32)
                rows[: len(joined)] = fresh.normal(
                    size=(len(joined), d)).astype(np.float32)
                srv.update_embeddings(delta, rows)
                churn_updates.append(r)
            r += 1
            time.sleep(0.001)

    ok, sheds, errors = [], [], []
    versions = {i: [] for i in range(selectors)}

    def selector(i):
        try:
            for _ in range(each):
                try:
                    ids, _ = srv.select_cohort(6)
                    assert len(ids) == 6
                    versions[i].append(
                        srv.stats()["streaming"]["served_version"])
                    ok.append(i)
                except ShedError:
                    sheds.append(i)
        except Exception as exc:        # pragma: no cover - failure path
            errors.append(exc)

    writer = threading.Thread(target=churner)
    threads = [threading.Thread(target=selector, args=(i,))
               for i in range(selectors)]
    writer.start()
    try:
        for t in threads:
            t.start()
        for t in threads:
            join(t)
    finally:
        stop.set()
        join(writer)
        close_server(srv)
    assert errors == []
    assert len(ok) + len(sheds) == selectors * each
    st = srv.stats()
    assert st["batches"] == st["served_warm"] + st["forced_inline"]
    assert st["batches"] == len(ok)
    assert st["shed"] == len(sheds)
    assert len(churn_updates) > 0
    assert st["updates"] == 1 + len(churn_updates)
    assert st["table_version"] == 1 + len(churn_updates)
    assert st["streaming"]["solver"]["errors"] == 0
    for ix, seq in versions.items():
        assert all(a <= b for a, b in zip(seq, seq[1:])), f"selector {ix}"


# -- lock order ---------------------------------------------------------------

def instrument_kernel_locks(monkeypatch):
    """Swap the port's kernel locks (the ``use_pallas`` toggle, the
    loaded libraries, the launch counts) for the watchdog's, on fresh
    objects the test's end puts back."""
    from repro_torch.kernels import _build, _common, ops

    monkeypatch.setattr(ops, "_TOGGLE", ops._PallasToggle())
    monkeypatch.setattr(_build, "LIBRARY", _build._Library())
    monkeypatch.setattr(_common, "_COUNT_LOCK", _common._COUNT_LOCK)
    assert instrument(ops._TOGGLE) == ["_lock"]
    assert instrument(_build.LIBRARY) == ["_lock"]
    assert instrument(_common) == ["_COUNT_LOCK"]
    return ops._TOGGLE._lock, _build.LIBRARY._lock, _common._COUNT_LOCK


def launching_refs(monkeypatch):
    """Make each kernel's plain version do what its wrapper does around
    a launch on the card: load the libraries first, count the launch
    after (the outermost call only: the fused versions call the
    cross-affinity's).  The libraries are a stand-in: nothing builds."""
    from repro_torch.kernels import _build, _common, ref

    monkeypatch.setattr(_build.LIBRARY, "_kernels", object())
    depth = threading.local()
    for kernel in _common.LAUNCH_COUNTS:
        plain = getattr(ref, f"{kernel}_ref")

        def counted(*args, _plain=plain, _kernel=kernel, **kw):
            outer = not getattr(depth, "n", 0)
            depth.n = getattr(depth, "n", 0) + 1
            try:
                if outer:
                    _build.library()
                out = _plain(*args, **kw)
            finally:
                depth.n -= 1
            if outer:
                _common.launched(_kernel)
            return out

        monkeypatch.setattr(ref, f"{kernel}_ref", counted)


def _instrumented_herd(fe, n, d, rounds=4, threads=8, counted=()):
    """Every serving lock of ``fe`` under the watchdog; ``threads``
    threads select, observe, update and read the stats of the tenants in
    turn, those of ``counted`` under a (watchdogged) ``StepCounter``, so
    its lock is taken inside the serving locks at every op.  Returns the
    threads' errors and the counters."""
    from repro_torch.roofline.counting import StepCounter

    counters = {i: StepCounter(("cpu",)) for i in counted}
    for counter in counters.values():
        assert instrument(counter) == ["_lock"]
    assert instrument(fe) == ["_registry_lock"]
    assert instrument(fe._solver) == ["_queue_lock"]
    assert instrument(fe._deduper) == ["_dedupe_lock"]
    for name in fe.tenant_names:
        tenant = fe._tenants[name]
        assert instrument(tenant, prefix=f"{name}:") == ["lock"]
        assert sorted(instrument(tenant.server, prefix=f"{name}:")) == [
            "_publish_lock", "_select_lock", "_solve_lock",
            "_stats_lock", "_write_lock"]
        assert instrument(tenant.server.admission,
                          prefix=f"{name}:") == ["_admission_lock"]
    rng = np.random.default_rng(0)
    for name in fe.tenant_names:
        fe.update_embeddings(name, np.arange(n),
                             rng.normal(size=(n, d)).astype(np.float32))
    errors, done = [], []

    def hammer(i):
        name = fe.tenant_names[i % len(fe.tenant_names)]
        server = fe.tenant(name)
        local = np.random.default_rng(i)
        try:
            with counters.get(i) or contextlib.nullcontext():
                for _ in range(rounds):
                    ids, _ = fe.select_cohort(name, 6)
                    server.observe_round(0.5 + 0.01 * len(ids))
                    server.update_embeddings(ids, local.normal(
                        size=(len(ids), d)).astype(np.float32))
                    fe.stats()
            done.append(i)
        except Exception as exc:        # pragma: no cover - failure path
            errors.append(exc)

    workers = [threading.Thread(target=hammer, args=(i,), name=f"herd-{i}")
               for i in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in workers:
            t.start()
        for t in workers:
            join(t)
    finally:
        sys.setswitchinterval(interval)
    assert len(done) + len(errors) == threads
    return errors, counters


def test_watchdog_instrumented_streaming_herd_obeys_lock_order(monkeypatch):
    """Every lock of the port's streaming stack, and its kernel locks,
    swapped for the port's rank-asserting OrderedLock; selects, updates
    and observes race the background warms, with thread switches every
    10 µs."""
    instrument_kernel_locks(monkeypatch)
    n, d = 96, 8
    fast_dqn = {"hidden": (32,), "eps_decay_steps": 30,
                "buffer_size": 512, "batch_size": 64}
    fe = CohortFrontend(
        [TenantSpec(f"family-{i}", n, d, config=CFG, seed=i,
                    policy="dqn", dqn_overrides=fast_dqn)
         for i in range(2)],
        streaming=StreamingSpec(max_stale_versions=2), device="cpu")
    assert _instrumented_herd(fe, n, d)[0] == []
    assert fe._solver.stats["errors"] == 0, fe._solver.last_error
    close_frontend(fe)


def test_watchdog_herd_takes_the_kernel_locks_where_the_card_does(
        monkeypatch):
    """The herd on the fused path, each plain version loading the
    libraries and counting its launch as its wrapper does on the card:
    the kernel locks are taken inside the serving locks, from the
    callers' threads (inline solves) and the solver's (warms), two
    callers also count every op under a ``StepCounter`` (the innermost
    lock), and the declared ranks hold.  ``chip_smoke.py`` phase 17b runs this herd on
    the card at the path size."""
    from repro_torch.kernels import _common, ops

    toggle, library, counts = instrument_kernel_locks(monkeypatch)
    launching_refs(monkeypatch)
    config = CohortConfig(num_clusters=3, method="nystrom",
                          num_landmarks=32, use_pallas=True)
    n, d = 96, 8
    fe = CohortFrontend(
        [TenantSpec(f"family-{i}", n, d, config=config, seed=i,
                    policy="dqn", dqn_overrides={"hidden": (32,)})
         for i in range(2)],
        streaming=StreamingSpec(max_stale_versions=2), device="cpu")
    ops.reset_launch_counts()
    errors, counters = _instrumented_herd(fe, n, d, counted=(0, 1))
    assert errors == []
    assert fe._solver.stats["errors"] == 0, fe._solver.last_error
    close_frontend(fe)
    fused = ("quantized_cross_affinity", "nystrom_colsum", "nystrom_gram",
             "nystrom_extension")
    by_thread = {t: c for t, c in ops.THREAD_LAUNCHES.items()
                 if any(c[k] for k in fused)}
    solver = [t for t in by_thread if t.startswith("repro-solver")]
    callers = [t for t in by_thread if t.startswith("herd-")]
    assert solver and callers, by_thread
    for kernel in fused:
        assert sum(by_thread[t][kernel] for t in solver) > 0
        assert sum(by_thread[t][kernel] for t in callers) > 0
    assert isinstance(_common._COUNT_LOCK, OrderedLock)
    assert counts.acquisitions >= sum(_common.LAUNCH_COUNTS.values()) > 0
    assert library.acquisitions >= sum(_common.LAUNCH_COUNTS.values())
    assert toggle.acquisitions == 0      # the cohort path reads no toggle
    assert all(c._lock.acquisitions > 0 and c.flops[0] > 0
               for c in counters.values())


def test_launch_counts_are_split_by_thread():
    """The kernels' launch tally names the thread that launched, so a
    chip run can tell the solver's launches from the callers'."""
    from repro_torch.kernels import _common, ops

    ops.reset_launch_counts()
    try:
        worker = threading.Thread(
            target=lambda: [_common.launched("nystrom_gram")
                            for _ in range(2)], name="repro-solver-0")
        worker.start()
        join(worker)
        _common.launched("nystrom_colsum")
        main = threading.current_thread().name
        assert ops.LAUNCH_COUNTS["nystrom_gram"] == 2
        assert ops.THREAD_LAUNCHES["repro-solver-0"]["nystrom_gram"] == 2
        assert ops.THREAD_LAUNCHES["repro-solver-0"]["nystrom_colsum"] == 0
        assert ops.THREAD_LAUNCHES[main]["nystrom_colsum"] == 1
    finally:
        ops.reset_launch_counts()
    assert ops.THREAD_LAUNCHES == {}
    assert not any(ops.LAUNCH_COUNTS.values())
