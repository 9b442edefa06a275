"""The port's multi-tenant frontend (``repro_torch.launch.frontend``) on
the CPU: the cases of the JAX package's ``tests/test_frontend.py`` on the
port's stack (coalescing, tenant isolation, the rich and basic serving
states, lock order), plus each tenant's partition against a lone server
and the ``--tenants`` CLI.  Every join has a timeout, and a test fails
when it runs out.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.cohort import CohortConfig
from repro_torch.fed.metrics import cluster_policy_state, serving_state_dim
from repro_torch.launch import serve
from repro_torch.launch.frontend import (CohortFrontend, TenantSpec,
                                         make_demo_frontend)
from repro_torch.launch.serve import CohortServer
from repro_torch.policy import ClusterPolicy
from repro_torch.streaming import StreamingSpec

FAST_DQN = {"hidden": (32,), "eps_decay_steps": 30, "buffer_size": 512,
            "batch_size": 64}
TIMEOUT = 30.0


def join(thread):
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive(), f"{thread.name} did not finish"


def blob_table(n=120, k=3, d=8, sep=8.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * sep
    true = rng.integers(0, k, n)
    return (centers[true] + rng.normal(size=(n, d)).astype(np.float32)), true


def mk_frontend(tenants=2, n=120, k=3, d=8, policy="stratified", seed=0,
                window=0.0, config=None, streaming=None):
    fe = make_demo_frontend(tenants, n, d,
                            config=config or CohortConfig(num_clusters=k),
                            seed=seed, policy=policy, batch_window_s=window,
                            streaming=streaming, device="cpu")
    for i, name in enumerate(fe.tenant_names):
        x, _ = blob_table(n, k, d, seed=seed + i)
        fe.update_embeddings(name, np.arange(n), x)
    return fe


def same_partition(a, b):
    pairs = {(int(x), int(y)) for x, y in zip(a, b)}
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


# -- coalescing ---------------------------------------------------------------

def test_concurrent_selects_coalesce_to_one_solve_disjoint_cohorts():
    n, workers = 200, 16
    fe = mk_frontend(tenants=1, n=n, k=4, window=0.5)
    name = fe.tenant_names[0]
    server = fe.tenant(name)
    results = [None] * workers
    barrier = threading.Barrier(workers)

    def worker(i):
        barrier.wait(timeout=TIMEOUT)
        results[i] = fe.select_cohort(name, 8)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        join(t)
    assert all(r is not None for r in results)
    assert server.engine.stats["solves"] == 1
    assert server.engine.stats["cold_starts"] == 1
    st = fe.stats()
    assert st["frontend"]["requests"] == workers
    assert st["frontend"]["max_batch"] == workers
    assert st["frontend"]["batches"] == 1
    assert st["frontend"]["batch_factor"] == workers
    all_ids = np.concatenate([ids for ids, _ in results])
    assert len(all_ids) == workers * 8
    assert len(np.unique(all_ids)) == len(all_ids)
    assert len({id(res) for _, res in results}) == 1
    fe.close(timeout=TIMEOUT)


def test_batched_select_counters_and_dashboard_factor():
    fe = mk_frontend(tenants=1, n=90, k=3)
    server = fe.tenant(fe.tenant_names[0])
    out = server.select_cohorts([5, 5, 5])
    assert len(out) == 3
    assert server.engine.stats["batched_selects"] == 1
    assert server.engine.stats["coalesced_requests"] == 3
    assert server.stats()["requests"] == 3
    assert server.stats()["batches"] == 1
    ids = np.concatenate([i for i, _ in out])
    assert len(np.unique(ids)) == 15
    assert server.select_cohorts([]) == []


def test_new_table_version_does_not_coalesce_with_old_batch():
    fe = mk_frontend(tenants=1, n=90, k=3)
    name = fe.tenant_names[0]
    _, res1 = fe.select_cohort(name, 6)
    x, _ = blob_table(90, 3, 8, seed=99)
    fe.update_embeddings(name, np.arange(90), x)
    _, res2 = fe.select_cohort(name, 6)
    assert res2 is not res1
    assert fe.tenant(name).engine.stats["solves"] == 2


def test_frontend_select_error_fans_out_and_unknown_tenant():
    fe = mk_frontend(tenants=1, n=60, k=3)
    with pytest.raises(KeyError, match="unknown tenant"):
        fe.select_cohort("no-such-family", 4)
    name = fe.tenant_names[0]

    def boom(*a, **kw):
        raise RuntimeError("engine exploded")

    fe.tenant(name).select_cohorts = boom
    with pytest.raises(RuntimeError, match="coalesced select failed"):
        fe.select_cohort(name, 4)


# -- tenants ------------------------------------------------------------------

def test_tenants_are_isolated_seeds_policies_stats():
    fe = mk_frontend(tenants=2, n=120, k=3, policy="dqn", seed=0)
    a, b = fe.tenant_names
    assert fe.tenant(a) is not fe.tenant(b)
    assert fe.tenant(a).engine is not fe.tenant(b).engine
    assert fe.tenant(a).policy is not fe.tenant(b).policy
    assert fe.tenant(a).device == torch.device("cpu")
    v_b = fe.tenant(b).version
    fe.select_cohort(a, 10)
    fe.observe_round(a, 0.7)
    st = fe.stats()["tenants"]
    assert st[a]["requests"] == 1 and st[b]["requests"] == 0
    assert st[a]["rounds_observed"] == 1 and st[b]["rounds_observed"] == 0
    assert fe.tenant(b).version == v_b
    assert st[b]["policy"]["buffer_size"] == 0
    assert st[a]["policy"]["buffer_size"] > 0
    qa = fe.tenant(a).policy.agent.net.state_dict()
    qb = fe.tenant(b).policy.agent.net.state_dict()
    assert any(not torch.equal(qa[key], qb[key]) for key in qa)


def test_duplicate_tenant_rejected():
    fe = CohortFrontend(device="cpu")
    fe.add_tenant("fam", TenantSpec("fam", 40, 4,
                                    config=CohortConfig(num_clusters=2)))
    assert fe.tenant("fam").device == torch.device("cpu")
    with pytest.raises(ValueError, match="already registered"):
        fe.add_tenant("fam", CohortServer(40, 4, device="cpu"))


@pytest.mark.parametrize("streaming", [False, True])
def test_each_tenant_partitions_like_a_lone_server(streaming):
    """Four tenants, the first two given one table: each tenant's
    partition is the one a lone CohortServer with the seed of the solve
    it serves gives on the same table, up to relabelling.  With
    streaming the second tenant adopts the first's solve (the dedupe key
    is the table and the config), so it serves the first tenant's seed;
    without, every tenant solves with its own."""
    n, k, d = 300, 3, 8
    cfg = CohortConfig(num_clusters=k, method="nystrom", num_landmarks=48)
    fe = make_demo_frontend(4, n, d, config=cfg, seed=0,
                            streaming=StreamingSpec() if streaming else None,
                            device="cpu")
    tables = [blob_table(n, k, d, seed=max(i - 1, 0))[0] for i in range(4)]
    for name, table in zip(fe.tenant_names, tables):
        fe.update_embeddings(name, np.arange(n), table)
    if streaming:
        assert fe._solver.drain(timeout=TIMEOUT)
    for i, name in enumerate(fe.tenant_names):
        _, res = fe.select_cohort(name, 10)
        seed = 0 if streaming and i == 1 else i
        lone = CohortServer(n, d, seed=seed, config=cfg, device="cpu")
        lone.update_embeddings(np.arange(n), tables[i])
        _, want = lone.select_cohort(10)
        assert same_partition(res.assign, want.assign)
    per = fe.stats()["tenants"]
    st = fe.stats()["frontend"]
    if streaming:
        assert per[fe.tenant_names[1]]["dedupe_hit"] == 1
        assert st["dedupe_hit"] == 1 and st["solves"] == 3
        assert st["forced_inline"] == 0
        assert fe._solver.stats["errors"] == 0
    else:
        assert st["solves"] == 4 and st["dedupe_hit"] == 0
    fe.close(timeout=TIMEOUT)


# -- the serving states -------------------------------------------------------

def test_rich_state_round_trip_through_observe_round():
    n, k, d = 120, 3, 8
    x, _ = blob_table(n, k, d)
    srv = CohortServer(n, d, seed=0, policy="dqn",
                       config=CohortConfig(num_clusters=k),
                       dqn_overrides=FAST_DQN, device="cpu")
    srv.update_embeddings(np.arange(n), x)
    dim = serving_state_dim(k, "rich")
    assert srv.policy.state_dim == dim
    for _ in range(3):
        ids, res = srv.select_cohort(10)
        assert len(ids) == 10
        srv.observe_round(0.6)
    assert srv.policy.agent.buffer.s.shape[1] == dim
    assert srv.policy.agent.buffer.size > 0
    st = srv.stats()
    assert st["state_features"] == "rich"
    assert st["policy"]["state_dim"] == dim
    state = srv._policy_state(res.assign, srv.embeds)
    disp = state[3 * k: 4 * k]
    stale = state[4 * k: 5 * k]
    assert np.all((disp >= 0) & (disp < 1)) and disp.max() > 0
    assert np.all((stale >= 0) & (stale < 1))


def test_basic_state_features_backcompat():
    n, k, d = 90, 3, 8
    x, _ = blob_table(n, k, d)
    srv = CohortServer(n, d, seed=0, policy="dqn",
                       config=CohortConfig(num_clusters=k),
                       dqn_overrides=FAST_DQN, state_features="basic",
                       device="cpu")
    srv.update_embeddings(np.arange(n), x)
    assert srv.policy.state_dim == 3 * k + 1
    srv.select_cohort(8)
    srv.observe_round(0.6)
    assert srv.policy.agent.buffer.s.shape[1] == 3 * k + 1
    with pytest.raises(ValueError, match="unknown state features"):
        CohortServer(n, d, state_features="extra", device="cpu")


def test_staleness_ages_unserved_clusters():
    n, k, d = 120, 3, 8
    x, _ = blob_table(n, k, d)
    srv = CohortServer(n, d, seed=0, config=CohortConfig(num_clusters=k),
                       device="cpu")
    srv.update_embeddings(np.arange(n), x)
    srv.select_cohort(n)
    assert np.all(srv._staleness == 0.0)
    ids, res = srv.select_cohort(1)
    served = np.unique(res.assign[ids])
    assert np.all(srv._staleness[served] == 0.0)
    assert all(srv._staleness[c] == 1.0 for c in range(k)
               if c not in served)


def test_cluster_policy_state_validates_short_stats():
    assign = np.array([0, 1, 2, 0])
    with pytest.raises(ValueError, match="participation has length 2"):
        cluster_policy_state(assign, 3, np.zeros(2), np.zeros(3), 0.5,
                             features="basic")
    with pytest.raises(ValueError, match="embeds"):
        cluster_policy_state(assign, 3, np.zeros(3), np.zeros(3), 0.5)
    s = cluster_policy_state(assign, 3, np.zeros(5), np.zeros(5), 0.5,
                             features="basic")
    assert s.shape == (3 * 3 + 1,)


def test_cluster_policy_wrong_length_transition_clear_error():
    pol = ClusterPolicy(3, state_dim=16, seed=0, dqn_overrides=FAST_DQN,
                        state_features="rich", device="cpu")
    with pytest.raises(ValueError, match="ClusterPolicy.observe"):
        pol.observe(np.zeros(16, np.float32), [0], 1.0,
                    np.zeros(9, np.float32))


# -- lock order ---------------------------------------------------------------

def test_watchdog_instrumented_stack_obeys_declared_lock_order(monkeypatch):
    """The port's serving stack, its kernel locks included, under the
    port's rank-asserting locks, hammered by selector / updater /
    observer / stats threads; covers select_cohorts (holding
    _select_lock) calling back into the frontend's seal, which takes the
    tenant lock."""
    from repro_torch.analysis import instrument
    from repro_torch.kernels import _build, _common, ops

    monkeypatch.setattr(ops, "_TOGGLE", ops._PallasToggle())
    monkeypatch.setattr(_build, "LIBRARY", _build._Library())
    monkeypatch.setattr(_common, "_COUNT_LOCK", _common._COUNT_LOCK)
    assert instrument(ops._TOGGLE) == ["_lock"]
    assert instrument(_build.LIBRARY) == ["_lock"]
    assert instrument(_common) == ["_COUNT_LOCK"]
    fe = mk_frontend(tenants=2, n=120, k=3, policy="dqn")
    assert instrument(fe) == ["_registry_lock"]
    for name in fe.tenant_names:
        tenant = fe._tenants[name]
        assert instrument(tenant, prefix=f"{name}:") == ["lock"]
        assert sorted(instrument(tenant.server, prefix=f"{name}:")) == [
            "_publish_lock", "_select_lock", "_solve_lock",
            "_stats_lock", "_write_lock"]
    errors, done = [], []
    rng = np.random.default_rng(1)

    def hammer(i):
        name = fe.tenant_names[i % len(fe.tenant_names)]
        server = fe.tenant(name)
        try:
            for _ in range(4):
                ids, _ = fe.select_cohort(name, 6)
                server.observe_round(0.5 + 0.01 * len(ids),
                                     timings={"train": 0.01})
                server.update_embeddings(
                    ids, rng.normal(size=(len(ids), 8)).astype(np.float32))
                fe.stats()
            done.append(i)
        except Exception as exc:        # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        join(t)
    assert errors == []
    assert len(done) == 8


# -- the CLI ------------------------------------------------------------------

def test_tenants_cli_runs_on_the_cpu(capsys):
    serve.main(["--cohort", "2000", "--tenants", "4", "--streaming",
                "--policy", "dqn", "--device", "cpu", "--rounds", "3"])
    out = capsys.readouterr().out
    assert "round 2: 16 concurrent selects over 4 tenants" in out
    assert '"num_tenants": 4' in out and '"requests": 48' in out
