"""The port's client realism (``repro_torch.fed.realism``) against the JAX
package's, and its wiring into the round loop and the cohort server.

Traces and outcomes are numpy in both packages, drawn from
``SeedSequence([seed, stream, round])``, so they must agree bit for bit.
The round-level case pins the pooling noise as ``test_torch_rounds.py``
does; the server case carries the JAX Q-network over
(``dqn_params_from_jax``) and hands both servers the same partition.
Everything runs on the CPU (``device="cpu"``).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.cohort import CohortConfig as JaxCohortConfig
from repro.fed import FederatedRunner as JaxRunner
from repro.fed import RunnerConfig as JaxRunnerConfig
from repro.fed import realism as jax_realism
from repro.launch.serve import CohortServer as JaxServer
from repro_torch.cohort import CohortConfig
from repro_torch.convert import (cnn_params_from_jax, dqn_params_from_jax,
                                 embedder_from_jax)
from repro_torch.fed import (ClientTrace, RoundSpec, SimClock, TraceSpec,
                             blended_reward, filter_survivors)
from repro_torch.fed.metrics import favor_reward, serving_state_dim
from repro_torch.fed.rounds import FederatedRunner, RunnerConfig
from repro_torch.fed.server import fedavg_aggregate
from repro_torch.launch.serve import CohortServer
from test_torch_rounds import CONFIG as ROUNDS_CONFIG
from test_torch_rounds import decisive_noise, jax_noise

# the JAX package's chaos-suite configuration (tests/test_realism.py)
TINY = dict(dataset="mnist", num_clients=10, clients_per_round=4,
            sigma=0.5, local_steps=2, batch_size=8, train_size=512,
            eval_size=128, policy="fedavg", seed=0)
BENIGN = TraceSpec(availability="none", dropout_hazard=0.0, tiers=(1.0,),
                   latency_jitter=0.0)
CHAOS = TraceSpec(availability="diurnal", day_period_s=60.0,
                  tiers=(1.0, 6.0), base_latency_s=1.0, dropout_hazard=0.1,
                  p_join=0.3, p_leave=0.1)
SLOW_HALF = dict(tiers=(1.0, 40.0), latency_jitter=0.0)

# the traces held against the JAX package's
SPECS = {
    "chaos": CHAOS,
    "benign": BENIGN,
    "storm": TraceSpec(availability="diurnal", day_period_s=17.0,
                       avail_floor=0.2, avail_amplitude=0.7,
                       tiers=(1.0, 3.0, 9.0), latency_jitter=0.4,
                       dropout_hazard=0.6, p_join=0.5, p_leave=0.4),
    "assigned": TraceSpec(availability="diurnal",
                          phase_assign=tuple(np.linspace(0, 1, 40,
                                                         endpoint=False)),
                          tiers=(1.0, 5.0),
                          tier_assign=tuple([0, 1] * 20),
                          hazard_assign=tuple(np.arange(40) / 20.0),
                          dropout_hazard=0.3, p_leave=0.2, p_join=0.1),
}


def jax_spec(spec):
    return jax_realism.TraceSpec(**dataclasses.asdict(spec))


def jax_round_spec(spec):
    return jax_realism.RoundSpec(**dataclasses.asdict(spec))


def assert_same_outcome(got, want):
    for field in ("selected", "completed", "dropped", "straggler_ids",
                  "latencies_s"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.elapsed_s == want.elapsed_s
    assert got.reasons == want.reasons
    assert got.round_idx == want.round_idx
    assert got.deadline_s == want.deadline_s
    assert got.attainment == want.attainment


# -- the traces against the JAX package's ------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("seed", [0, 7])
def test_trace_is_bit_identical_to_jax(name, seed):
    spec = SPECS[name]
    n = 40
    port = ClientTrace(n, spec, seed=seed)
    ref = jax_realism.ClientTrace(n, jax_spec(spec), seed=seed)
    np.testing.assert_array_equal(port.phase, ref.phase)
    np.testing.assert_array_equal(port.stretch, ref.stretch)
    rng = np.random.default_rng(seed)
    for spec_r in (RoundSpec(), RoundSpec(deadline_s=2.5),
                   RoundSpec(deadline_s=4.0, straggler_mult=1.5)):
        for r in range(4):
            t = float(r * 13.7)
            np.testing.assert_array_equal(port.availability(t),
                                          ref.availability(t))
            np.testing.assert_array_equal(port.membership(r),
                                          ref.membership(r))
            for a, b in zip(port.churn_step(r), ref.churn_step(r)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(port.latencies(r),
                                          ref.latencies(r))
            sel = rng.choice(n, size=12, replace=False)
            assert_same_outcome(
                port.simulate_round(r, t, sel, spec_r),
                ref.simulate_round(r, t, sel, jax_round_spec(spec_r)))


def test_blended_reward_matches_jax():
    for acc, att, blend in [(0.7, 0.5, 0.0), (0.85, 1.0, 0.5),
                            (0.3, 0.0, 1.0), (0.91, 0.25, 0.3)]:
        assert blended_reward(acc, 0.85, att, blend=blend) == \
            jax_realism.blended_reward(acc, 0.85, att, blend=blend)


# -- aggregation safety -------------------------------------------------------

def test_filter_survivors_matches_jax():
    k = 6
    rng = np.random.default_rng(1)
    stacked = {"w": rng.normal(size=(k, 3, 2)).astype(np.float32),
               "b": rng.normal(size=(k, 4)).astype(np.float32)}
    weights = rng.random(k).astype(np.float32) + 0.5
    mask = np.array([True, False, True, True, False, True])
    want_p, want_w = jax_realism.filter_survivors(stacked, weights, mask)
    port = {name: torch.from_numpy(v) for name, v in stacked.items()}
    got_p, got_w = filter_survivors(port, weights, mask)
    assert set(got_p) == set(want_p)
    for name in got_p:
        assert isinstance(got_p[name], torch.Tensor)
        np.testing.assert_array_equal(got_p[name].numpy(),
                                      np.asarray(want_p[name]))
    np.testing.assert_array_equal(got_w, want_w)


def test_dropped_clients_cannot_poison_aggregation():
    """A dropout's partial work, even NaN, contributes nothing: the port's
    FedAvg over the survivors is finite and the survivors-only mean."""
    k, shape = 5, (3, 2)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(k, *shape)).astype(np.float32)
    weights = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    mask = np.array([True, False, True, False, True])
    w[~mask] = np.nan                      # poisoned partial updates
    stacked = {"w": torch.from_numpy(w)}
    fp, fw = filter_survivors(stacked, weights, mask)
    assert fp["w"].shape == (3, *shape) and len(fw) == 3
    agg = fedavg_aggregate(fp, fw)["w"].numpy()
    assert np.isfinite(agg).all()
    expect = np.average(w[mask], axis=0, weights=weights[mask])
    np.testing.assert_allclose(agg, expect, rtol=1e-6)
    same_p, same_w = filter_survivors(stacked, weights, np.ones(k, bool))
    assert same_p is stacked and same_w is weights
    with pytest.raises(ValueError, match="no survivors"):
        filter_survivors(stacked, weights, np.zeros(k, bool))


# -- the round loop -----------------------------------------------------------

@pytest.fixture
def decisive_pooling(monkeypatch):
    """The JAX pool draws ``decisive_noise`` for the test's duration."""
    monkeypatch.setattr(jax.random, "gumbel", decisive_noise)


def test_chaos_round_matches_jax(decisive_pooling):
    """Two rounds under a chaos trace in both packages: the same clients
    complete, drop and straggle, the same simulated seconds pass, and
    the survivors' training gives the same accuracy."""
    # lr nudged (one part in 2^19) so the JAX jit cache keys this file's
    # decisive-noise trace apart from every other test's
    kw = dict(ROUNDS_CONFIG, policy="fedavg", sigma=0.5,
              lr=0.05 * (1 + 2.0 ** -19))
    ref = JaxRunner(JaxRunnerConfig(**kw))
    port = FederatedRunner(RunnerConfig(**kw), device="cpu")
    port.global_params = cnn_params_from_jax(ref.global_params)
    port.embedder = embedder_from_jax(np.asarray(ref.embedder.proj),
                                      device="cpu")
    port._pool_noise = jax_noise(port)
    n = kw["num_clients"]
    spec = RoundSpec(deadline_s=3.0, reward_blend=0.5)
    ref.attach_trace(jax_realism.ClientTrace(n, jax_spec(CHAOS), seed=3),
                     jax_round_spec(spec))
    port.attach_trace(ClientTrace(n, CHAOS, seed=3), spec)
    dropped = 0
    for _ in range(2):
        want, got = ref.run_round(), port.run_round()
        np.testing.assert_array_equal(got.selected, want.selected)
        assert got.num_completed == want.num_completed
        assert got.num_dropped == want.num_dropped
        assert got.num_stragglers == want.num_stragglers
        assert got.sim_seconds == want.sim_seconds
        assert got.num_completed + got.num_dropped == len(got.selected)
        assert got.sim_seconds == got.outcome.elapsed_s
        assert got.timings == want.timings       # both on the SimClock
        assert abs(got.accuracy - want.accuracy) <= 1.0 / kw["eval_size"]
        np.testing.assert_allclose(got.loss, want.loss, rtol=1e-4)
        assert got.reward == pytest.approx(want.reward, rel=1e-3, abs=1e-3)
        dropped += got.num_dropped
    assert dropped > 0                            # the chaos bites
    assert port.sim_clock.now() == ref.sim_clock.now()


def test_golden_regression_benign_trace_matches_ideal_runner():
    """No deadline and no failure mode: the realism path reproduces the
    port's ideal simulation bit for bit."""
    ideal = FederatedRunner(RunnerConfig(**TINY), device="cpu")
    real = FederatedRunner(RunnerConfig(**TINY, realism=BENIGN),
                           device="cpu")
    h1, h2 = ideal.run(2), real.run(2)
    for a, b in zip(h1, h2):
        assert a.accuracy == b.accuracy and a.loss == b.loss
        assert a.reward == b.reward
        np.testing.assert_array_equal(a.selected, b.selected)
        assert b.num_completed == len(b.selected) and b.num_dropped == 0
        assert b.sim_seconds == pytest.approx(BENIGN.base_latency_s)
        assert b.outcome is not None and b.outcome.elapsed_s > 0
    assert real.sim_clock.now() == pytest.approx(2 * BENIGN.base_latency_s)
    assert real.sim_seconds_to_accuracy(0.0) == pytest.approx(
        BENIGN.base_latency_s)
    assert real.sim_seconds_to_accuracy(2.0) is None


def test_runner_replay_bit_identical_under_chaos():
    cfg = RunnerConfig(**TINY, realism=CHAOS,
                       round_spec=RoundSpec(deadline_s=3.0,
                                            reward_blend=0.5))
    h1 = FederatedRunner(cfg, device="cpu").run(3)
    h2 = FederatedRunner(cfg, device="cpu").run(3)
    assert any(r.num_dropped for r in h1)
    for a, b in zip(h1, h2):
        assert a.accuracy == b.accuracy and a.reward == b.reward
        np.testing.assert_array_equal(a.outcome.completed,
                                      b.outcome.completed)
        assert (a.num_completed, a.num_dropped, a.num_stragglers,
                a.sim_seconds) == (b.num_completed, b.num_dropped,
                                   b.num_stragglers, b.sim_seconds)
        assert a.timings == b.timings
        assert a.seconds == pytest.approx(sum(a.timings.values()))


def test_all_dropped_round_keeps_the_global_model():
    cfg = RunnerConfig(**TINY)
    runner = FederatedRunner(cfg, device="cpu")
    # nobody is ever available: every round drops the whole cohort
    runner.attach_trace(ClientTrace(
        TINY["num_clients"], TraceSpec(availability="diurnal",
                                       avail_floor=0.0,
                                       avail_amplitude=0.0), seed=0))
    runner.warmup()
    before = {k: v.clone() for k, v in runner.global_params.items()}
    res = runner.run_round()
    assert res.num_completed == 0
    assert res.num_dropped == len(res.selected) == TINY["clients_per_round"]
    assert res.outcome.reasons["unavailable"] == res.num_dropped
    assert res.sim_seconds == 0.0
    for k, v in runner.global_params.items():
        assert torch.equal(v, before[k])


def test_attach_trace_guards():
    runner = FederatedRunner(RunnerConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="clients"):
        runner.attach_trace(ClientTrace(99, BENIGN, seed=0))
    runner.run(1)
    with pytest.raises(RuntimeError, match="already ran"):
        runner.attach_trace(ClientTrace(TINY["num_clients"], BENIGN, seed=0))


# -- the trace's own guards (tests/test_realism.py's cases) -------------------

def test_sim_clock_monotone_and_injectable():
    clk = SimClock()
    assert clk.now() == 0.0 and clk() == 0.0
    assert clk.advance(2.5) == 2.5
    assert clk.advance(0.0) == 2.5
    with pytest.raises(ValueError):
        clk.advance(-1.0)


def test_availability_always_a_probability():
    spec = TraceSpec(availability="diurnal", avail_floor=0.5,
                     avail_amplitude=3.0)
    trace = ClientTrace(32, spec, seed=1)
    for t in (0.0, 17.3, 120.0, 1e6):
        a = trace.availability(t)
        assert a.shape == (32,)
        assert np.all(a >= 0.0) and np.all(a <= 1.0)
    assert np.all(ClientTrace(8, BENIGN, seed=0).availability(5.0) == 1.0)


def test_deadline_drops_slow_tier_and_server_waits_full_deadline():
    spec = TraceSpec(tiers=(1.0, 50.0), tier_assign=(0,) * 5 + (1,) * 3,
                     base_latency_s=1.0, latency_jitter=0.0)
    trace = ClientTrace(8, spec, seed=0)
    out = trace.simulate_round(0, 0.0, np.arange(8), RoundSpec(deadline_s=5.0))
    np.testing.assert_array_equal(out.completed, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(out.dropped, [5, 6, 7])
    assert out.reasons == {"unavailable": 0, "deadline": 3, "dropout": 0}
    assert out.elapsed_s == pytest.approx(5.0)
    out2 = trace.simulate_round(0, 0.0, np.arange(8), RoundSpec())
    assert len(out2.completed) == 8 and out2.elapsed_s == pytest.approx(50.0)
    np.testing.assert_array_equal(out2.straggler_ids, [5, 6, 7])


def test_outcomes_independent_of_selection_order():
    trace = ClientTrace(32, CHAOS, seed=11)
    spec = RoundSpec(deadline_s=4.0)
    a = trace.simulate_round(1, 10.0, np.array([3, 9, 21, 30]), spec)
    b = trace.simulate_round(1, 10.0, np.array([30, 21, 9, 3]), spec)
    assert set(a.completed.tolist()) == set(b.completed.tolist())
    assert set(a.dropped.tolist()) == set(b.dropped.tolist())


def test_trace_validation_errors():
    with pytest.raises(ValueError, match="num_clients"):
        ClientTrace(0)
    with pytest.raises(ValueError, match="availability"):
        ClientTrace(4, TraceSpec(availability="weekly"))
    with pytest.raises(ValueError, match="tiers"):
        ClientTrace(4, TraceSpec(tiers=(1.0, -2.0)))
    with pytest.raises(ValueError, match="tier_assign"):
        ClientTrace(4, TraceSpec(tiers=(1.0,), tier_assign=(0, 0, 1, 0)))
    with pytest.raises(ValueError, match="one entry per"):
        ClientTrace(4, TraceSpec(phase_assign=(0.1, 0.2)))
    with pytest.raises(ValueError):
        ClientTrace(4).membership(-1)
    with pytest.raises(ValueError, match="blend"):
        blended_reward(0.5, 0.85, 1.0, blend=1.5)


# -- the server's "system" state ----------------------------------------------

def _blob_table(n, k, d, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(n // k, d)) + 8.0 * c
                        for c in range(k)]).astype(np.float32)
    return x, np.repeat(np.arange(k), n // k)


def _pin_partition(server, assign, k):
    """Every select of ``server`` draws from ``assign``."""
    res = types.SimpleNamespace(assign=assign, k=k)
    server.engine.select_batched = lambda table, requests=1: res


def test_system_observe_round_matches_jax():
    """observe_round(outcome=...) under state_features="system": with the
    JAX Q-network carried over and the same partition, both servers draw
    the same cohorts, get the same blended reward and build the same
    7k+1 state."""
    n, d, k = 60, 6, 3
    x, labels = _blob_table(n, k, d)
    dqn = {"hidden": (16,), "buffer_size": 64, "batch_size": 8}
    ref = JaxServer(n, d, seed=0, policy="dqn",
                    config=JaxCohortConfig(num_clusters=k),
                    state_features="system", dqn_overrides=dqn)
    port = CohortServer(n, d, seed=0, policy="dqn",
                        config=CohortConfig(num_clusters=k),
                        state_features="system", dqn_overrides=dqn,
                        device="cpu")
    agent, jax_agent = port.policy.agent, ref.policy.agent
    agent.net.load_state_dict(dqn_params_from_jax(jax_agent.params))
    agent.target.load_state_dict(dqn_params_from_jax(
        jax_agent.target_params))
    for server in (ref, port):
        server.update_embeddings(np.arange(n), x)
        _pin_partition(server, labels, k)
    trace = ClientTrace(n, TraceSpec(
        tier_assign=tuple([0] * (n // 2) + [1] * (n // 2)), **SLOW_HALF),
        seed=0)
    spec = RoundSpec(deadline_s=5.0)
    for r in range(3):
        ids_ref, _ = ref.select_cohort(8)
        ids, _ = port.select_cohort(8)
        np.testing.assert_array_equal(ids, ids_ref)
        out = trace.simulate_round(r, 0.0, ids, spec)
        want = ref.observe_round(0.5 + 0.1 * r, outcome=out)
        got = port.observe_round(0.5 + 0.1 * r, outcome=out)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
        np.testing.assert_allclose(port._avail_ema, ref._avail_ema,
                                   rtol=1e-6)
        np.testing.assert_allclose(port._latency_ema_s, ref._latency_ema_s,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            port._policy_state(labels, port.embeds),
            ref._policy_state(labels, ref.embeds), rtol=1e-5, atol=1e-5)
    assert len(port._policy_state(labels, port.embeds)) == 7 * k + 1


def test_system_state_round_trips_through_observe_round():
    n, d, k = 60, 6, 3
    x, _ = _blob_table(n, k, d)
    srv = CohortServer(n, d, seed=0, policy="dqn",
                       config=CohortConfig(num_clusters=k),
                       state_features="system", device="cpu",
                       dqn_overrides={"hidden": (16,), "buffer_size": 64,
                                      "batch_size": 8})
    assert srv.policy.agent.cfg.state_dim == serving_state_dim(k, "system")
    srv.update_embeddings(np.arange(n), x)
    trace = ClientTrace(n, TraceSpec(
        tier_assign=tuple([0] * (n // 2) + [1] * (n // 2)), **SLOW_HALF),
        seed=0)
    spec = RoundSpec(deadline_s=5.0)
    avail0 = srv._avail_ema.copy()
    for r in range(3):
        ids, _ = srv.select_cohort(8)
        out = trace.simulate_round(r, 0.0, ids, spec)
        reward = srv.observe_round(0.5, timings={"train": 0.1}, outcome=out)
        assert reward == pytest.approx(
            blended_reward(0.5, srv.target_accuracy, out.attainment))
    assert (srv._avail_ema <= avail0 + 1e-12).all()
    assert (srv._avail_ema < avail0).any()
    assert (srv._latency_ema_s > 0).any()
    assert srv.stats()["rounds_observed"] == 3
    assert srv.stats()["state_features"] == "system"
    ids, _ = srv.select_cohort(8)
    assert srv.observe_round(0.6) == pytest.approx(
        favor_reward(0.6, srv.target_accuracy))


def test_churn_delta_feeds_update_embeddings():
    n, d = 20, 4
    srv = CohortServer(n, d, seed=0, config=CohortConfig(num_clusters=2),
                       device="cpu")
    srv.update_embeddings(np.arange(n), np.ones((n, d), np.float32))
    trace = ClientTrace(n, TraceSpec(p_join=0.5, p_leave=0.4), seed=5)
    v = srv.version
    for r in range(1, 6):
        joined, left = trace.churn_step(r)
        delta = np.concatenate([joined, left])
        if not len(delta):
            continue
        rows = np.zeros((len(delta), d), np.float32)
        rows[: len(joined)] = float(r)
        srv.update_embeddings(delta, rows)
        assert srv.version == v + 1
        v = srv.version
        table = srv.embeds
        if len(left):
            np.testing.assert_array_equal(table[left], 0.0)
        if len(joined):
            np.testing.assert_array_equal(table[joined], float(r))
