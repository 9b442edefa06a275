"""The port's Algorithm II and cohort server against the JAX package.

The Q-network's weights are carried over from the JAX package with
``dqn_params_from_jax``, and both sides draw from numpy generators with
the same seed, so Q-values, the TD loss and its gradients, one SGD step
and the cohort draws can be compared directly.  The server runs on the
CPU here (``device="cpu"``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.cohort import CohortConfig as JaxConfig
from repro.core import dqn as jax_dqn
from repro.core.selection import favor_reward as jax_favor_reward
from repro.fed import metrics as jax_metrics
from repro.launch.serve import CohortServer as JaxServer
from repro.policy import ClusterPolicy as JaxPolicy
from repro.streaming import StreamingSpec as JaxStreamingSpec
from repro_torch.cohort import CohortConfig
from repro_torch.convert import dqn_params_from_jax
from repro_torch.core.dqn import DQNAgent, DQNConfig, QNet, td_loss
from repro_torch.fed import metrics
from repro_torch.launch import serve
from repro_torch.fed.realism import (ClientTrace, RoundSpec, TraceSpec,
                                     blended_reward)
from repro_torch.launch.serve import CohortServer
from repro_torch.policy import ClusterPolicy
from repro_torch.streaming import StreamingSpec

KEY = jax.random.PRNGKey(0)


def _np_params(params):
    return [{name: np.asarray(v) for name, v in layer.items()}
            for layer in params]


def _load(agent, jax_agent):
    """Give a port DQNAgent the JAX agent's current and target weights."""
    agent.net.load_state_dict(dqn_params_from_jax(_np_params(
        jax_agent.params)))
    agent.target.load_state_dict(dqn_params_from_jax(_np_params(
        jax_agent.target_params)))


def _batch(rng, n, state_dim, num_actions):
    return {"s": rng.normal(size=(n, state_dim)).astype(np.float32),
            "a": rng.integers(0, num_actions, n).astype(np.int32),
            "r": rng.normal(size=(n,)).astype(np.float32),
            "s2": rng.normal(size=(n, state_dim)).astype(np.float32),
            "done": (rng.random(n) < 0.2).astype(np.float32)}


def _assert_params_close(agent, jax_params, atol=1e-5):
    for i, layer in enumerate(jax_params):
        lin = agent.net.layers[i]
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(layer["w"]).T, atol=atol)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(layer["b"]), atol=atol)


# -- the Q-network --------------------------------------------------------------

@pytest.mark.parametrize("double_dqn", [True, False])
def test_qnet_values_loss_and_grads_match_jax(double_dqn):
    cfg = DQNConfig(state_dim=9, num_actions=4, hidden=(16, 16),
                    double_dqn=double_dqn)
    jax_agent = jax_dqn.DQNAgent(KEY, cfg)
    agent = DQNAgent(cfg, device="cpu")
    _load(agent, jax_agent)
    batch = _batch(np.random.default_rng(0), 32, 9, 4)

    np.testing.assert_allclose(
        agent.net(torch.from_numpy(batch["s"])).detach().numpy(),
        np.asarray(jax_dqn.qnet_apply(jax_agent.params, batch["s"])),
        atol=1e-5)
    want_loss, want_grads = jax_dqn._td_grad(
        jax_agent.params, jax_agent.target_params, batch, cfg.gamma,
        double_dqn)
    loss = td_loss(agent.net, agent.target, agent.batch_tensors(batch),
                   cfg.gamma, double_dqn)
    loss.backward()
    np.testing.assert_allclose(loss.detach().item(), float(want_loss),
                               rtol=1e-5, atol=1e-5)
    for lin, g in zip(agent.net.layers, want_grads):
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   np.asarray(g["w"]).T, atol=1e-5)
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   np.asarray(g["b"]), atol=1e-5)


def test_train_steps_match_jax_under_a_shared_rng():
    """SGD with momentum 0.9: the first steps leave the same weights."""
    cfg = DQNConfig(state_dim=7, num_actions=3, hidden=(16,), batch_size=16)
    jax_agent = jax_dqn.DQNAgent(KEY, cfg)
    agent = DQNAgent(cfg, device="cpu")
    _load(agent, jax_agent)
    data = np.random.default_rng(1)
    for _ in range(40):
        s, s2 = data.normal(size=7), data.normal(size=7)
        a, r = int(data.integers(3)), float(data.normal())
        jax_agent.observe(s, a, r, s2)
        agent.observe(s, a, r, s2)
    rng_jax, rng_port = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(3):
        want = jax_agent.train_step(rng_jax)
        got = agent.train_step(rng_port)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-6)
    _assert_params_close(agent, jax_agent.params)
    assert agent.last_loss == pytest.approx(jax_agent.last_loss, rel=1e-5)


def test_qnet_init_scale_and_zero_bias():
    cfg = DQNConfig(state_dim=64, num_actions=4, hidden=(256,))
    net = QNet(cfg, generator=torch.Generator().manual_seed(0))
    w = net.layers[0].weight.detach()
    assert w.std().item() == pytest.approx(1 / 8, rel=0.05)
    assert net.layers[0].bias.abs().max().item() == 0.0


# -- Algorithm II ---------------------------------------------------------------

def test_cluster_policy_draws_match_jax_under_a_shared_rng():
    k, state_dim = 4, 13
    overrides = {"hidden": (16,), "eps_start": 0.3, "eps_decay_steps": 4}
    jax_policy = JaxPolicy(k, state_dim, seed=0, dqn_overrides=overrides)
    policy = ClusterPolicy(k, state_dim, seed=0, dqn_overrides=overrides,
                           device="cpu")
    _load(policy.agent, jax_policy.agent)
    data = np.random.default_rng(3)
    assign = data.integers(0, k, 200)
    rng_jax, rng_port = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(5):
        state = data.normal(size=state_dim).astype(np.float32)
        pools_jax = {c: list(np.flatnonzero(assign == c)) for c in range(k)}
        pools = {c: list(np.flatnonzero(assign == c)) for c in range(k)}
        want = jax_policy.draw(rng_jax, state, pools_jax, 24)
        got = policy.draw(rng_port, state, pools, 24)
        assert [int(i) for i in got[0]] == [int(i) for i in want[0]]
        assert got[1] == want[1]
        np.testing.assert_allclose(policy.draw_weights(state),
                                   jax_policy.draw_weights(state))
    assert set(policy.stats()) == set(jax_policy.stats())


def test_cluster_policy_rejects_a_wrong_state_length():
    policy = ClusterPolicy(3, 10, device="cpu", state_features="rich")
    with pytest.raises(ValueError, match="state_dim=10"):
        policy.draw_weights(np.zeros(7, np.float32))


# -- serving state -----------------------------------------------------------------

@pytest.mark.parametrize("features", ["basic", "rich", "system"])
def test_serving_state_matches_jax(features):
    rng = np.random.default_rng(5)
    k, n = 5, 300
    assign = rng.integers(0, k - 1, n)             # cluster k-1 stays empty
    kw = dict(embeds=rng.normal(size=(n, 6)).astype(np.float32),
              staleness=rng.integers(0, 4, k).astype(np.float64),
              availability=rng.random(k), latency_s=rng.random(k) * 3,
              features=features)
    args = (assign, k, rng.integers(0, 9, k).astype(np.float64),
            rng.normal(size=k).astype(np.float32), 0.61)
    got = metrics.cluster_policy_state(*args, **kw)
    np.testing.assert_array_equal(
        got, jax_metrics.cluster_policy_state(*args, **kw))
    assert len(got) == metrics.serving_state_dim(k, features)
    assert metrics.favor_reward(0.7, 0.85) == jax_favor_reward(0.7, 0.85)


# -- the server ----------------------------------------------------------------------

def _blob_table(n=600, k=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 6
    labels = rng.integers(0, k, n)
    return centers[labels] + rng.normal(size=(n, d)).astype(np.float32)


def _config(**kw):
    return dict(num_clusters=4, method="nystrom", use_pallas=True,
                num_landmarks=64, **kw)


def test_server_runs_dqn_rounds_with_the_jax_stats_keys():
    n, d = 600, 8
    x = _blob_table(n)
    server = CohortServer(n, d, policy="dqn", seed=0, device="cpu",
                          config=CohortConfig(**_config()))
    server.update_embeddings(np.arange(n), x)
    rng = np.random.default_rng(0)
    sources = []
    for _ in range(3):
        ids, res = server.select_cohort(32)
        assert len(ids) == len(set(ids.tolist())) == 32
        sources.append(res.source)
        server.observe_round(0.6, timings={"train_s": 1.0})
        server.update_embeddings(ids, server.embeds[ids] + 0.01 * rng.normal(
            size=(len(ids), d)).astype(np.float32))
    assert sources == ["cold", "warm", "warm"]
    stats = server.stats()
    reference = JaxServer(n, d, policy="dqn", seed=0,
                          config=JaxConfig(**_config())).stats()
    assert set(stats) == set(reference)
    assert set(stats["policy"]) == set(reference["policy"])
    assert set(stats["streaming"]) == set(reference["streaming"])
    assert stats["requests"] == stats["rounds_observed"] == 3
    assert stats["policy"]["train_calls"] == 3
    assert stats["engine"]["cold_starts"] == 1
    assert stats["round_timings_s"] == {"train_s": 1.0}


def test_stratified_batch_draws_disjoint_cohorts():
    n, d = 600, 8
    server = CohortServer(n, d, seed=1, device="cpu",
                          config=CohortConfig(**_config()))
    server.update_embeddings(np.arange(n), _blob_table(n))
    cohorts = server.select_cohorts([20, 20, 20])
    flat = np.concatenate([ids for ids, _ in cohorts])
    assert len(flat) == len(set(flat.tolist())) == 60
    assert cohorts[0][1] is cohorts[2][1]          # one shared solve
    assert server.stats()["batches"] == 1
    server.close()
    with pytest.raises(serve.ServiceClosedError):
        server.select_cohort(5)


@pytest.mark.parametrize("kwargs", [dict(streaming=StreamingSpec()),
                                    dict(state_features="system")])
def test_unported_server_features_raise(kwargs):
    """Streaming and the "system" state raised NotImplementedError until
    they were ported; now they build, with the JAX server's stats keys,
    and a malformed value of either still raises."""
    server = CohortServer(10, 2, policy="dqn", device="cpu", **kwargs)
    jax_kwargs = dict(kwargs)
    if "streaming" in kwargs:
        jax_kwargs["streaming"] = JaxStreamingSpec()
    reference = JaxServer(10, 2, policy="dqn", **jax_kwargs)
    try:
        stats = server.stats()
        assert set(stats) == set(reference.stats())
        assert set(stats["streaming"]) == set(reference.stats()["streaming"])
        assert stats["streaming"]["enabled"] == ("streaming" in kwargs)
        assert server.policy.state_dim == metrics.serving_state_dim(
            server.config.num_clusters, kwargs.get("state_features", "rich"))
    finally:
        server.close(timeout=30)
        reference.close(timeout=30)
    with pytest.raises(ValueError):
        if "streaming" in kwargs:
            StreamingSpec(max_stale_versions=-1)
        else:
            CohortServer(10, 2, device="cpu", state_features="systems")


def test_observe_round_outcome_is_not_ported_yet():
    """observe_round(outcome=...) raised NotImplementedError until client
    realism was ported; now it blends deadline attainment into the
    reward, as the JAX server does."""
    server = CohortServer(10, 2, device="cpu")
    outcome = ClientTrace(10, TraceSpec(), seed=0).simulate_round(
        0, 0.0, np.arange(4), RoundSpec())
    outcome.completed = outcome.completed[:2]      # half the cohort made it
    want = JaxServer(10, 2).observe_round(0.5, outcome=outcome)
    assert server.observe_round(0.5, outcome=outcome) == pytest.approx(
        want, rel=1e-12)
    assert want == pytest.approx(blended_reward(0.5, 0.85, 0.5))


def test_server_without_a_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CohortServer(10, 2, policy="dqn")


def test_cohort_cli_runs_on_the_cpu(capsys):
    serve.main(["--cohort", "2100", "--rounds", "2", "--cohort-size", "16",
                "--num-clusters", "4", "--num-landmarks", "64",
                "--policy", "dqn", "--use-pallas", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round 1: 16 clients" in out and "server stats:" in out
