"""One whole federated round in both packages, at the integration test's
configuration (12 clients, 4 a round, ``embed_dim`` 4).

The port's runner is given the JAX runner's parameters and projection
(``repro_torch.convert``), and both runners draw the same pooling noise
from the JAX keys: ``PRNGKey(seed·100003 + round)`` split per client,
then ``split`` per local step (round 0's keys for every warm-up chunk,
the JAX quirk the port keeps).  Everything else the round draws is numpy
in both packages, so under ``policy="fedavg"`` the cohort, the batches
and the embeddings must agree.

The noise is *decisive*: each pooling window gets 64 on one random entry
and 0 on the others, so the winner never depends on the probabilities
(log p lies in [-20.7, 0]).  With Gumbel noise the scores
log p + g of two window entries fall within one f32 ulp of each other
in a few of the ~5·10⁶ pooling decisions of a round; XLA and PyTorch
round the convolutions differently, so such a decision can flip, and one
flip moves a client's embedding by ~1e-4.  The Gumbel path itself is
held to JAX on single steps in ``test_torch_fed.py``.

Under ``policy="dqre_sc"`` the cluster labels come from k-means' own
draws, which differ between the packages.  The test pins them as
``test_torch_nystrom.py`` does: it records the JAX engine's k-means key
of every solve and runs the port's Lloyd loop from the k-means++ seeds
JAX draws with that key (D² sampling reads only distances, so a rotated
spectral embedding gets the same seeds).  With the JAX Q-networks
carried over too, the round must pick the same cohort and the same
partition, label for label.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cohort.engine as jax_engine
import repro_torch.cohort.engine as port_engine
from repro.core.kmeans import kmeans_plus_plus_init as jax_kpp_init
from repro.fed import FederatedRunner as JaxRunner
from repro.fed import RunnerConfig as JaxConfig
from repro_torch.convert import (cnn_params_from_jax, dqn_params_from_jax,
                                 embedder_from_jax)
from repro_torch.core.kmeans import _lloyd
from repro_torch.fed.realism import RoundSpec, TraceSpec
from repro_torch.fed.rounds import FederatedRunner, RunnerConfig
from repro_torch.models.cnn import pool_noise_shape

# lr: the integration test's 0.05 nudged by one part in 2^20, so the JAX
# jit cache keys this file's trace of local_train_cohort (traced with the
# decisive noise) apart from every other test's
CONFIG = dict(dataset="mnist", num_clients=12, clients_per_round=4,
              local_steps=8, batch_size=16, train_size=1200, eval_size=256,
              num_clusters=3, embed_dim=4, seed=0, use_pallas=True,
              lr=0.05 * (1 + 2.0 ** -20))


def same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    pairs = {(int(x), int(y)) for x, y in zip(a, b)}
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def decisive_noise(key, shape):
    """64 on one random entry of each window's last axis, 0 elsewhere."""
    win = jax.random.randint(key, shape[:-1], 0, shape[-1])
    return 64.0 * jax.nn.one_hot(win, shape[-1], dtype=jnp.float32)


@pytest.fixture
def decisive_pooling(monkeypatch):
    """The JAX pool draws ``decisive_noise`` for the test's duration."""
    monkeypatch.setattr(jax.random, "gumbel", decisive_noise)


def jax_noise(runner):
    """The port runner's ``_pool_noise``, drawing from the JAX keys."""
    cfg = runner.cfg

    def pool_noise(k):
        keys = jax.random.split(jax.random.PRNGKey(
            cfg.seed * 100_003 + runner.round_idx), k)
        b, c, hp, wp, win = pool_noise_shape(cfg.batch_size, 28)
        steps = []
        for _ in range(cfg.local_steps):
            pairs = jax.vmap(jax.random.split)(keys)
            keys, subs = pairs[:, 0], pairs[:, 1]
            g = jax.vmap(lambda key: decisive_noise(
                key, (b, hp, wp, c, win)))(subs)
            steps.append(torch.from_numpy(np.ascontiguousarray(
                np.asarray(g).transpose(0, 1, 4, 2, 3, 5))))
        return lambda step: steps[step]

    return pool_noise


def twin_runners(policy, sigma):
    """A JAX runner and a port runner on the CPU with its weights,
    projection and pooling noise."""
    kw = dict(CONFIG, policy=policy, sigma=sigma)
    ref = JaxRunner(JaxConfig(**kw))
    port = FederatedRunner(RunnerConfig(**kw), device="cpu")
    port.global_params = cnn_params_from_jax(ref.global_params)
    port.embedder = embedder_from_jax(np.asarray(ref.embedder.proj),
                                      device="cpu")
    port._pool_noise = jax_noise(port)
    return ref, port


def test_fedavg_round_matches_jax(decisive_pooling):
    ref, port = twin_runners("fedavg", 0.5)
    np.testing.assert_array_equal(port.x_train, ref.x_train)
    ref.warmup()
    port.warmup()
    np.testing.assert_allclose(port.client_embeds, ref.client_embeds,
                               rtol=1e-4, atol=1e-4)
    want = ref.run_round()
    got = port.run_round()
    np.testing.assert_array_equal(got.selected, want.selected)
    assert abs(got.accuracy - want.accuracy) <= 1.0 / CONFIG["eval_size"]
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-4)
    np.testing.assert_allclose(port.client_embeds, ref.client_embeds,
                               rtol=1e-4, atol=1e-4)
    assert got.reward == pytest.approx(want.reward, rel=1e-3, abs=1e-3)
    assert set(got.timings) == set(want.timings)
    assert abs(sum(got.timings.values()) - got.seconds) < 1e-3


def test_dqre_sc_round_partitions_like_jax(decisive_pooling, monkeypatch):
    ref, port = twin_runners("dqre_sc", 0.8)
    keys = []

    def jax_kmeans(key, y, k):
        keys.append(key)
        return jax_kmeans_fn(key, y, k)

    def port_kmeans(generator, y, k):
        init = jax.jit(jax_kpp_init, static_argnums=2)(keys.pop(0),
                                                       y.numpy(), k)
        return _lloyd(y, torch.from_numpy(np.asarray(init)), 25)

    jax_kmeans_fn = jax_engine.kmeans
    monkeypatch.setattr(jax_engine, "kmeans", jax_kmeans)
    monkeypatch.setattr(port_engine, "kmeans", port_kmeans)
    jax_agent = ref.policy.cluster_policy.agent
    port_agent = port.policy.cluster_policy.agent
    port_agent.net.load_state_dict(dqn_params_from_jax(jax_agent.params))
    port_agent.target.load_state_dict(
        dqn_params_from_jax(jax_agent.target_params))

    want = ref.run_round()
    got = port.run_round()
    assert same_partition(port.policy._last_assign, ref.policy._last_assign)
    np.testing.assert_array_equal(port.policy._last_assign,
                                  ref.policy._last_assign)
    assert len(set(got.selected.tolist())) == 4
    np.testing.assert_array_equal(got.selected, want.selected)
    assert abs(got.accuracy - want.accuracy) <= 1.0 / CONFIG["eval_size"]
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-4)
    assert port.policy.cluster_computes == ref.policy.cluster_computes == 2
    assert not keys


def test_realism_is_not_ported_yet():
    """RunnerConfig.realism raised NotImplementedError until client
    realism was ported (tests/test_torch_realism.py holds it to the JAX
    package); now it attaches a trace and the simulated clock."""
    spec = TraceSpec(dropout_hazard=0.1)
    runner = FederatedRunner(RunnerConfig(**CONFIG, realism=spec,
                                          round_spec=RoundSpec(3.0)),
                             device="cpu")
    assert runner.trace.spec == spec
    assert runner.trace.num_clients == CONFIG["num_clients"]
    assert runner.round_spec.deadline_s == 3.0
    assert runner._clock is runner.sim_clock and runner.sim_clock() == 0.0
