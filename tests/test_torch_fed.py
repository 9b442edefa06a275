"""The port's federated-loop pieces against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
CNN's parameters and the embedding projection are JAX draws carried over
by ``repro_torch.convert``; the stochastic-pooling noise is the JAX
package's Gumbel draws, transposed to the port's (B, C, H/2, W/2, 4)
layout and injected.  Where parity could break, the test says so: the
leaf order and layout of the flattened weights, fc1's NHWC input order,
the pooling window order, and the numpy draws of data and policies.
Tolerances are relative f32 ones; partitions compare up to relabelling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cohort import CohortConfig as JaxCohortConfig
from repro.cohort import CohortEngine as JaxEngine
from repro.core import selection as jax_sel
from repro.core.embedding import WeightEmbedder as JaxEmbedder
from repro.fed import client as jax_client
from repro.fed import datasets as jax_datasets
from repro.fed import partition as jax_partition
from repro.fed import server as jax_server
from repro.models import cnn as jax_cnn
from repro_torch.convert import cnn_params_from_jax, embedder_from_jax
from repro_torch.core import selection
from repro_torch.core.embedding import flatten_params, jax_layout, pca_embed
from repro_torch.fed import client, datasets, partition, server
from repro_torch.models.cnn import CNN, cnn_loss, gumbel_noise, stochastic_pool

B, IMG = 6, 28


def same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    pairs = {(int(x), int(y)) for x, y in zip(a, b)}
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def jax_params(seed=0, **kw):
    return jax_cnn.cnn_init(jax.random.PRNGKey(seed), **kw)


def port_model(params, **kw):
    """A port CNN carrying the JAX parameters, and its state dict."""
    model = CNN(**kw)
    state = cnn_params_from_jax(params)
    model.load_state_dict(state)
    return model, state


def images(n=B, size=IMG, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, channels)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def jax_gumbel(key, shape):
    """JAX's pooling noise (B, H/2, W/2, C, 4) -> the port's layout."""
    g = np.asarray(jax.random.gumbel(key, shape))
    return np.ascontiguousarray(g.transpose(0, 3, 1, 2, 4))


def jax_cohort_noise(keys, steps, shape):
    """Per-step noise of a vmapped cohort, as ``local_train`` draws it:
    per step ``rng, sub = split(rng)``, then gumbel(sub) in the pool."""
    out = []
    for _ in range(steps):
        pairs = jax.vmap(jax.random.split)(keys)
        keys, subs = pairs[:, 0], pairs[:, 1]
        g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(subs))
        out.append(torch.from_numpy(g.transpose(0, 1, 4, 2, 3, 5).copy()))
    return out


def tree_allclose(tree, state, rtol, atol, *, stacked=False):
    """A JAX parameter tree against a port state dict in JAX layout
    (``stacked``: both carry a leading client axis)."""
    got = torch.func.vmap(jax_layout)(state) if stacked else jax_layout(
        state)
    assert sorted(got) == sorted(tree)
    for layer in tree:
        for leaf in ("b", "w"):
            np.testing.assert_allclose(
                np.asarray(got[layer][leaf]), np.asarray(tree[layer][leaf]),
                rtol=rtol, atol=atol, err_msg=f"{layer}.{leaf}")


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jax_datasets.DATASETS))
def test_make_dataset_is_bit_identical(name):
    a = jax_datasets.make_dataset(name, seed=3, train_size=80, test_size=20)
    b = datasets.make_dataset(name, seed=3, train_size=80, test_size=20)
    assert a["spec"] == b["spec"] or a["spec"].name == b["spec"].name
    for k in ("x_train", "y_train", "x_test", "y_test"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("sigma", [0.0, 0.5, 0.8, 1.0, 0.65])
def test_partition_non_iid_is_bit_identical(sigma):
    y = np.random.default_rng(0).integers(0, 10, 600).astype(np.int32)
    assert partition.sigma_to_alpha(sigma) == jax_partition.sigma_to_alpha(
        sigma)
    a = jax_partition.partition_non_iid(y, 17, sigma, seed=2)
    b = partition.partition_non_iid(y, 17, sigma, seed=2)
    assert len(a) == len(b) == 17
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


# -- the CNN -----------------------------------------------------------------

def test_cnn_params_round_trip_through_the_port():
    """JAX -> port -> JAX layout gives back the input, leaf for leaf."""
    tree = jax_params(in_channels=3, image_size=32)
    state = cnn_params_from_jax(tree)
    assert state["conv1.weight"].shape == (18, 24, 3, 3)     # OIHW
    assert state["fc1.weight"].shape == (128, 16 * 16 * 6)   # (out, in)
    back = jax_layout(state)
    for layer in tree:
        for leaf in ("b", "w"):
            np.testing.assert_array_equal(np.asarray(back[layer][leaf]),
                                          np.asarray(tree[layer][leaf]))


def test_flatten_params_follows_jax_leaf_order_and_layout():
    """jax.tree.leaves sorts keys (conv0.b, conv0.w, …, fc2.w) and keeps
    HWIO / (in, out): the port's flat vector is the JAX one."""
    tree = jax_params()
    from repro.core.embedding import flatten_pytree
    _, state = port_model(tree)
    np.testing.assert_array_equal(flatten_params(state).numpy(),
                                  np.asarray(flatten_pytree(tree)))


@pytest.mark.parametrize("channels, size", [(1, 28), (3, 32)])
def test_eval_logits_match_jax(channels, size):
    """Eval mode (probability-weighted pool); fc1 reads the NHWC flatten."""
    tree = jax_params(in_channels=channels, image_size=size)
    model, _ = port_model(tree, in_channels=channels, image_size=size)
    x, _ = images(size=size, channels=channels)
    want = np.asarray(jax_cnn.cnn_apply(tree, x))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_stochastic_pool_train_mode_with_injected_noise_is_equal():
    """Window index t is (dy, dx) row-major; odd H and W are cropped."""
    rng = np.random.default_rng(1)
    x = np.maximum(rng.normal(size=(3, 7, 9, 5)), -0.2).astype(np.float32)
    x[0, :2, :2, 0] = -1.0                   # an all-negative window
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_cnn.stochastic_pool(x, key))        # (B, 3, 4, C)
    noise = jax_gumbel(key, (3, 3, 4, 5, 4)).copy()
    got = stochastic_pool(torch.from_numpy(x).permute(0, 3, 1, 2),
                          torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), want)
    # eval mode: the probability-weighted mean
    want = np.asarray(jax_cnn.stochastic_pool(x))
    got = stochastic_pool(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-6,
                               atol=1e-6)


def test_cnn_loss_gradient_matches_jax_per_leaf():
    tree = jax_params()
    model, state = port_model(tree)
    x, y = images()
    key = jax.random.PRNGKey(7)
    (loss0, _), g0 = jax.value_and_grad(jax_cnn.cnn_loss, has_aux=True)(
        tree, {"x": x, "y": y}, key)
    noise = torch.from_numpy(jax_gumbel(key, (B, 14, 14, 18, 4)))
    params = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    loss1, _ = cnn_loss(model, {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y).long()},
                        noise, params=params)
    grads = torch.autograd.grad(loss1, list(params.values()))
    np.testing.assert_allclose(loss1.item(), float(loss0), rtol=1e-5)
    tree_allclose(g0, dict(zip(params, grads)), rtol=1e-4, atol=1e-6)


def test_local_train_cohort_matches_jax_with_injected_noise():
    tree = jax_params()
    model, state = port_model(tree)
    rng = np.random.default_rng(2)
    k, steps, bs = 3, 2, 5
    xs = rng.normal(size=(k, steps, bs, IMG, IMG, 1)).astype(np.float32)
    ys = rng.integers(0, 10, (k, steps, bs)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), k)
    want, want_loss = jax_client.local_train_cohort(tree, xs, ys, keys,
                                                    lr=0.05)
    noise = jax_cohort_noise(keys, steps, (bs, 14, 14, 18, 4))
    got, got_loss = client.local_train_cohort(
        model, state, torch.from_numpy(xs), torch.from_numpy(ys).long(),
        lambda s: noise[s], lr=0.05)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               rtol=1e-4)
    tree_allclose(want, got, rtol=1e-4, atol=1e-4, stacked=True)


def test_local_train_single_client_equals_its_cohort_row():
    tree = jax_params()
    model, state = port_model(tree)
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(
        rng.normal(size=(2, 2, 4, IMG, IMG, 1)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, (2, 2, 4))).long()
    draw = gumbel_noise(5, (2, 4, 18, 14, 14, 4), "cpu")
    noise = [draw(s) for s in range(2)]
    stacked, losses = client.local_train_cohort(model, state, xs, ys,
                                                lambda s: noise[s], lr=0.1)
    one, loss = client.local_train(model, state, xs[1], ys[1],
                                   lambda s: noise[s][1], lr=0.1)
    for name in state:
        np.testing.assert_allclose(one[name].numpy(),
                                   stacked[name][1].numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(loss), float(losses[1]), rtol=1e-6)


def test_evaluate_matches_jax():
    tree = jax_params()
    model, state = port_model(tree)
    x, y = images(n=32, seed=4)
    acc0, loss0, logits0 = jax_client.evaluate(tree, x, y)
    acc1, loss1, logits1 = client.evaluate(model, state, torch.from_numpy(x),
                                           torch.from_numpy(y).long())
    assert float(acc1) == float(acc0)
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-5)
    np.testing.assert_allclose(logits1.numpy(), np.asarray(logits0),
                               rtol=1e-4, atol=1e-4)


# -- server and embeddings --------------------------------------------------

def _stacked(k=4, seed=5):
    """K perturbed copies of one JAX model, in both packages' forms."""
    base = jax_params()
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: jnp.stack([a + 0.01 * rng.normal(size=a.shape).astype(
            np.float32) for _ in range(k)]), base)
    state = {name: torch.stack([cnn_params_from_jax(
        jax.tree.map(lambda a, i=i: a[i], tree))[name] for i in range(k)])
        for name in cnn_params_from_jax(base)}
    return base, tree, state


def test_fedavg_params_delta_and_embeddings_match_jax():
    base, tree, state = _stacked()
    weights = np.array([3.0, 1.0, 2.0, 5.0], np.float32)
    tree_allclose(jax_server.fedavg_aggregate(tree, weights),
                  server.fedavg_aggregate(state, weights), rtol=1e-5,
                  atol=1e-6)
    base_state = cnn_params_from_jax(base)
    delta = server.params_delta(state, base_state)
    tree_allclose(jax_server.params_delta(tree, base),
                  delta, rtol=1e-5, atol=1e-6, stacked=True)
    jax_emb = JaxEmbedder(base, dim=4, seed=0)
    emb = embedder_from_jax(np.asarray(jax_emb.proj), device="cpu")
    want = jax_server.weight_delta_embedding(jax_emb, tree, base)
    got = server.weight_delta_embedding(emb, state, base_state)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(emb(base_state), jax_emb(base), rtol=1e-5,
                               atol=1e-5)


def test_pca_embed_matches_jax():
    from repro.core.embedding import pca_embed as jax_pca
    mats = np.random.default_rng(6).normal(size=(9, 20))
    np.testing.assert_array_equal(pca_embed(mats, 3), jax_pca(mats, 3))


# -- policies ----------------------------------------------------------------

def _round_state(cls, n=40, dim=4, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, dim)) * 5
    embeds = (centers[rng.integers(0, 3, n)]
              + rng.normal(size=(n, dim))).astype(np.float32)
    return cls(0, embeds, rng.normal(size=dim).astype(np.float32), 0.1)


@pytest.mark.parametrize("name", ["fedavg", "kcenter"])
def test_host_policies_pick_the_same_ids(name):
    """Numpy draws stay numpy draws: the same seed picks the same ids."""
    want = jax_sel.make_policy(name, 40, 6, 4, seed=3).select(
        _round_state(jax_sel.RoundState))
    got = selection.make_policy(name, 40, 6, 4, seed=3).select(
        _round_state(selection.RoundState))
    np.testing.assert_array_equal(got, want)


def test_dqre_sc_partition_matches_the_jax_engine():
    state = _round_state(selection.RoundState)
    pol = selection.make_policy("dqre_sc", 40, 6, 4, seed=0, device="cpu",
                                num_clusters=3, use_pallas=True)
    picked = pol.select(state)
    want = JaxEngine(JaxCohortConfig(num_clusters=3, method="dense"),
                     seed=1).select(state.client_embeds).assign
    assert same_partition(pol._last_assign, want)
    assert len(set(picked.tolist())) == 6
    next_state = _round_state(selection.RoundState, seed=8)
    pol.update(state, next_state, selection.Feedback(0.3, -0.9, picked))
    assert pol.cluster_computes == 2
    assert pol.cluster_policy.agent.buffer.size == 6


@pytest.mark.parametrize("name", ["favor", "stratified"])
def test_learning_policies_run_on_the_cpu(name):
    state = _round_state(selection.RoundState)
    kw = {"num_clusters": 3} if name == "stratified" else {}
    pol = selection.make_policy(name, 40, 6, 4, seed=0, device="cpu", **kw)
    picked = pol.select(state)
    assert len(set(np.asarray(picked).tolist())) == 6
    pol.update(state, state, selection.Feedback(0.3, -0.9, picked))


def test_favor_reward_is_the_jax_shaping():
    for acc in (0.0, 0.5, 0.9, 1.0):
        assert selection.favor_reward(acc, 0.85) == pytest.approx(
            jax_sel.favor_reward(acc, 0.85))
