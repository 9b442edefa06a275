"""Algorithm I in the port against the JAX package, with the kernels on.

The two packages draw random numbers differently, so these tests hand
the JAX draws to the port: the landmark indices, the k-means++ seeds
(JAX's ``kmeans_plus_plus_init`` on the port's embedding, which picks the
same rows because D² sampling reads only distances) and the subspace
start ``q0``.  With the labelling pinned that way, the partitions must be
equal label for label; the eigenvalues and the ``Y·Yᵀ`` projector are
compared, never raw eigenvectors.  On the CPU the port's kernels run
their plain versions; the JAX package runs its Pallas kernels in
interpret mode.
"""

import jax
import numpy as np
import pytest
import torch

from repro.cohort import eigensolver as jax_eig
from repro.core import spectral as jax_spectral
from repro.core.kmeans import kmeans_plus_plus_init as jax_kpp_init
from repro.core.kmeans import pairwise_sq_dists as jax_sq_dists
from repro_torch.cohort import eigensolver
from repro_torch.cohort.nystrom import nystrom_from_landmarks
from repro_torch.core import spectral
from repro_torch.core.kmeans import _lloyd
from repro_torch.kernels import ops

KEY = jax.random.PRNGKey(3)
K = 4


def blobs(n=160, k=K, sep=6.0, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    labels = rng.integers(0, k, n)
    x = (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)
    return x, labels


def same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    pairs = {(int(u), int(v)) for u, v in zip(a, b)}
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def pinned_kmeans(key, y):
    """The port's Lloyd loop from JAX's k-means++ seeds under ``key``."""
    init = jax.jit(jax_kpp_init, static_argnums=2)(key, y.numpy(), K)
    assign, _ = _lloyd(y, torch.from_numpy(np.asarray(init)), 25)
    return assign.numpy()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_affinity_matrix_matches_jax(use_pallas):
    x, _ = blobs(n=53, d=7)
    want = np.asarray(jax_spectral.affinity_matrix(x, use_pallas=use_pallas))
    ops.reset_launch_counts()
    got = spectral.affinity_matrix(torch.from_numpy(x),
                                   use_pallas=use_pallas).numpy()
    assert ops.LAUNCH_COUNTS["pairwise_sq_dists"] == 0      # CPU tensors
    assert np.all(np.diag(got) == 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dense_spectral_cluster_matches_jax(use_pallas):
    x, labels = blobs()
    want, y0, e0 = jax_spectral.spectral_cluster(KEY, x, K,
                                                 use_pallas=use_pallas)
    km_key, _ = jax.random.split(KEY)
    a = spectral.affinity_matrix(torch.from_numpy(x), use_pallas=use_pallas)
    y1, e1 = spectral.spectral_embedding(a, K)
    np.testing.assert_allclose(e1.numpy()[:K + 1], np.asarray(e0)[:K + 1],
                               atol=1e-4)
    y0, y1n = np.asarray(y0), y1.numpy()
    np.testing.assert_allclose(y1n @ y1n.T, y0 @ y0.T, atol=1e-3)
    np.testing.assert_array_equal(pinned_kmeans(km_key, y1), np.asarray(want))
    # the port's own draws: the same partition, up to relabelling
    own, _, _ = spectral.spectral_cluster(
        torch.Generator().manual_seed(0), torch.from_numpy(x), K,
        use_pallas=use_pallas)
    assert same_partition(own.numpy(), want)
    assert same_partition(own.numpy(), labels)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_nystrom_spectral_cluster_matches_jax(use_pallas):
    x, labels = blobs(n=300)
    m = 48
    want, y0, e0 = jax_spectral.spectral_cluster(
        KEY, x, K, method="nystrom", num_landmarks=m, use_pallas=use_pallas)
    km_key, lm_key = jax.random.split(KEY)
    idx = np.asarray(jax.random.choice(lm_key, len(x), (m,), replace=False))
    gamma = float(jax_spectral.auto_gamma(jax_sq_dists(x, x[idx])))
    y1, e1, _, _ = nystrom_from_landmarks(
        torch.from_numpy(x), torch.from_numpy(idx), K, gamma,
        use_pallas=use_pallas)
    # the leading k: the tail of the Nyström spectrum moves with which
    # near-zero eigenvalues of W each LAPACK puts under the 1e-6 clip
    np.testing.assert_allclose(e1.numpy()[:K], np.asarray(e0)[:K],
                               atol=1e-3)
    y0, y1n = np.asarray(y0), y1.numpy()
    np.testing.assert_allclose(y1n @ y1n.T, y0 @ y0.T, atol=5e-2)
    np.testing.assert_array_equal(pinned_kmeans(km_key, y1), np.asarray(want))
    own, y, evals = spectral.spectral_cluster(
        torch.Generator().manual_seed(0), torch.from_numpy(x), K,
        method="nystrom", num_landmarks=m, use_pallas=use_pallas)
    assert y.shape == (len(x), K) and evals.shape == (m,)
    assert same_partition(own.numpy(), labels)


def test_nystrom_spectral_embedding_draws_landmarks_from_the_generator():
    x, _ = blobs(n=120)
    xt = torch.from_numpy(x)
    a = spectral.nystrom_spectral_embedding(
        torch.Generator().manual_seed(4), xt, K, 40, use_pallas=True)
    b = spectral.nystrom_spectral_embedding(
        torch.Generator().manual_seed(4), xt, K, 40, use_pallas=True)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    with pytest.raises(ValueError, match="num_landmarks"):
        spectral.nystrom_spectral_embedding(
            torch.Generator().manual_seed(4), xt, K, 2)


@pytest.mark.parametrize("kw, match", [
    (dict(method="dense", num_landmarks=8), "num_landmarks"),
    (dict(method="nystrom", solver="subspace"), "solver"),
    (dict(landmark_generator=torch.Generator()), "landmark_generator"),
    (dict(method="spectral"), "unknown method"),
])
def test_spectral_cluster_rejects_bad_options(kw, match):
    x, _ = blobs(n=40)
    with pytest.raises(ValueError, match=match):
        spectral.spectral_cluster(torch.Generator().manual_seed(0),
                                  torch.from_numpy(x), K, **kw)


def test_subspace_topk_panel_kernel_route_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(96, 96)).astype(np.float32)
    w = a @ a.T
    q0 = rng.normal(size=(96, 6)).astype(np.float32)
    e0, v0 = jax_eig.subspace_topk(w, 6, iters=40, q0=q0, block_rows=32,
                                   use_pallas=True)
    e1, v1 = eigensolver.subspace_topk(torch.from_numpy(w), 6, iters=40,
                                       q0=torch.from_numpy(q0),
                                       block_rows=32, use_pallas=True)
    v0, v1 = np.asarray(v0), v1.numpy()
    np.testing.assert_allclose(e1.numpy(), np.asarray(e0), rtol=1e-4)
    np.testing.assert_allclose(v1 @ v1.T, v0 @ v0.T, atol=1e-3)
    # the kernel route and the plain panel route agree
    e2, _ = eigensolver.subspace_topk(torch.from_numpy(w), 6, iters=40,
                                      q0=torch.from_numpy(q0), block_rows=32)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-5)
