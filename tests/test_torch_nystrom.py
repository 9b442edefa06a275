"""The port's Nyström solve and cohort engine against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The two
draw random numbers differently, so the parity tests hand the JAX draws
(landmark indices, k-means++ centers, subspace starts) to the port and
compare what a rotation of the degenerate leading eigenspace cannot
change: eigenvalues, the ``y·yᵀ`` projector and partitions up to
relabelling.  On the CPU the port's kernels run their plain versions;
the JAX package runs its Pallas kernels in interpret mode.
"""

import jax
import numpy as np
import pytest
import torch

from repro.cohort import CohortConfig as JaxConfig
from repro.cohort import CohortEngine as JaxEngine
from repro.cohort import eigensolver as jax_eig
from repro.cohort.nystrom import nystrom_from_landmarks as jax_nystrom
from repro.core.kmeans import kmeans as jax_kmeans_fn
from repro.core.kmeans import kmeans_plus_plus_init as jax_kpp_init
from repro.core import spectral as jax_spectral
from repro_torch.cohort import CohortConfig, CohortEngine, eigensolver
from repro_torch.cohort.landmarks import LANDMARK_STRATEGIES, select_landmarks
from repro_torch.cohort.nystrom import nystrom_from_landmarks
from repro_torch.convert import cohort_state_from_jax
from repro_torch.core import spectral
from repro_torch.core.kmeans import _lloyd, kmeans

KEY = jax.random.PRNGKey(0)
DTYPES = ("f32", "bf16", "int8")


def blobs(n=509, k=4, sep=8.0, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    labels = rng.integers(0, k, n)
    x = (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)
    return x, labels


def skewed_blobs(seed=0, d=8, sep=10.0):
    """A head cluster with 75 % of the clients + 5 small tails."""
    rng = np.random.default_rng(seed)
    sizes = [450, 30, 30, 30, 30, 30]
    centers = rng.normal(size=(len(sizes), d)) * sep
    labels = np.repeat(np.arange(len(sizes)), sizes)
    x = (centers[labels]
         + rng.normal(size=(len(labels), d))).astype(np.float32)
    return x, labels


def purity(assign, labels):
    assign = np.asarray(assign)
    return sum(np.bincount(labels[assign == c]).max()
               for c in np.unique(assign)) / len(labels)


def same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    pairs = {(int(x), int(y)) for x, y in zip(a, b)}
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


# -- the Nyström solve --------------------------------------------------------

# quantized tiles exist only on the fused path
@pytest.mark.parametrize("dtype, fused", [("f32", True), ("f32", False),
                                          ("bf16", True), ("int8", True)])
def test_nystrom_from_landmarks_matches_jax(dtype, fused):
    x, labels = blobs(n=700)
    k, gamma = 4, 0.05
    idx = np.random.default_rng(1).choice(700, 96, replace=False)
    y0, e0, _, _ = jax_nystrom(x, idx, k, gamma, fused=fused,
                               affinity_dtype=dtype)
    y1, e1, _, _ = nystrom_from_landmarks(
        torch.from_numpy(x), torch.from_numpy(idx), k, gamma, fused=fused,
        affinity_dtype=dtype)
    y0, y1 = np.asarray(y0), y1.numpy()
    np.testing.assert_allclose(np.asarray(e0)[:k + 1], e1.numpy()[:k + 1],
                               atol=1e-3)
    np.testing.assert_allclose(y0 @ y0.T, y1 @ y1.T, atol=5e-2)
    a0, _ = jax_kmeans_fn(KEY, y0, k)
    a1, _ = jax_kmeans_fn(KEY, y1, k)
    assert same_partition(a0, a1)
    assert purity(a1, labels) >= purity(a0, labels) - 1e-3


@pytest.mark.parametrize("shape", [(6, 8), (5, 7), (4096 + 3, 2)])
def test_auto_gamma_matches_jax_nanmedian(shape):
    """Even positive counts average the two middle values, as
    jnp.nanmedian does (torch.nanmedian would take the lower one)."""
    rng = np.random.default_rng(2)
    d2 = rng.random(shape).astype(np.float32) * 10
    d2[rng.random(shape) < 0.2] = 0.0          # zeros drop out
    want = float(jax_spectral.auto_gamma(d2))
    got = float(spectral.auto_gamma(torch.from_numpy(d2)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_auto_gamma_even_count_is_midpoint():
    d2 = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    assert float(spectral.auto_gamma(d2)) == pytest.approx(1.0 / 5.0)
    assert float(jax_spectral.auto_gamma(d2.numpy())) == pytest.approx(0.2)


def test_lloyd_from_jax_centers_reproduces_jax_kmeans():
    x, _ = blobs(n=400, k=5, sep=3.0, seed=3)
    y = x / np.linalg.norm(x, axis=1, keepdims=True)
    init = jax.jit(jax_kpp_init, static_argnums=2)(KEY, y, 5)
    want, _ = jax_kmeans_fn(KEY, y, 5)
    got, _ = _lloyd(torch.from_numpy(y), torch.tensor(np.asarray(init)), 25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kmeans_plus_plus_is_deterministic_per_generator():
    x, labels = blobs(n=300, k=3, sep=10.0)
    xt = torch.from_numpy(x)
    a, _ = kmeans(torch.Generator().manual_seed(5), xt, 3)
    b, _ = kmeans(torch.Generator().manual_seed(5), xt, 3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert purity(a.numpy(), labels) == 1.0


# -- eigensolver --------------------------------------------------------------

def test_subspace_topk_matches_jax_given_q0():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(96, 96)).astype(np.float32)
    w = a @ a.T
    q0 = rng.normal(size=(96, 6)).astype(np.float32)
    e0, v0 = jax_eig.subspace_topk(w, 6, iters=40, q0=q0)
    e1, v1 = eigensolver.subspace_topk(torch.from_numpy(w), 6, iters=40,
                                       q0=torch.from_numpy(q0))
    v0, v1 = np.asarray(v0), v1.numpy()
    np.testing.assert_allclose(np.asarray(e0), e1.numpy(), rtol=1e-4)
    np.testing.assert_allclose(v0 @ v0.T, v1 @ v1.T, atol=1e-3)


def test_topk_eigh_and_isqrt_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(40, 40)).astype(np.float32)
    w = a @ a.T / 40
    e0, u0 = jax_eig.topk_eigh(w, 40)
    e1, u1 = eigensolver.topk_eigh(torch.from_numpy(w), 40)
    np.testing.assert_allclose(np.asarray(e0), e1.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(jax_eig.isqrt_from_eigs(e0, u0)),
        eigensolver.isqrt_from_eigs(e1, u1).numpy(), rtol=1e-3, atol=1e-3)


def test_blocked_matmul_panels_and_missing_panel_kernel():
    """Both panel routes give the plain product; the kernel route (now
    ported, B5) runs its plain version on CPU tensors without counting."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(130, 130)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(130, 9)).astype(np.float32))
    np.testing.assert_allclose(eigensolver._blocked_matmul(w, q, 32),
                               w @ q, rtol=1e-5, atol=1e-5)
    ops.reset_launch_counts()
    np.testing.assert_allclose(
        eigensolver._blocked_matmul(w, q, 32, use_pallas=True), w @ q,
        rtol=1e-5, atol=1e-5)
    assert ops.LAUNCH_COUNTS["panel_matmul"] == 0


# -- landmarks ----------------------------------------------------------------

@pytest.mark.parametrize("strategy", LANDMARK_STRATEGIES)
def test_landmarks_are_a_pure_function_of_the_generator(strategy):
    x, _ = skewed_blobs()
    xt = torch.from_numpy(x)
    a = select_landmarks(torch.Generator().manual_seed(7), xt, 24, strategy)
    b = select_landmarks(torch.Generator().manual_seed(7), xt, 24, strategy)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert len(np.unique(a.numpy())) == 24
    assert a.min() >= 0 and a.max() < len(x)


def test_kmeanspp_landmarks_reach_every_tail():
    x, labels = skewed_blobs()
    idx = select_landmarks(torch.Generator().manual_seed(0),
                           torch.from_numpy(x), 24, "kmeans++")
    assert set(labels[idx.numpy()]) == set(range(6))


# -- the engine ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_partition_matches_jax_engine(dtype):
    x, labels = blobs()
    kw = dict(num_clusters=4, method="nystrom", use_pallas=True,
              num_landmarks=64, affinity_dtype=dtype)
    want = JaxEngine(JaxConfig(**kw), seed=0).select(x)
    got = CohortEngine(CohortConfig(**kw), seed=0, device="cpu").select(x)
    assert got.method == want.method == "nystrom"
    assert got.assign.shape == (len(x),) and got.embedding.shape == (
        len(x), 4)
    assert same_partition(got.assign, want.assign)
    assert purity(got.assign, labels) == 1.0


def test_engine_cold_cache_warm_and_cold_determinism():
    x, _ = blobs()
    cfg = CohortConfig(num_clusters=4, method="nystrom", use_pallas=True,
                       num_landmarks=64)
    eng = CohortEngine(cfg, seed=3, device="cpu")
    first = eng.select(x)
    assert first.source == "cold"
    assert eng.select(x).source == "cache"
    drifted = x + 1e-3 * np.random.default_rng(0).normal(
        size=x.shape).astype(np.float32)
    assert eng.select(drifted).source == "warm"
    assert eng.stats["cold_starts"] == eng.stats["warm_starts"] == 1
    again = CohortEngine(cfg, seed=3, device="cpu").select(x)
    np.testing.assert_array_equal(again.assign, first.assign)
    np.testing.assert_array_equal(again.embedding, first.embedding)


def test_sharded_runs_the_single_device_core():
    x, _ = blobs()
    kw = dict(num_clusters=4, use_pallas=True, num_landmarks=64)
    a = CohortEngine(CohortConfig(method="sharded", **kw), seed=0,
                     device="cpu").select(x)
    b = CohortEngine(CohortConfig(method="nystrom", **kw), seed=0,
                     device="cpu").select(x)
    assert a.method == "sharded"
    np.testing.assert_array_equal(a.assign, b.assign)


def test_dense_use_pallas_is_not_ported_yet():
    """The dense path's pairwise-distance kernel (B7) is ported now: the
    use_pallas engine partitions like the plain one and like JAX's."""
    x, labels = blobs(n=64)
    kw = dict(num_clusters=4, method="dense", use_pallas=True)
    got = CohortEngine(CohortConfig(**kw), device="cpu").select(x)
    plain = CohortEngine(CohortConfig(num_clusters=4, method="dense"),
                         device="cpu").select(x)
    want = JaxEngine(JaxConfig(**kw), seed=0).select(x)
    assert got.method == plain.method == "dense"
    assert got.assign.shape == plain.assign.shape == (64,)
    assert same_partition(got.assign, plain.assign)
    assert same_partition(got.assign, want.assign)
    assert purity(got.assign, labels) == 1.0


def test_engine_without_a_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CohortEngine(CohortConfig())
    assert CohortEngine(CohortConfig(), device="cpu").device.type == "cpu"


def test_cohort_state_from_jax_warm_starts_the_port():
    x, _ = blobs()
    kw = dict(num_clusters=4, method="nystrom", num_landmarks=64)
    jax_engine = JaxEngine(JaxConfig(**kw), seed=0)
    jax_engine.select(x)
    eng = CohortEngine(CohortConfig(**kw), seed=0, device="cpu")
    eng.state = cohort_state_from_jax(jax_engine.state)
    drifted = x + 1e-3 * np.random.default_rng(1).normal(
        size=x.shape).astype(np.float32)
    res = eng.select(drifted)
    assert res.source == "warm"
    np.testing.assert_array_equal(eng.state.landmark_idx,
                                  np.asarray(jax_engine.state.landmark_idx))
    assert eng.state.gamma == pytest.approx(jax_engine.state.gamma)
