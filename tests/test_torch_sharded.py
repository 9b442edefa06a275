"""The port's mesh-sharded Nyström route (``cohort/sharded.py``) and its
device mesh (``launch/mesh.py``), on the CPU.

A mesh that repeats the CPU, ``("cpu",) * D``, is the counterpart of the
JAX package's forced host devices: it runs the padding, the row masks
and the two cross-shard sums.  The JAX package's own sharded route is
not the oracle (its tests fail under jax 0.9's explicit mesh axes,
ROADMAP §C); its single-device ``nystrom_from_landmarks`` and
``CohortEngine(method="nystrom")`` are, from which the mesh route
differs only in the float summation order of the two sums.  Tolerances:
eigenvalues within 1e-4 (f32 reduction order over 509 rows), the
projector ``Y·Yᵀ`` within 1e-4 of its unit-norm rows, partitions equal up
to relabelling.  At D = 1 the route is ``nystrom_from_landmarks`` bit
for bit.
"""

import jax
import numpy as np
import pytest
import torch

from repro.cohort import CohortConfig as JaxConfig
from repro.cohort import CohortEngine as JaxEngine
from repro.cohort import nystrom_from_landmarks as jax_nystrom
from repro.cohort import uniform_landmarks
from repro.core.kmeans import kmeans as jax_kmeans
from repro_torch.cohort import (CohortConfig, CohortEngine,
                                nystrom_from_landmarks,
                                sharded_nystrom_from_landmarks)
from repro_torch.convert import cohort_state_from_jax
from repro_torch.core.kmeans import kmeans
from repro_torch.core.spectral import cross_affinity
from repro_torch.launch import mesh as M

K = 4
GAMMA = 0.05
EVAL_TOL = 1e-4
PROJ_TOL = 1e-4


def blobs(n=509, k=K, sep=8.0, d=8, seed=0):
    """tests/test_cohort_sharded.py's blobs: 509 rows pad at every D > 1."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    labels = rng.integers(0, k, n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32), \
        labels


def same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all((a[:, None] == a[None, :])
                       == (b[:, None] == b[None, :])))


def cpu_mesh(d):
    return M.make_cohort_mesh(d, device="cpu")


def partition(y, seed=2):
    assign, _ = kmeans(torch.Generator().manual_seed(seed), y, K)
    return assign.numpy()


@pytest.fixture(scope="module")
def reference():
    """x, its labels, the JAX landmarks, and the JAX single-device
    solve's (embedding, evals, partition)."""
    x, labels = blobs()
    idx = uniform_landmarks(jax.random.PRNGKey(1), jax.numpy.asarray(x), 64)
    y, ev, *_ = jax_nystrom(jax.numpy.asarray(x), idx, K, GAMMA)
    assign, _ = jax_kmeans(jax.random.PRNGKey(2), y, K)
    return (torch.from_numpy(x), labels, torch.tensor(np.asarray(idx)),
            np.asarray(y), np.asarray(ev), np.asarray(assign))


SOLVERS = [dict(w_solver="eigh", mm_solver="eigh"),
           dict(w_solver="subspace", mm_solver="subspace", w_rank=32,
                block_rows=16)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("solver", SOLVERS, ids=["eigh", "subspace"])
def test_one_way_mesh_is_the_single_device_solve_bit_for_bit(reference,
                                                             fused, solver):
    x, _, idx, *_ = reference
    kw = dict(fused=fused, use_pallas=fused, **solver)
    want = nystrom_from_landmarks(
        x, idx, K, GAMMA, generator=torch.Generator().manual_seed(3), **kw)
    got = sharded_nystrom_from_landmarks(
        x, idx, K, GAMMA, cpu_mesh(1),
        generator=torch.Generator().manual_seed(3), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_unfused_w_from_landmarks_equals_the_rows_of_c(reference):
    """The mesh route takes W = A(z, z); the single-device route takes
    the landmark rows of C = A(x, z): the same entries, bit for bit."""
    x, _, idx, *_ = reference
    z = x[idx]
    c = cross_affinity(x, z, gamma=GAMMA)
    assert torch.equal(cross_affinity(z, z, gamma=GAMMA), c[idx])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("d", [2, 3, 8])
def test_padded_mesh_matches_the_jax_single_device_solve(reference, d,
                                                         fused):
    x, _, idx, y_ref, ev_ref, assign_ref = reference
    y, ev, *_ = sharded_nystrom_from_landmarks(
        x, idx, K, GAMMA, cpu_mesh(d), fused=fused, use_pallas=fused)
    assert y.shape == (509, K)
    np.testing.assert_allclose(ev.numpy(), ev_ref, atol=EVAL_TOL)
    y = y.numpy()
    np.testing.assert_allclose(y @ y.T, y_ref @ y_ref.T, atol=PROJ_TOL)
    assert same_partition(partition(torch.from_numpy(y)), assign_ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_fused_tile_precisions_partition_like_unfused(reference, dtype):
    x, labels, idx, *_ = reference
    mesh = cpu_mesh(3)
    y_plain, *_ = sharded_nystrom_from_landmarks(x, idx, K, GAMMA, mesh)
    y, *_ = sharded_nystrom_from_landmarks(
        x, idx, K, GAMMA, mesh, fused=True, use_pallas=True,
        affinity_dtype=dtype)
    assert same_partition(partition(y), partition(y_plain))
    assert same_partition(partition(y), labels)


def test_re_solve_is_bit_identical(reference):
    x, _, idx, *_ = reference
    runs = [sharded_nystrom_from_landmarks(
        x, idx, K, GAMMA, cpu_mesh(3), fused=True, use_pallas=True,
        mm_solver="subspace", generator=torch.Generator().manual_seed(5))
        for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def engine(mesh_size, **kw):
    cfg = CohortConfig(num_clusters=K, method="sharded", num_landmarks=64,
                       **kw)
    return CohortEngine(cfg, seed=0, device="cpu", mesh=cpu_mesh(mesh_size))


def test_warm_sharded_solve_equals_cold():
    """tests/test_cohort_sharded.py's warm == cold, on a 3-way mesh."""
    x, _ = blobs()
    x2 = x + 0.01 * np.random.default_rng(3).normal(size=x.shape).astype(
        np.float32)
    kw = dict(solver="subspace", drift_threshold=0.1)
    warm_eng = engine(3, **kw)
    warm_eng.select(x)
    warm = warm_eng.select(x2)
    assert warm.source == "warm" and warm.method == "sharded"
    cold = engine(3, **kw).select(x2)
    assert cold.source == "cold"
    assert same_partition(warm.assign, cold.assign)
    np.testing.assert_allclose(warm.evals, cold.evals, atol=1e-2)


def test_engine_on_a_two_way_mesh_matches_the_jax_nystrom_engine():
    """Cold, each engine draws its own landmarks: the same partition.
    Then both warm-start from the JAX solve's landmarks and bandwidth
    (``cohort_state_from_jax``) on a drifted table: the same partition,
    the leading k eigenvalues within 5e-3 of JAX's.  Past k lies the ~1
    bulk, whose near-null directions of W wander with the summation
    order at this bandwidth (γ ≈ 8.6e-4): the port's single-device
    engine parts from JAX there by 1.3e-2 (ROADMAP §C, the spectrum's
    tail), so the whole spectrum is held to the single-device port
    within the 1e-2 the JAX package's own tests give the bulk
    (``test_cohort_sharded.py::test_sharded_pallas_path_matches_jnp``)."""
    x, labels = blobs()
    kw = dict(num_clusters=K, num_landmarks=64)
    got = engine(2).select(x)
    jax_engine = JaxEngine(JaxConfig(method="nystrom", **kw), seed=0)
    want = jax_engine.select(x)
    assert got.method == "sharded" and got.source == want.source == "cold"
    assert same_partition(got.assign, want.assign)
    assert same_partition(got.assign, labels)
    drifted = x + 1e-3 * np.random.default_rng(1).normal(
        size=x.shape).astype(np.float32)
    eng = engine(2)
    single = CohortEngine(CohortConfig(method="nystrom", **kw), seed=0,
                          device="cpu")
    eng.state = cohort_state_from_jax(jax_engine.state)
    single.state = cohort_state_from_jax(jax_engine.state)
    got, want = eng.select(drifted), jax_engine.select(drifted)
    port = single.select(drifted)
    assert got.source == want.source == port.source == "warm"
    assert same_partition(got.assign, want.assign)
    np.testing.assert_allclose(got.evals[:K], want.evals[:K], atol=5e-3)
    np.testing.assert_allclose(got.evals, port.evals, atol=1e-2)


def test_engine_default_mesh_on_the_cpu_is_one_way():
    eng = CohortEngine(CohortConfig(method="sharded"), device="cpu")
    assert eng._cohort_mesh() == (torch.device("cpu"),)


def test_cohort_server_dqn_roundtrip_over_a_two_way_engine():
    """tests/test_cohort_sharded.py's DQN round trip; the server keeps
    the JAX signature (no mesh), so its engine is swapped for one on a
    2-way mesh before the first select."""
    from repro_torch.launch.serve import CohortServer

    x, _ = blobs()
    n, d = x.shape
    config = CohortConfig(num_clusters=K, method="sharded", num_landmarks=64)
    srv = CohortServer(n, d, seed=0, policy="dqn", config=config,
                       dqn_overrides={"hidden": (32,),
                                      "eps_decay_steps": 10},
                       device="cpu")
    srv.engine = CohortEngine(config, seed=0, device="cpu",
                              mesh=cpu_mesh(2))
    srv.update_embeddings(np.arange(n), x)
    rng = np.random.default_rng(0)
    for r in range(3):
        ids, res = srv.select_cohort(16)
        assert res.method == "sharded"
        assert len(ids) == 16 and len(set(ids.tolist())) == 16
        srv.observe_round(0.5 + 0.1 * r)
        srv.update_embeddings(
            ids, srv.embeds[ids]
            + 0.01 * rng.normal(size=(16, d)).astype(np.float32))
    st = srv.stats()
    assert st["requests"] == 3 and st["rounds_observed"] == 3
    assert st["engine"]["solves"] == 3 and st["engine"]["warm_starts"] >= 1
    assert st["policy"]["train_calls"] == 3
    assert st["last_select"]["method"] == "sharded"


def test_cpu_meshes():
    assert M.make_cohort_mesh(device="cpu") == (torch.device("cpu"),)
    assert M.make_cohort_mesh(3, device="cpu") == (torch.device("cpu"),) * 3
    assert M.as_mesh(["cpu", torch.device("cpu")]) == (
        torch.device("cpu"),) * 2


@pytest.mark.parametrize("devices, match", [
    ((), "at least one"),
    (("cpu", "cuda:0"), r"mix.*'cpu', 'cuda:0'"),
    (("meta",), "CPU or CUDA"),
])
def test_as_mesh_errors_name_the_devices(devices, match):
    with pytest.raises(ValueError, match=match):
        M.as_mesh(devices)


def test_engine_refuses_a_mixed_mesh():
    with pytest.raises(ValueError, match="mix"):
        CohortEngine(device="cpu", mesh=("cpu", "cuda:0"))


def _fake_cards(monkeypatch, count, current=0):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)


def test_cuda_mesh_puts_the_engine_card_first(monkeypatch):
    _fake_cards(monkeypatch, 3, current=1)
    cuda = [torch.device("cuda", i) for i in (1, 0, 2)]
    assert M.make_cohort_mesh() == tuple(cuda)
    assert M.make_cohort_mesh(2, device="cuda:2") == (cuda[2], cuda[1])
    assert M.device_count_available(3) and not M.device_count_available(4)


def test_cuda_mesh_errors_name_the_visible_devices(monkeypatch):
    _fake_cards(monkeypatch, 1)
    with pytest.raises(ValueError, match=r"2 CUDA devices.*'cuda:0'"):
        M.make_cohort_mesh(2)
    with pytest.raises(ValueError, match=r"cuda:1.*1 visible"):
        M.as_mesh(("cuda:0", "cuda:1"))
    with pytest.raises(ValueError, match="num_devices=0"):
        M.make_cohort_mesh(0, device="cpu")


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.make_cohort_mesh()
