"""The plain versions of the affinity and panel-matmul kernels (B5–B8)
against the JAX package.

On the CPU each wrapper runs its plain PyTorch version, so these tests
hold those versions to ``repro.kernels.ref`` and to the JAX wrappers in
``repro.kernels.ops`` (Pallas in interpret mode here), on the same numpy
inputs at ragged shapes.  The JAX kernels take the squared distance in
the norm form ‖x‖² + ‖y‖² − 2x·yᵀ, which cancels, so distances are held
to 1e-5·(max‖x‖² + max‖y‖²) and not to the largest entry; the RBF
entries lie in [0, 1] and are held to 1e-5 absolute.  The CUDA kernels
are held to the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.affinity_pallas import rbf_cross_affinity_pallas
from repro_torch.kernels import affinity, ops, ref
from repro_torch.kernels import nystrom as kn

# (n, m, d): ragged, square, wider than the d <= 8 register bound
SHAPES = [(37, 21, 7), (16, 16, 8), (9, 40, 20)]


def points(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32) * 2,
            rng.normal(size=(m, d)).astype(np.float32) * 2)


def dist_tol(x, y):
    return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())


@pytest.mark.parametrize("n, m, d", SHAPES)
def test_pairwise_sq_dists_matches_jax(n, m, d):
    x, y = points(n, m, d)
    got = ops.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, m)
    tol = dist_tol(x, y)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref.pairwise_sq_dists_ref(x, y)), rtol=1e-6, atol=tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ops.pairwise_sq_dists(x, y)), rtol=0, atol=tol)
    assert float(got.min()) >= 0.0


@pytest.mark.parametrize("n, m, d", SHAPES)
def test_rbf_cross_affinity_matches_jax(n, m, d):
    x, y = points(n, m, d, seed=1)
    g = 0.21
    got = ops.rbf_cross_affinity(torch.from_numpy(x), torch.from_numpy(y), g)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref.rbf_cross_affinity_ref(x, y, g)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ops.rbf_cross_affinity(x, y, g)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n, m, d", SHAPES)
def test_f32_quantized_cross_affinity_equals_rbf_cross_affinity(n, m, d):
    """B1 at f32 and B6 are one function (on the card, one kernel): equal
    bit for bit, and both within 1e-5 of the Pallas kernel (interpret
    mode)."""
    x, y = points(n, m, d, seed=4)
    g = 0.21
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    quantized = kn.quantized_cross_affinity(tx, ty, g, affinity_dtype="f32")
    rbf = ops.rbf_cross_affinity(tx, ty, g)
    assert torch.equal(quantized, rbf)
    want = np.asarray(rbf_cross_affinity_pallas(x, y, g, interpret=True))
    for got in (quantized, rbf):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n, d", [(37, 7), (16, 8), (9, 20)])
def test_rbf_affinity_matches_jax_with_zero_diagonal(n, d):
    x, _ = points(n, 1, d, seed=2)
    g = 0.33
    got = ops.rbf_affinity(torch.from_numpy(x), g)
    assert np.all(np.diag(got.numpy()) == 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref.rbf_affinity_ref(x, g)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ops.rbf_affinity(x, g)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("m, p, r, block_rows", [(40, 40, 5, 16),
                                                 (37, 23, 9, 8),
                                                 (24, 24, 3, 64)])
def test_panel_matmul_matches_jax(m, p, r, block_rows):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(m, p)).astype(np.float32)
    q = rng.normal(size=(p, r)).astype(np.float32)
    got = ops.panel_matmul(torch.from_numpy(w), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ref.panel_matmul_ref(
        w, q)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_ops.panel_matmul(
        w, q, block_rows=block_rows)), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_route_to_plain_versions_without_counting():
    x, y = (torch.from_numpy(a) for a in points(11, 5, 3))
    w = torch.eye(6)
    ops.reset_launch_counts()
    pairs = [(ops.pairwise_sq_dists(x, y), ref.pairwise_sq_dists_ref(x, y)),
             (ops.rbf_cross_affinity(x, y, 0.5),
              ref.rbf_cross_affinity_ref(x, y, 0.5)),
             (ops.rbf_affinity(x, 0.5), ref.rbf_affinity_ref(x, 0.5)),
             (ops.panel_matmul(w, w[:, :2]),
              ref.panel_matmul_ref(w, w[:, :2]))]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert all(v == 0 for v in ops.LAUNCH_COUNTS.values())
    assert set(ops.LAUNCH_COUNTS) >= {"panel_matmul", "pairwise_sq_dists",
                                      "rbf_affinity", "rbf_cross_affinity"}


@pytest.mark.parametrize("call, match", [
    (lambda: affinity.pairwise_sq_dists(torch.zeros(3, 2),
                                        torch.zeros(4, 3)), "must be"),
    (lambda: affinity.rbf_affinity(torch.zeros(3, 2, dtype=torch.float64),
                                   0.5), "float32"),
    (lambda: affinity.rbf_cross_affinity(torch.zeros(3, 2),
                                         torch.zeros(4, 2, device="meta"),
                                         0.5), "different devices"),
    (lambda: ops.panel_matmul(torch.zeros(4, 3), torch.zeros(4, 2)),
     "must be"),
    (lambda: ops.panel_matmul(torch.zeros(4, 4),
                              torch.zeros(4, 2).tolist()), "torch.Tensor"),
])
def test_wrappers_validate_inputs(call, match):
    with pytest.raises((TypeError, ValueError), match=match):
        call()
