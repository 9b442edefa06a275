"""The port's CUDA kernels on the card (skipped without a CUDA device).

These imports stay free of JAX, so the file runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same CUDA
tensors; only the summation order differs.  The float32 products and
convolutions must not run in TF32, so the fixture checks both switches.
"""

import numpy as np
import pytest
import torch

from repro_torch.cohort import CohortConfig, CohortEngine
from repro_torch.core import spectral
from repro_torch.kernels import nystrom as kn
from repro_torch.kernels import ops, ref

DTYPES = ("f32", "bf16", "int8")
FUSED = ("quantized_cross_affinity", "nystrom_colsum", "nystrom_gram",
         "nystrom_extension")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _inputs(dev, n=261, m=65, d=7, k=5, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return (t(rng.normal(size=(n, d))), t(rng.normal(size=(m, d))), 0.37,
            t(rng.random(n) > 0.1), t(rng.normal(size=(m,)) ** 2 + 0.1),
            t(rng.normal(size=(m, m))), t(rng.normal(size=(m, k))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_plain_versions(cuda_device, dtype):
    x, z, g, mask, u, wis, proj = _inputs(cuda_device)
    kw = dict(affinity_dtype=dtype)
    kn.reset_launch_counts()
    pairs = [
        (kn.nystrom_colsum(x, z, g, mask, **kw),
         ref.nystrom_colsum_ref(x, z, g, mask, **kw)),
        (kn.nystrom_gram(x, z, g, u, wis, mask, **kw),
         ref.nystrom_gram_ref(x, z, g, u, wis, mask, **kw)),
        (kn.nystrom_extension(x, z, g, u, proj, mask, **kw),
         ref.nystrom_extension_ref(x, z, g, u, proj, mask, **kw)),
        (kn.quantized_cross_affinity(x, z, g, **kw),
         ref.quantized_cross_affinity_ref(x, z, g, **kw)),
    ]
    torch.cuda.synchronize()
    assert all(kn.LAUNCH_COUNTS[name] == 1 for name in FUSED)
    for got, want in pairs:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous_input(cuda_device):
    x, z, *_ = _inputs(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kn.nystrom_colsum(x.T.contiguous().T, z, 0.37)


@pytest.mark.cuda
def test_engine_on_the_card_partitions_like_the_cpu(cuda_device):
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 8)) * 8
    x = (centers[rng.integers(0, 4, 3000)]
         + rng.normal(size=(3000, 8))).astype(np.float32)
    cfg = CohortConfig(num_clusters=4, method="nystrom", use_pallas=True,
                       num_landmarks=64)
    kn.reset_launch_counts()
    card = CohortEngine(cfg, seed=1, device=cuda_device).select(x)
    assert all(kn.LAUNCH_COUNTS[name] == 1 for name in FUSED)
    assert kn.LAUNCH_COUNTS["panel_matmul"] == 0          # m <= eigh_cutoff
    cpu = CohortEngine(cfg, seed=1, device="cpu").select(x)
    pairs = {(int(a), int(b)) for a, b in zip(card.assign, cpu.assign)}
    assert len(pairs) == len(set(card.assign.tolist())) == len(
        set(cpu.assign.tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("n, m, d", [(37, 21, 7), (100, 100, 8),
                                     (300, 50, 20)])
def test_affinity_kernels_match_plain_versions(cuda_device, n, m, d):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                     device=cuda_device)
    y = torch.tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                     device=cuda_device)
    ops.reset_launch_counts()
    dist = ops.pairwise_sq_dists(x, y)
    cross = ops.rbf_cross_affinity(x, y, 0.3)
    square = ops.rbf_affinity(x, 0.3)
    torch.cuda.synchronize()
    for name in ("pairwise_sq_dists", "rbf_cross_affinity", "rbf_affinity"):
        assert ops.LAUNCH_COUNTS[name] == 1
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    np.testing.assert_allclose(dist.cpu().numpy(),
                               ref.pairwise_sq_dists_ref(x, y).cpu().numpy(),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(
        cross.cpu().numpy(), ref.rbf_cross_affinity_ref(x, y, 0.3).cpu(
        ).numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        square.cpu().numpy(), ref.rbf_affinity_ref(x, 0.3).cpu().numpy(),
        rtol=0, atol=1e-5)
    assert torch.all(square.diagonal() == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m, p, r", [(40, 40, 5), (130, 70, 9),
                                     (4096, 4096, 8)])
def test_panel_matmul_matches_plain_version(cuda_device, m, p, r):
    rng = np.random.default_rng(2)
    w = torch.tensor(rng.normal(size=(m, p)), dtype=torch.float32,
                     device=cuda_device)
    q = torch.tensor(rng.normal(size=(p, r)), dtype=torch.float32,
                     device=cuda_device)
    ops.reset_launch_counts()
    got = ops.panel_matmul(w, q)
    again = ops.panel_matmul(w, q)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["panel_matmul"] == 2
    assert torch.equal(got, again)          # one fixed summation order
    want = ref.panel_matmul_ref(w, q)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5


@pytest.mark.cuda
def test_dense_spectral_cluster_on_the_card_launches_b7(cuda_device):
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(4, 8)) * 6
    x = (centers[rng.integers(0, 4, 500)]
         + rng.normal(size=(500, 8))).astype(np.float32)
    ops.reset_launch_counts()
    card, _, _ = spectral.spectral_cluster(
        torch.Generator().manual_seed(0), torch.tensor(x, device=cuda_device),
        4, use_pallas=True)
    assert ops.LAUNCH_COUNTS["pairwise_sq_dists"] == 1
    cpu, _, _ = spectral.spectral_cluster(
        torch.Generator().manual_seed(0), torch.from_numpy(x), 4,
        use_pallas=True)
    pairs = {(int(a), int(b)) for a, b in zip(card.cpu().numpy(),
                                              cpu.numpy())}
    assert len(pairs) == len(set(cpu.tolist()))
