"""The port's CUDA kernels on the card (skipped without a CUDA device).

These imports stay free of JAX, so the file runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same CUDA
tensors; only the summation order differs.
"""

import numpy as np
import pytest
import torch

from repro_torch.cohort import CohortConfig, CohortEngine
from repro_torch.kernels import nystrom as kn
from repro_torch.kernels import ref

DTYPES = ("f32", "bf16", "int8")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
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
    assert all(v == 1 for v in kn.LAUNCH_COUNTS.values())
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
    assert all(v == 1 for v in kn.LAUNCH_COUNTS.values())
    cpu = CohortEngine(cfg, seed=1, device="cpu").select(x)
    pairs = {(int(a), int(b)) for a, b in zip(card.assign, cpu.assign)}
    assert len(pairs) == len(set(card.assign.tolist())) == len(
        set(cpu.assign.tolist()))
