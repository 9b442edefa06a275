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

from repro_torch.cohort import CohortConfig, CohortEngine, eigensolver
from repro_torch.configs import get_config
from repro_torch.core import spectral
from repro_torch.kernels import affinity
from repro_torch.kernels import nystrom as kn
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as T

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
@pytest.mark.parametrize("m", [512, 640, 4096])
@pytest.mark.parametrize("k", [8, 20])
def test_nystrom_extension_matches_plain_version(cuda_device, m, k):
    """B4 at the engine's landmark counts (640: not a multiple of its
    32-landmark chunks' pairs of blocks), k within and past 16: within
    1e-4 of the largest entry, masked rows exactly zero, a repeat call
    bit-identical."""
    x, z, g, mask, u, _, proj = _inputs(cuda_device, n=20000, m=m, d=8,
                                        k=k, seed=5)
    kn.reset_launch_counts()
    got = kn.nystrom_extension(x, z, g, u, proj, mask)
    again = kn.nystrom_extension(x, z, g, u, proj, mask)
    torch.cuda.synchronize()
    assert kn.LAUNCH_COUNTS["nystrom_extension"] == 2
    assert got.shape == (20000, k) and torch.equal(got, again)
    assert torch.all(got[mask == 0] == 0)
    want = ref.nystrom_extension_ref(x, z, g, u, proj, mask)
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, m, d", [(261, 65, 7), (100_000, 512, 8),
                                     (3001, 640, 20)])
def test_nystrom_colsum_repeat_call_is_bit_identical(cuda_device, dtype, n,
                                                     m, d):
    """B2 sums in one fixed order (256-row panels, rows ascending, panels
    in index order), at every tile precision."""
    x, z, g, mask, *_ = _inputs(cuda_device, n=n, m=m, d=d, seed=6)
    kw = dict(affinity_dtype=dtype)
    first = kn.nystrom_colsum(x, z, g, mask, **kw)
    assert torch.equal(kn.nystrom_colsum(x, z, g, mask, **kw), first)
    want = ref.nystrom_colsum_ref(x, z, g, mask, **kw)
    assert float((first - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n, m, d", [(37, 21, 7), (513, 640, 8),
                                     (1000, 4096, 8), (257, 100, 20)])
def test_cross_affinity_kernel_serves_b1_and_b6(cuda_device, n, m, d):
    """B1 and B6 launch one kernel (cross_tile_kernel): at f32 their
    outputs are equal bit for bit (the JAX docstring's "reproduces
    exactly"); each is within 1e-5 of its plain version (entries lie in
    [0, 1]) at every tile precision, and bit-identical on a repeat call.
    d = 20 runs the MAXD = 32 instance (2 columns a thread); at m = 21
    the rows of ``out`` are not 16-byte aligned, so the kernel takes its
    scalar stores."""
    x, y, g, *_ = _inputs(cuda_device, n=n, m=m, d=d, seed=7)
    plan = affinity.cross_tile_plan(n, m, d)
    assert plan.vec is (m % 4 == 0) and plan.cols == (4 if d <= 8 else 2)
    ops.reset_launch_counts()
    rbf = ops.rbf_cross_affinity(x, y, g)
    assert torch.equal(ops.rbf_cross_affinity(x, y, g), rbf)
    want = ref.rbf_cross_affinity_ref(x, y, g)
    assert float((rbf - want).abs().max()) <= 1e-5
    for dtype in DTYPES:
        got = kn.quantized_cross_affinity(x, y, g, affinity_dtype=dtype)
        assert torch.equal(kn.quantized_cross_affinity(
            x, y, g, affinity_dtype=dtype), got)
        if dtype == "f32":
            assert torch.equal(got, rbf)
        want = ref.quantized_cross_affinity_ref(x, y, g,
                                                affinity_dtype=dtype)
        assert got.shape == (n, m)
        assert float((got - want).abs().max()) <= 1e-5
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["rbf_cross_affinity"] == 2
    assert ops.LAUNCH_COUNTS["quantized_cross_affinity"] == 6


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


# square shapes of B7 and B8: the dense path's n = 2048 and the fed
# loop's 100 at d = 8, n % 4 != 0 (scalar stores), n = 1, n = 5 (a partial
# tile) and d = 20 (the MAXD = 32 instance)
SQUARE = [(2048, 8), (100, 8), (37, 7), (1, 8), (5, 8), (130, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", SQUARE)
def test_rbf_affinity_is_rbf_cross_affinity_with_a_zero_diagonal(
        cuda_device, n, d):
    """B8 launches B6's kernel with a zero-diagonal epilogue: off the
    diagonal the same entries bit for bit, on it exactly 0; a repeat call
    bit-identical."""
    x, *_ = _inputs(cuda_device, n=n, m=1, d=d, seed=8)
    ops.reset_launch_counts()
    got = ops.rbf_affinity(x, 0.37)
    assert torch.equal(ops.rbf_affinity(x, 0.37), got)
    want = ops.rbf_cross_affinity(x, x, 0.37).fill_diagonal_(0.0)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["rbf_affinity"] == 2
    assert got.shape == (n, n) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", SQUARE)
def test_pairwise_sq_dists_of_a_point_set_is_exactly_symmetric(cuda_device,
                                                               n, d):
    """B7 in the difference form: |x_i - x_i|^2 is exactly 0 and
    |x_i - x_j|^2 exactly |x_j - x_i|^2; a repeat call bit-identical."""
    x, *_ = _inputs(cuda_device, n=n, m=1, d=d, seed=9)
    got = ops.pairwise_sq_dists(x, x)
    assert torch.equal(ops.pairwise_sq_dists(x, x), got)
    assert torch.all(got.diagonal() == 0)
    assert torch.equal(got, got.T)


@pytest.mark.cuda
@pytest.mark.parametrize("n, m, d", [(1, 1, 8), (5, 5, 8), (5, 1, 7),
                                     (37, 37, 7), (37, 21, 20), (1, 130, 20),
                                     (130, 5, 8), (2049, 2047, 8)])
def test_square_kernels_at_ragged_edges_match_plain_versions(cuda_device, n,
                                                             m, d):
    """B7 and B8 where tiles and stores are ragged: n or m % 4 != 0
    (scalar stores), a single point, a partial tile, d = 20."""
    x, y, *_ = _inputs(cuda_device, n=n, m=m, d=d, seed=10)
    plan = affinity.cross_tile_plan(n, m, d)
    assert plan.vec is (m % 4 == 0)
    dist = ops.pairwise_sq_dists(x, y)
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    assert dist.shape == (n, m)
    assert float((dist - ref.pairwise_sq_dists_ref(x, y)).abs().max()) <= \
        1e-5 * scale
    square = ops.rbf_affinity(x, 0.37)
    assert square.shape == (n, n) and torch.all(square.diagonal() == 0)
    assert float((square - ref.rbf_affinity_ref(x, 0.37)).abs().max()) <= \
        1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m, p, r", [(40, 40, 5), (130, 70, 9),
                                     (4096, 4096, 8), (4096, 4096, 64),
                                     (300, 64, 100)])
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
    # the subspace solver's product does not depend on its block_rows
    for block_rows in (16, 256, 2048):
        if block_rows < m:
            assert torch.equal(
                eigensolver._blocked_matmul(w, q, block_rows,
                                            use_pallas=True), got)
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


@pytest.mark.cuda
@pytest.mark.parametrize("B, S, T_len, H, K, dh", [
    (2, 37, 1000, 16, 16, 64),    # a prompt against a long source
    (1, 300, 45, 4, 4, 32),       # Sq > T, reduced seamless's widths
    (4, 128, 1024, 16, 16, 64),   # seamless's cross-attention, full width
    (2, 24, 24, 4, 4, 32),        # reduced seamless's encoder
    (1, 1024, 1024, 16, 16, 64),  # seamless's encoder, full width
    # one rank of seamless served at (2, 2): 16/2 heads, 2 rows a replica
    (2, 1024, 1024, 8, 8, 64),    # the encoder
    (2, 128, 1024, 8, 8, 64),     # cross-attention against the frames
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_noncausal_cross_shapes(cuda_device, B, S, T_len, H,
                                                K, dh, dtype):
    """Non-causal, Sq != T: the encoder-decoder's encoder and
    cross-attention."""
    rng = np.random.default_rng(10)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype,
                            device=cuda_device)

    q, k, v = t(B, S, H, dh), t(B, T_len, K, dh), t(B, T_len, K, dh)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == (B, S, H, dh)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        w = want.float()
        limit = 2.0 ** -7 * w.abs() + 1e-3 * torch.sqrt(torch.mean(w * w))
        assert bool(((got.float() - w).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B, S, T_len, H, K, dh, causal, window", [
    (2, 33, 33, 4, 4, 32, True, None),       # ragged, G = 1
    (1, 50, 90, 7, 1, 64, True, None),       # T > S (a cache), G = 7
    (2, 70, 70, 8, 2, 128, False, None),     # non-causal
    (1, 97, 130, 4, 2, 64, True, 8),         # window 8
    (1, 2048, 2112, 28, 4, 128, True, None),  # qwen2-7b's prefill, 33 tiles
    (2, 65, 130, 8, 1, 128, True, None),     # MQA, G = 8
    (1, 45, 77, 8, 1, 256, True, None),      # gemma's heads, ragged
    (2, 70, 70, 8, 1, 256, False, None),     # dh 256, non-causal
    (1, 97, 130, 8, 1, 256, True, 8),        # dh 256, window 8
    (1, 2048, 2112, 8, 1, 256, True, None),  # gemma-2b's prefill
    # one rank's prompt under a serving mesh: llama4-scout at (1, 4)
    # (40/4 q heads over 8/4 KV heads, G = 5) and jamba-v0.1 at (2, 2)
    (4, 2048, 2048, 10, 2, 128, True, None),
    (2, 2048, 2048, 16, 4, 128, True, None),
    # seamless's decoder self-attention at (2, 2): the prompt's own K/V
    (2, 128, 128, 8, 8, 64, True, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(cuda_device, B, S, T_len, H,
                                               K, dh, causal, window,
                                               dtype):
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype,
                            device=cuda_device)

    q, k, v = t(B, S, H, dh), t(B, T_len, K, dh), t(B, T_len, K, dh)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == (B, S, H, dh)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        # summation order only
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        # both sides round an f32 result to bf16, so they may differ by
        # one unit in the last place (at most 2^-7 of the value); the
        # floor covers entries near zero
        w = want.float()
        diff = (got.float() - w).abs()
        limit = 2.0 ** -7 * w.abs() + 1e-3 * torch.sqrt(torch.mean(w * w))
        assert bool((diff <= limit).all()), float((diff / limit).max())


@pytest.mark.cuda
@pytest.mark.parametrize("B, S, T_len, H, K, dh, dv, causal, window, scale", [
    (1, 77, 100, 8, 8, 192, 128, True, None, 0.11),   # MLA widths, ragged
    (1, 512, 512, 16, 16, 192, 128, True, None, None),
    (2, 70, 70, 4, 2, 192, 128, False, None, 0.05),
    (2, 33, 50, 4, 4, 48, 32, True, 16, 0.3),         # the reduced MLA
    (2, 70, 70, 4, 2, 48, 32, False, None, 0.3),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_widths(cuda_device, B, S, T_len, H, K, dh, dv,
                                    causal, window, scale, dtype):
    """v narrower than q and k, and an explicit scale: out is (B, S, H,
    dv)."""
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype,
                            device=cuda_device)

    q, k, v = t(B, S, H, dh), t(B, T_len, K, dh), t(B, T_len, K, dv)
    kw = dict(causal=causal, window=window, scale=scale)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == (B, S, H, dv)
    want = ref.flash_attention_ref(q, k, v, **kw)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        w = want.float()
        limit = 2.0 ** -7 * w.abs() + 1e-3 * torch.sqrt(torch.mean(w * w))
        assert bool(((got.float() - w).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B, S, T_len, H, K, dh, dv, scale", [
    # deepseek-v3's MLA prefill: 128 heads over 128, q/k 128 + 64 RoPE
    (1, 2048, 2048, 128, 128, 192, 128, 1 / np.sqrt(192)),
    # internvl2-26b's prefill: 48 heads over 8, dh 128, a 2112-row cache
    (1, 2048, 2112, 48, 8, 128, 128, None),
    # one rank of deepseek-v3's MLA prefill served at (1, 4): 128/4 heads
    (4, 2048, 2048, 32, 32, 192, 128, 1 / np.sqrt(192)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_mla_and_vlm_prefill_shapes(
        cuda_device, B, S, T_len, H, K, dh, dv, scale, dtype):
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype,
                            device=cuda_device)

    q, k, v = t(B, S, H, dh), t(B, T_len, K, dh), t(B, T_len, K, dv)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == (B, S, H, dv)
    want = ref.flash_attention_ref(q, k, v, scale=scale)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        w = want.float()
        limit = 2.0 ** -7 * w.abs() + 1e-3 * torch.sqrt(torch.mean(w * w))
        assert bool(((got.float() - w).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_strided_inputs(cuda_device, dtype):
    rng = np.random.default_rng(5)
    qkv = torch.tensor(rng.normal(size=(1, 40, 3, 4, 32)), dtype=dtype,
                       device=cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # not contiguous
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        w = want.float()
        limit = 2.0 ** -7 * w.abs() + 1e-3 * torch.sqrt(torch.mean(w * w))
        assert bool(((got.float() - w).abs() <= limit).all())
    # (48, 48) is not one of the kernel's (dh, dv) pairs; the message
    # names them
    with pytest.raises(ValueError, match=r"\(dh, dv\) in .*\(192, 128\)"):
        ops.flash_attention(*(torch.zeros((1, 4, 2, 48), device=cuda_device)
                              for _ in range(3)))


@pytest.mark.cuda
def test_flash_attention_bf16_refuses_misaligned_rows(cuda_device):
    """The tensor-core body copies rows in 16-byte pieces."""
    ok = torch.zeros((1, 40, 4, 32), dtype=torch.bfloat16,
                     device=cuda_device)
    wide = torch.zeros((1, 40, 4, 36), dtype=torch.bfloat16,
                       device=cuda_device)
    with pytest.raises(ValueError, match="strides"):
        ops.flash_attention(wide[..., :32], ok, ok)     # head stride 36
    flat = torch.zeros(1 + 40 * 4 * 32, dtype=torch.bfloat16,
                       device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(ok, flat[1:].view(1, 40, 4, 32), ok)
    # the f32 body takes any strides
    wide32 = wide.float()
    got = ops.flash_attention(wide32[..., :32], ok.float(), ok.float())
    assert got.shape == (1, 40, 4, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("B, c, Q, H, G, P, N", [
    (2, 3, 8, 4, 2, 16, 16),         # the reduced shapes, G = 2
    (1, 2, 19, 2, 1, 16, 16),        # Q not a multiple of the tile
    (1, 2, 256, 4, 1, 64, 128),      # mamba2's chunk, four row tiles
    (1, 2, 256, 80, 1, 64, 128),     # mamba2's 80 heads in one group
    (1, 1, 256, 6, 1, 64, 128),      # the last head set is partial
    (1, 2, 256, 8, 2, 64, 128),      # two groups
    (1, 2, 256, 128, 1, 64, 16),     # jamba-v0.1's Mamba layer
    (2, 8, 256, 64, 1, 64, 16),      # one rank's half of it at (2, 2)
])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_matches_plain_version(cuda_device, B, c, Q, H, G, P, N,
                                         bc_dtype):
    rng = np.random.default_rng(6)

    def t(*shape, dtype=torch.float32):
        return torch.tensor(rng.normal(size=shape), dtype=dtype,
                            device=cuda_device)

    xdt = t(B, c, Q, H, P)
    cs = torch.cumsum(-t(B, c, Q, H).abs() * 0.1, dim=2)
    Bm, Cm = t(B, c, Q, G, N, dtype=bc_dtype), t(B, c, Q, G, N,
                                                  dtype=bc_dtype)
    ops.reset_launch_counts()
    y, st = ops.ssd_chunk(xdt, cs, Bm, Cm)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["ssd_chunk"] == 1
    y_r, st_r = ref.ssd_chunk_ref(xdt, cs, Bm, Cm)
    for got, want in ((y, y_r), (st, st_r)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
    y2, st2 = ops.ssd_chunk(xdt, cs, Bm, Cm)
    assert torch.equal(y2, y) and torch.equal(st2, st)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_nystrom_gram_matches_plain_version_past_a_tile(cuda_device, dtype):
    """m = 640 is not a multiple of the 128-wide tiles; ~10 % of the rows
    are masked.  Held to 1e-5 relative Frobenius, exactly symmetric
    before the rotation (an identity W^-1/2 leaves SᵀS itself)."""
    x, z, g, mask, u, wis, _ = _inputs(cuda_device, n=3001, m=640, d=8,
                                       seed=3)
    wis = wis / 640 ** 0.5
    kw = dict(affinity_dtype=dtype)
    kn.reset_launch_counts()
    got = kn.nystrom_gram(x, z, g, u, wis, mask, **kw)
    eye = torch.eye(640, device=cuda_device)
    gram = kn.nystrom_gram(x, z, g, u, eye, mask, **kw)
    torch.cuda.synchronize()
    assert kn.LAUNCH_COUNTS["nystrom_gram"] == 2
    want = ref.nystrom_gram_ref(x, z, g, u, wis, mask, **kw)
    err = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert err <= 1e-5
    assert torch.equal(gram, gram.T)


@pytest.mark.cuda
def test_nystrom_gram_repeat_call_is_bit_identical(cuda_device):
    x, z, g, mask, u, wis, _ = _inputs(cuda_device, n=20000, m=2048, d=8,
                                       seed=4)
    first = kn.nystrom_gram(x, z, g, u, wis, mask)
    assert torch.equal(kn.nystrom_gram(x, z, g, u, wis, mask), first)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-2.7b",
                                  "jamba-v0.1-52b", "moonshot-v1-16b-a3b",
                                  "deepseek-v3-671b", "internvl2-26b",
                                  "seamless-m4t-medium"])
def test_reduced_lm_prefill_on_the_card_matches_the_cpu(cuda_device, arch):
    """The reduced f32 LM with the kernels on: card logits = CPU logits;
    B9 launches once an attention or MLA layer, B10 once a Mamba layer
    (jamba has one of each, beside an MoE FFN)."""
    cfg = get_config(arch).reduced()
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 21)))
    out = {}
    with ops.use_pallas_scoped(True):
        for dev in ("cpu", cuda_device):
            caches = T.init_lm_cache(cfg, 1, 32, device=dev)
            ops.reset_launch_counts()
            logits, _ = T.lm_prefill(T.params_to(params, dev), cfg,
                                     {"tokens": toks.to(dev)}, caches)
            out[str(dev)] = logits.cpu()
            launches = dict(ops.LAUNCH_COUNTS)
    mixers = [mixer for mixer, _ in T.layer_types(cfg)]
    assert launches["flash_attention"] == mixers.count("attn") + \
        mixers.count("mla")
    assert launches["ssd_chunk"] == mixers.count("ssm")
    want = out["cpu"]
    err = float((out["cuda"] - want).abs().max() / want.abs().max())
    assert err <= 1e-4


@pytest.mark.cuda
def test_reduced_encdec_on_the_card_matches_the_cpu(cuda_device):
    """Reduced seamless-m4t-medium in f32 with the kernels on, through the
    step builders: encode, prefill and 4 greedy decode steps, card logits
    within 1e-4 of the CPU's and the same tokens; B9 launches once in
    every encoder layer, decoder self-attention and cross-attention of
    the prefill, never in a decode step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ED

    cfg = get_config("seamless-m4t-medium").reduced()
    shape = ShapeConfig("prefill_smoke", 32, 2, "prefill")
    params = ED.init_encdec(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    rng = np.random.default_rng(11)
    src = torch.tensor(rng.normal(size=(2, 24, cfg.d_model)),
                       dtype=torch.float32)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 13)))
    prefill = steps.make_prefill_step(cfg, shape)
    decode = steps.make_decode_step(cfg, shape)
    out = {}
    with ops.use_pallas_scoped(True):
        for dev in ("cpu", cuda_device):
            p = T.params_to(params, dev)
            memory = ED.encode(p, cfg, src.to(dev))
            ops.reset_launch_counts()
            logits, caches = prefill(p, {"src_embeds": src.to(dev),
                                         "tokens": toks.to(dev)})
            torch.cuda.synchronize()
            launches = [ops.LAUNCH_COUNTS["flash_attention"]]
            seq = [logits.cpu()]
            tok = logits.argmax(-1, keepdim=True)
            for i in range(4):
                ops.reset_launch_counts()
                logits, caches = decode(p, caches, tok, 13 + i)
                torch.cuda.synchronize()
                launches.append(ops.LAUNCH_COUNTS["flash_attention"])
                seq.append(logits.cpu())
                tok = logits.argmax(-1, keepdim=True)
            out[str(dev)] = (memory.cpu(), seq, launches)
    memory, seq, launches = out["cuda"]
    want_memory, want_seq, _ = out["cpu"]
    assert launches == [cfg.num_encoder_layers + 2 * cfg.num_layers] + \
        [0] * 4
    err = float((memory - want_memory).abs().max() / want_memory.abs().max())
    assert err <= 1e-4
    for got, want in zip(seq, want_seq):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
        assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
def test_background_warm_equals_inline_select_on_the_card(cuda_device):
    """The streaming server's solves run on its background solver's
    thread and launch the fused kernels there; each warmed partition is
    the one a second engine with the same seed gives when it solves the
    same snapshots inline on this thread, bit for bit."""
    import time

    from repro_torch.launch.serve import CohortServer
    from repro_torch.streaming import StreamingSpec

    n, d, k = 20000, 8, 5
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 6
    x = centers[rng.integers(0, k, n)] + rng.normal(
        size=(n, d)).astype(np.float32)
    cfg = CohortConfig(num_clusters=k, method="nystrom", use_pallas=True,
                       num_landmarks=128)
    server = CohortServer(n, d, seed=1, config=cfg, device=cuda_device,
                          streaming=StreamingSpec())
    ops.reset_launch_counts()
    warmed = []
    try:
        for step in range(2):
            table = x + np.float32(0.01 * step)
            server.update_embeddings(np.arange(n), table)
            deadline = time.monotonic() + 60
            while server.stats()["warm_ahead"] < step + 1:
                assert time.monotonic() < deadline, "no warm landed"
                assert server._solver.stats["errors"] == 0
                time.sleep(0.005)
            _, res = server.select_cohort(16)
            warmed.append((server.snapshot()[1], res))
        solver_launches = {
            name: sum(c[name] for t, c in ops.THREAD_LAUNCHES.items()
                      if t.startswith("repro-solver"))
            for name in FUSED}
        stats = server.stats()
    finally:
        server.close(timeout=60)
    assert not any(t.is_alive() for t in server._solver._threads)
    assert stats["forced_inline"] == 0 and stats["served_warm"] == 2
    assert server._solver.stats["errors"] == 0
    assert all(count >= 2 for count in solver_launches.values())
    assert [res.source for _, res in warmed] == ["cold", "warm"]
    inline = CohortEngine(cfg, seed=1, device=cuda_device)
    for table, res in warmed:
        again = inline.select(table)
        assert again.source == res.source
        np.testing.assert_array_equal(again.assign, res.assign)


@pytest.mark.cuda
def test_watchdog_herd_on_the_card(cuda_device):
    """``chip_smoke.py`` phase 17b's herd at a small N: every serving
    lock and the four kernel locks under the port's watchdog, 8 threads
    over 2 tenants; no lock-order violation, and B1-B4 launch from the
    background solver's thread and from the callers' threads."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_herd", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    tables = [cs.blobs(np.random.default_rng(seed), n=20000, k=5)[0]
              for seed in (3, 4)]
    got = cs.watchdog_herd(tables, k=5, m=128, rounds=3, deadline=120.0)
    assert got["violations"] == 0, got["violation_text"]
    assert got["threads_done"] == cs.HERD_THREADS
    solver, callers = cs._launch_split(got["by_thread"])
    assert all(solver[name] > 0 and callers[name] > 0 for name in FUSED), \
        (solver, callers)
    assert all(got["counter_acquisitions"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_four_way_on_one_card_matches_one_way(cuda_device, dtype):
    """The mesh route on (cuda:0,) * 4 at a row count that pads: B1 once,
    B2-B4 once a shard; the leading eigenvalues within 1e-4 of the 1-way
    solve's, the same partition, and a bit-identical re-solve."""
    from repro_torch.cohort import sharded_nystrom_from_landmarks
    from repro_torch.core.kmeans import kmeans

    n, d, k, m = 20003, 8, 5, 256
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 8
    x = torch.tensor(centers[rng.integers(0, k, n)] + rng.normal(
        size=(n, d)).astype(np.float32), device=cuda_device)
    idx = torch.tensor(rng.choice(n, m, replace=False), device=cuda_device)
    kw = dict(fused=True, use_pallas=True, affinity_dtype=dtype)
    runs = {}
    for shards in (1, 4, 4):
        ops.reset_launch_counts()
        runs.setdefault(shards, []).append(sharded_nystrom_from_landmarks(
            x, idx, k, 0.02, (cuda_device,) * shards, **kw))
        torch.cuda.synchronize()
        assert ops.LAUNCH_COUNTS["quantized_cross_affinity"] == 1
        assert all(ops.LAUNCH_COUNTS[name] == shards for name in FUSED[1:])
    (one,), (four, again) = runs[1], runs[4]
    assert all(torch.equal(a, b) for a, b in zip(four, again))
    assert float((four[1][:k] - one[1][:k]).abs().max()) <= 1e-4

    def partition(y):
        return kmeans(torch.Generator().manual_seed(0), y, k)[0].cpu()

    a, b = partition(four[0]), partition(one[0])
    # equal up to relabelling: the (a, b) label pairs map one to one
    pairs = torch.unique(a * k + b).numel()
    assert pairs == torch.unique(a).numel() == torch.unique(b).numel()


@pytest.mark.cuda
def test_kernels_refuse_a_differentiated_call(cuda_device):
    """B9 and B10 have no backward: on CUDA tensors a call that autograd
    records raises instead of cutting the graph; the same call under
    no_grad launches."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def t(*shape, grad=False):
        return torch.randn(shape, generator=g, device=cuda_device
                           ).requires_grad_(grad)

    q, k, v = t(1, 16, 2, 32, grad=True), t(1, 16, 2, 32), t(1, 16, 2, 32)
    xdt, cs = t(1, 2, 8, 2, 16, grad=True), -t(1, 2, 8, 2).abs().cumsum(2)
    bm, cm = t(1, 2, 8, 1, 16), t(1, 2, 8, 1, 16)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_chunk(xdt, cs, bm, cm)
    assert ops.LAUNCH_COUNTS["flash_attention"] == 0
    assert ops.LAUNCH_COUNTS["ssd_chunk"] == 0
    with torch.no_grad():
        ops.flash_attention(q, k, v)
        ops.ssd_chunk(xdt, cs, bm, cm)
    assert ops.LAUNCH_COUNTS["flash_attention"] == 1
    assert ops.LAUNCH_COUNTS["ssd_chunk"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch, kernel", [("gemma-2b", "flash_attention"),
                                          ("mamba2-2.7b", "ssd_chunk")])
def test_serving_after_a_train_step_launches_the_kernels(cuda_device, arch,
                                                         kernel):
    """A reduced f32 training step on the card with the kernels on
    launches none (the loss takes the plain path), and a prefill of the
    parameters it updated then launches B9 (attention) or B10 (SSD):
    the step leaves no parameter requiring grad.  Card against CPU
    training is phase 11 of the smoke run."""
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.tree import leaves

    cfg = get_config(arch).reduced()
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 17)), device=cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = T.params_to(T.init_lm(torch.Generator().manual_seed(0), cfg,
                                   device="cpu"), cuda_device)
    opt = optim.adamw(1e-3)
    step = steps.make_train_step(
        cfg, ShapeConfig("custom_train", 16, 2, "train", 2), opt)
    prefill = steps.make_prefill_step(
        cfg, ShapeConfig("prefill", 32, 2, "prefill"))
    with ops.use_pallas_scoped(True):
        ops.reset_launch_counts()
        params, _, m = step(params, opt.init(params), 0, batch)
        assert sum(ops.LAUNCH_COUNTS.values()) == 0
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        assert not any(p.requires_grad for p in leaves(params))
        logits, _ = prefill(params, {"tokens": batch["tokens"]})
    assert ops.LAUNCH_COUNTS[kernel] > 0
    assert not logits.requires_grad and torch.isfinite(logits).all()


def _mesh_train(cfg, dev, mesh, G, n_steps=3):
    """Reduced f32 AdamW steps on the card from the seed's parameters, on
    ``mesh`` (None: ``make_train_step`` without one): (params, opt_state,
    [metrics as floats])."""
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.sharding import shard_params

    rng = np.random.default_rng(4)
    opt = optim.adamw(1e-3)
    step = steps.make_train_step(
        cfg, ShapeConfig("custom_train", 16, 8, "train", G), opt, mesh=mesh)
    params = T.params_to(T.init_lm(torch.Generator().manual_seed(0), cfg,
                                   device="cpu"), dev)
    if mesh is not None:
        params = shard_params(params, mesh)
    state, ms = opt.init(params), []
    for i in range(n_steps):
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, (8, 17)),
                            device=dev)
        params, state, m = step(params, state, i,
                                {"tokens": toks[:, :-1],
                                 "labels": toks[:, 1:]})
        ms.append({k: float(v) for k, v in m.items()})
    return params, state, ms


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2])
def test_one_card_mesh_train_step_is_the_plain_step(cuda_device, G):
    """A one-device mesh on the card gives ``make_train_step``'s step bit
    for bit, metrics, parameters and moments (deterministic index
    accumulation; phase 12a of the smoke run)."""
    import warnings

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import leaves

    cfg = get_config("gemma-2b").reduced()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            p0, s0, m0 = _mesh_train(cfg, cuda_device, None, G)
            p1, s1, m1 = _mesh_train(
                cfg, cuda_device, make_test_mesh(1, 1, device=cuda_device), G)
    finally:
        torch.use_deterministic_algorithms(False)
    assert m0 == m1
    for a, b in ((p0, p1), (s0, s1)):
        for x, y in zip(leaves(a), leaves(b)):
            assert len(y.shards) == 1 and torch.equal(x, y.shards[0])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_mesh_train_step_on_one_card_matches_one_device(cuda_device, D):
    """(cuda:0,) * D against D = 1, reduced gemma-2b in f32 at G 2: the
    first loss within 1e-5, the first grad norm and every loss within
    1e-4, relative; replicated leaves identical on every device (phase
    12b of the smoke run)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import leaves

    cfg = get_config("gemma-2b").reduced()
    _, _, want = _mesh_train(cfg, cuda_device, None, 2)
    mesh = make_test_mesh(D, 1, devices=(cuda_device,) * D)
    params, state, got = _mesh_train(cfg, cuda_device, mesh, 2)
    assert abs(got[0]["loss"] - want[0]["loss"]) <= 1e-5 * want[0]["loss"]
    assert abs(got[0]["grad_norm"] - want[0]["grad_norm"]) <= \
        1e-4 * want[0]["grad_norm"]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * w["loss"]
    for x in leaves((params, state)):
        assert all(torch.equal(s, x.shards[d % x.parts])
                   for d, s in enumerate(x.shards))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"])
def test_tensor_parallel_train_step_on_one_card(cuda_device, arch):
    """(1, 2) on (cuda:0,) * 2 (tensor parallelism over two ranks)
    against the card's D = 1 step, reduced f32 at G 2: the first loss
    within 1e-5, the first grad norm and every loss within 1e-4,
    relative; a leaf copied to both ranks identical on each, and no
    kernel launched (phase 13a of the smoke run)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import leaves

    cfg = get_config(arch).reduced()
    _, _, want = _mesh_train(cfg, cuda_device, None, 2)
    mesh = make_test_mesh(1, 2, devices=(cuda_device,) * 2)
    ops.reset_launch_counts()
    with ops.use_pallas_scoped(True):
        params, state, got = _mesh_train(cfg, cuda_device, mesh, 2)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0
    assert abs(got[0]["loss"] - want[0]["loss"]) <= 1e-5 * want[0]["loss"]
    assert abs(got[0]["grad_norm"] - want[0]["grad_norm"]) <= \
        1e-4 * want[0]["grad_norm"]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * w["loss"]
    assert any(x.model_parts == 2 for x in leaves(params))
    for x in leaves((params, state)):
        assert all(torch.equal(s, x.shards[x.owner(d)])
                   for d, s in enumerate(x.shards))


def _moe_mesh_vs_one(dev, arch, mesh):
    """Reduced f32 ``arch`` on ``mesh`` against the card's D = 1 step at
    G 2, kernels on: the first loss and the first ``aux`` (the
    microbatches' global MoE metrics) within 1e-5, the first grad norm
    and every loss within 1e-4, relative; every chunk identical to its
    owner's; no kernel launched."""
    from repro_torch.kernels import ops
    from repro_torch.tree import leaves

    cfg = get_config(arch).reduced()
    _, _, want = _mesh_train(cfg, dev, None, 2)
    ops.reset_launch_counts()
    with ops.use_pallas_scoped(True):
        params, state, got = _mesh_train(cfg, dev, mesh, 2)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0
    assert abs(got[0]["loss"] - want[0]["loss"]) <= 1e-5 * want[0]["loss"]
    assert abs(got[0]["grad_norm"] - want[0]["grad_norm"]) <= \
        1e-4 * want[0]["grad_norm"]
    assert abs(got[0]["aux"] - want[0]["aux"]) <= 1e-5 * want[0]["aux"]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * w["loss"]
    assert any(x.expert for x in leaves(params))
    for x in leaves((params, state)):
        assert all(torch.equal(s.to(x.shards[x.owner(d)].device),
                               x.shards[x.owner(d)])
                   for d, s in enumerate(x.shards))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-v0.1-52b",
                                  "llama4-scout-17b-a16e",
                                  "moonshot-v1-16b-a3b"])
def test_moe_mesh_train_step_on_one_card(cuda_device, arch):
    """The MoE families at (2, 2) on (cuda:0,) * 4 (global route, experts
    over the two replicas, expert ff over two ranks) against D = 1
    (phase 14a of the smoke run)."""
    from repro_torch.launch.mesh import make_test_mesh

    _moe_mesh_vs_one(cuda_device, arch,
                     make_test_mesh(2, 2, devices=(cuda_device,) * 4))


@pytest.mark.cuda
def test_moe_mesh_train_step_over_four_cards(cuda_device):
    """Reduced moonshot at (4, 1) over cuda:0-3, one expert a card,
    against D = 1 on cuda:0 (phase 14b of the smoke run)."""
    from repro_torch.launch.mesh import make_test_mesh

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards, {torch.cuda.device_count()} visible")
    _moe_mesh_vs_one(cuda_device, "moonshot-v1-16b-a3b",
                     make_test_mesh(4, 1, device="cuda:0"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama4-scout-17b-a16e"])
def test_mesh_serving_on_one_card(cuda_device, arch):
    """``build_step``'s prefill and decode over a (1, 2) mesh on
    (cuda:0,) * 2, reduced f32, against the one-device steps on the
    card: the logits within 1e-4 of their largest entry, the same greedy
    tokens, and B9 (and B10) launched by each rank of every attention
    (and Mamba) layer's prefill, none in a decode step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import shard_params

    cfg = get_config(arch).reduced()
    params = T.init_lm(torch.Generator(device=cuda_device).manual_seed(0),
                       cfg, device=cuda_device)
    B, S = 2, 64
    prefill_shape = ShapeConfig("prefill", S, B, "prefill")
    decode_shape = ShapeConfig("decode", S, B, "decode")
    tokens = torch.randint(0, cfg.vocab_size, (B, 16),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(cuda_device)}
    pos = torch.tensor([16, 40], device=cuda_device)
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    n_ssm = cfg.num_layers - n_attn
    mesh = make_test_mesh(1, 2, devices=(cuda_device,) * 2)
    sharded = shard_params(params, mesh)
    runs = []
    with ops.use_pallas_scoped(True):
        for prefill, decode, p in (
                (steps.make_prefill_step(cfg, prefill_shape),
                 steps.make_decode_step(cfg, decode_shape), params),
                (steps.build_step(cfg, prefill_shape, mesh).fn,
                 steps.build_step(cfg, decode_shape, mesh).fn, sharded)):
            ops.reset_launch_counts()
            logits, caches = prefill(p, batch)
            torch.cuda.synchronize()
            counts = dict(ops.LAUNCH_COUNTS)
            out = [logits]
            for i in range(3):
                logits, caches = decode(p, caches,
                                        logits.argmax(-1, keepdim=True),
                                        pos + i)
                out.append(logits)
            torch.cuda.synchronize()
            assert ops.LAUNCH_COUNTS == counts, "a decode step launched"
            runs.append((out, counts))
    (want, one), (got, two) = runs
    assert one["flash_attention"] == n_attn
    assert two["flash_attention"] == 2 * n_attn
    assert (one["ssd_chunk"], two["ssd_chunk"]) == (n_ssm, 2 * n_ssm)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
        assert torch.equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "seamless-m4t-medium"])
def test_mla_and_encdec_serve_over_a_mesh_on_one_card(cuda_device, arch):
    """Reduced f32 deepseek-v3 (MLA) and seamless-m4t-medium (the
    encoder-decoder) served by ``build_step`` over (1, 2) on (cuda:0,)
    * 2, kernels on, against the card's one-device steps: the logits
    within 1e-4 of the largest, the same greedy tokens, B9 launched per
    rank in every attention of the prefill and never in a decode
    step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import encdec as ED
    from repro_torch.models.sharding import shard_params

    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    init = ED.init_encdec if cfg.is_encoder_decoder else T.init_lm
    params = init(gen, cfg, device=cuda_device)
    B, S, MAX = 2, 8, 32
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     device=cuda_device, generator=gen)}
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = torch.randn(B, cfg.encoder_seq_len,
                                          cfg.d_model, device=cuda_device,
                                          generator=gen)
        per_rank = cfg.num_encoder_layers + 2 * cfg.num_layers
        pos = [S + i for i in range(3)]
    else:
        per_rank = cfg.num_layers
        pos = [torch.tensor([S + i, 13 + i], device=cuda_device)
               for i in range(3)]
    pre_shape = ShapeConfig("prefill", MAX, B, "prefill")
    dec_shape = ShapeConfig("decode", MAX, B, "decode")
    mesh = make_test_mesh(1, 2, devices=(cuda_device,) * 2)
    runs = []
    with ops.use_pallas_scoped(True):
        for prefill, decode, p in (
                (steps.make_prefill_step(cfg, pre_shape),
                 steps.make_decode_step(cfg, dec_shape), params),
                (steps.build_step(cfg, pre_shape, mesh).fn,
                 steps.build_step(cfg, dec_shape, mesh).fn,
                 shard_params(params, mesh))):
            ops.reset_launch_counts()
            logits, caches = prefill(p, batch)
            launches = ops.LAUNCH_COUNTS["flash_attention"]
            out = [logits]
            for at in pos:
                logits, caches = decode(p, caches,
                                        out[-1].argmax(-1, keepdim=True), at)
                out.append(logits)
            torch.cuda.synchronize()
            assert ops.LAUNCH_COUNTS["flash_attention"] == launches
            runs.append((out, launches))
    (want, one), (got, two) = runs
    assert (one, two) == (per_rank, 2 * per_rank)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-4
        assert torch.equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.cuda
def test_fake_cuda_tensors_take_only_the_shape_routes(cuda_device):
    """Fake tensors on the card (the dry run's, ``FakeTensorMode``): B9
    and B10 answer with empty outputs of their shapes and count their
    closed-form work, launching nothing; every other wrapper raises
    before it could hand a fake pointer to a kernel.  A real CUDA call
    after them still launches its kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention import flash_work
    from repro_torch.roofline.counting import StepCounter

    ops.reset_launch_counts()
    card = torch.device("cuda", torch.cuda.current_device())
    counter = StepCounter([card])
    with FakeTensorMode(), counter:
        q = torch.empty(1, 64, 4, 128, dtype=torch.bfloat16,
                        device=cuda_device)
        k = torch.empty(1, 64, 2, 128, dtype=torch.bfloat16,
                        device=cuda_device)
        out = ops.flash_attention(q, k, k)
        _, st = ops.ssd_chunk(torch.empty(1, 2, 16, 4, 64, device=cuda_device),
                              torch.empty(1, 2, 16, 4, device=cuda_device),
                              torch.empty(1, 2, 16, 1, 16, device=cuda_device),
                              torch.empty(1, 2, 16, 1, 16, device=cuda_device))
        x = torch.empty(8, 4, device=cuda_device)
        for call in (lambda: ops.pairwise_sq_dists(x, x),
                     lambda: ops.rbf_cross_affinity(x, x, 0.5),
                     lambda: ops.panel_matmul(x, x)):
            with pytest.raises(ValueError, match="fake"):
                call()
    assert tuple(out.shape) == (1, 64, 4, 128) and tuple(st.shape) == (
        1, 2, 4, 64, 16)
    assert counter.kernels == {"flash_attention": 1, "ssd_chunk": 1}
    assert counter.flops[0] >= flash_work(1, 64, 64, 4, 2, 128, 128)[0]
    assert sum(ops.LAUNCH_COUNTS.values()) == 0
    q = torch.randn(1, 64, 4, 128, device=cuda_device, dtype=torch.bfloat16)
    k = torch.randn(1, 64, 2, 128, device=cuda_device, dtype=torch.bfloat16)
    ops.flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["flash_attention"] == 1
