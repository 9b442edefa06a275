"""The port's fused Nyström kernel wrappers against the JAX package.

On the CPU every wrapper in ``repro_torch.kernels.nystrom`` runs its
plain PyTorch version, so these tests hold those plain versions to the
JAX kernels (``repro.kernels.ops``, Pallas in interpret mode here) on
the same numpy inputs, at the tolerances of the JAX package's own
kernel-vs-oracle test (``test_fused_nystrom.py``).  The CUDA kernels
themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import _build, nystrom as kn, ops, ref

DTYPES = ("f32", "bf16", "int8")
# (rtol, atol) of test_fused_passes_match_oracles
TOL = {"colsum": (2e-5, 2e-4), "gram": (2e-4, 2e-3),
       "extension": (2e-4, 2e-4), "cross": (2e-5, 2e-4)}


def _fixture(n=261, m=65, d=7, k=5, seed=0):
    """Ragged shapes and ~10 % masked rows, as in test_fused_nystrom."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(n, d)).astype(np.float32),
        z=rng.normal(size=(m, d)).astype(np.float32),
        gamma=0.37,
        mask=(rng.random(n) > 0.1).astype(np.float32),
        u=(rng.normal(size=(m,)) ** 2 + 0.1).astype(np.float32),
        wis=rng.normal(size=(m, m)).astype(np.float32),
        proj=rng.normal(size=(m, k)).astype(np.float32))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _run(op, f, dtype, mask, lib):
    """One op on the fixture through ``lib`` (port ops or JAX ops)."""
    conv = _t if lib is ops else (lambda a: a)
    x, z, u, wis, proj = (conv(f[key]) for key in ("x", "z", "u", "wis",
                                                     "proj"))
    m = conv(mask)
    g, kw = f["gamma"], dict(affinity_dtype=dtype)
    if op == "colsum":
        out = lib.nystrom_colsum(x, z, g, m, **kw)
    elif op == "gram":
        out = lib.nystrom_gram(x, z, g, u, wis, m, **kw)
    elif op == "extension":
        out = lib.nystrom_extension(x, z, g, u, proj, m, **kw)
    else:
        out = lib.quantized_cross_affinity(x, z, g, **kw)
    return np.asarray(out)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["colsum", "gram", "extension", "cross"])
def test_plain_versions_match_jax_kernels(op, dtype, masked):
    f = _fixture()
    mask = f["mask"] if masked else None
    got = _run(op, f, dtype, mask, ops)
    want = _run(op, f, dtype, mask, jax_ops)
    rtol, atol = TOL[op]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantized_points_match_jax(dtype):
    from repro.kernels import ref as jax_ref
    a = np.random.default_rng(1).normal(size=(40, 9)).astype(np.float32) * 3
    a[3] = 0.0                        # an all-zero row hits the scale floor
    np.testing.assert_array_equal(
        ref._quantized_points_ref(torch.from_numpy(a), dtype).numpy(),
        np.asarray(jax_ref._quantized_points_ref(a, dtype)))


def test_extension_rows_unit_norm_masked_rows_zero():
    f = _fixture()
    v = _run("extension", f, "f32", f["mask"], ops)
    live = f["mask"] > 0
    np.testing.assert_allclose(np.linalg.norm(v[live], axis=1), 1.0,
                               atol=1e-5)
    assert np.abs(v[~live]).max() == 0.0


def test_cpu_tensors_run_plain_versions_without_counting():
    f = _fixture()
    kn.reset_launch_counts()
    x, z = _t(f["x"]), _t(f["z"])
    np.testing.assert_array_equal(
        kn.nystrom_colsum(x, z, 0.37).numpy(),
        ref.nystrom_colsum_ref(x, z, 0.37).numpy())
    assert all(v == 0 for v in kn.LAUNCH_COUNTS.values())


@pytest.mark.parametrize("bad, match", [
    (dict(x=np.zeros((5, 3), np.float64)), "float32"),
    (dict(z=np.zeros((4, 2), np.float32)), "must be"),
    (dict(mask=np.ones(4, np.float32)), "mask must have shape"),
    (dict(affinity_dtype="fp8"), "affinity_dtype"),
])
def test_wrappers_validate_inputs(bad, match):
    args = dict(x=np.zeros((5, 3), np.float32), z=np.zeros((4, 3),
                                                           np.float32),
                mask=None, affinity_dtype="f32")
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        kn.nystrom_colsum(_t(args["x"]), _t(args["z"]), 0.5,
                          _t(args["mask"]),
                          affinity_dtype=args["affinity_dtype"])


def test_use_pallas_toggle_scoped_restores():
    ops.set_use_pallas(False)
    with ops.use_pallas_scoped(True):
        assert ops.use_pallas()
        with ops.use_pallas_scoped(False):
            assert not ops.use_pallas()
        assert ops.use_pallas()
    assert not ops.use_pallas()


def test_build_is_keyed_by_the_sources_and_targets_sm90a(monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.pathlib.Path, "is_file", lambda self: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_failure_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    """A refused build raises with the compiler's own message."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="bad kernel"):
        _build._compile()
