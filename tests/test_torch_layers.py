"""``models/layers.py::layernorm_init`` and ``layernorm`` of the port
against the JAX package's: the initial parameters, and the output on
the same inputs (made from a seed with numpy) in float32 and bfloat16,
with a random scale and bias."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_init_matches_jax(dtype):
    want = JL.layernorm_init(48, dtype=dtype)
    got = L.layernorm_init(48, dtype=dtype, device="cpu")
    assert set(got) == set(want) == {"scale", "bias"}
    for k in want:
        assert got[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-6),
                                        ("bfloat16", 2.0 ** -7)])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layernorm_matches_jax(dtype, tol, eps):
    """The same inputs through both: within ``tol`` of the largest entry
    (bf16: one unit in the last place of the output's dtype)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 3 + 5).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = JL.layernorm({"scale": jnp.asarray(scale, jdt),
                         "bias": jnp.asarray(bias, jdt)},
                        jnp.asarray(x, jdt), eps)
    tdt = getattr(torch, dtype)
    got = L.layernorm({"scale": torch.from_numpy(scale).to(tdt),
                       "bias": torch.from_numpy(bias).to(tdt)},
                      torch.from_numpy(x).to(tdt), eps)
    assert got.dtype == tdt and got.shape == x.shape
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_layernorm_zero_mean_unit_var():
    """``tests/test_layers.py``'s property, on the port."""
    p = L.layernorm_init(64, dtype="float32", device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 64)).astype(np.float32)) * 3 + 5
    y = L.layernorm(p, x)
    assert torch.allclose(y.mean(-1), torch.zeros(4), atol=1e-4)
    assert torch.allclose(y.var(-1, unbiased=False), torch.ones(4),
                          atol=1e-2)
