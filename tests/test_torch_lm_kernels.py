"""The port's LM kernel wrappers (B9 flash attention, B10 SSD chunk) against
the JAX package.

On the CPU each wrapper runs its plain PyTorch version, so these tests
hold those plain versions to the JAX oracles (``repro.kernels.ref``) and
to the Pallas kernels themselves in interpret mode
(``repro.kernels.ops``), on the same numpy inputs, at the shapes of the
JAX package's own kernel tests (``tests/test_kernels.py``).  Tolerances:
f32 to 1e-5 of the largest entry (summation order only); bf16 to 2e-2
(the output's own rounding).  The CUDA kernels are held to the plain
versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention_pallas import flash_attention_pallas
from repro.kernels.ssd_pallas import ssd_chunk_pallas
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as kssd

F32_REL = 1e-5
BF16_REL = 2e-2


def _close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _qkv(B, S, T, H, K, dh, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, dh)).astype(np.float32),
            rng.normal(size=(B, T, K, dh)).astype(np.float32),
            rng.normal(size=(B, T, K, dh if dv is None else dv)).astype(
                np.float32))


@pytest.mark.parametrize("S,H,K,dh", [(33, 4, 4, 16), (64, 8, 2, 32),
                                      (50, 4, 1, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(S, H, K, dh, causal):
    q, k, v = _qkv(2, S, S, H, K, dh)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    assert got.dtype == torch.float32
    _close(got, jax_ref.flash_attention_ref(q, k, v, causal=causal),
           F32_REL)
    kern = jax_ops.flash_attention(q, k, v, causal=causal, block_q=16,
                                   block_k=16)
    _close(got, kern, F32_REL)


@pytest.mark.parametrize("window", [None, 8])
def test_flash_attention_against_a_longer_cache(window):
    """T > S, as a prefill reads the whole max_seq cache."""
    q, k, v = _qkv(1, 21, 40, 4, 2, 16, seed=1)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window)
    _close(got, jax_ref.flash_attention_ref(q, k, v, window=window), F32_REL)
    _close(got, jax_ops.flash_attention(q, k, v, window=window, block_q=16,
                                        block_k=16), F32_REL)


def test_flash_attention_window():
    q, k, v = _qkv(1, 48, 48, 2, 2, 16, seed=2)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), window=8)
    _close(got, jax_ops.flash_attention(q, k, v, window=8, block_q=16,
                                        block_k=16), F32_REL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_head_dim_256_mqa(causal):
    """gemma-2b's attention: head_dim 256, 8 query heads over one KV head,
    against the Pallas kernel itself in interpret mode."""
    q, k, v = _qkv(1, 24, 24, 8, 1, 256, seed=4)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    want = flash_attention_pallas(q, k, v, causal=causal, block_q=8,
                                  block_k=8, interpret=True)
    _close(got, want, F32_REL)
    _close(got, jax_ref.flash_attention_ref(q, k, v, causal=causal),
           F32_REL)


@pytest.mark.parametrize("dh, dv", [(16, 16), (48, 32)])
@pytest.mark.parametrize("window", [None, 8])
def test_flash_attention_explicit_scale_and_v_width(dh, dv, window):
    """``scale=`` other than 1/sqrt(dh), and v narrower than q and k (the
    reduced deepseek-v3 MLA's 48 against 32), against the Pallas kernel
    in interpret mode: (B, S, H, dv) out."""
    q, k, v = _qkv(2, 37, 37, 4, 2, dh, seed=5, dv=dv)
    scale = 0.3
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window, scale=scale)
    assert got.shape == (2, 37, 4, dv)
    want = flash_attention_pallas(q, k, v, window=window, scale=scale,
                                  block_q=16, block_k=16, interpret=True)
    _close(got, want, F32_REL)
    _close(got, jax_ref.flash_attention_ref(q, k, v, window=window,
                                            scale=scale), F32_REL)
    # the scale reaches the scores: the default 1/sqrt(dh) gives another
    # output
    default = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  window=window)
    assert float((default - got).abs().max()) > 1e-3


def test_flash_attention_pairs_include_mla():
    """The CUDA kernel's (dh, dv) pairs: the square widths, deepseek-v3's
    MLA prefill (192 against 128) and its reduced config's (48, 32)."""
    assert set(kfa.HEAD_DIMS) == {(32, 32), (64, 64), (128, 128),
                                  (256, 256), (192, 128), (48, 32)}
    from repro_torch.configs import get_config
    for cfg in (get_config("deepseek-v3-671b"),
                get_config("deepseek-v3-671b").reduced()):
        mla = cfg.mla
        pair = (mla.qk_nope_head_dim + mla.qk_rope_head_dim, mla.v_head_dim)
        assert pair in kfa.HEAD_DIMS


def test_flash_attention_bf16():
    q, k, v = _qkv(1, 32, 32, 2, 2, 16, seed=3)
    got = ops.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_ops.flash_attention(jq, jk, jv, block_q=16, block_k=16)
    assert want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want, np.float32), BF16_REL)


def test_flash_attention_refuses_bad_shapes():
    q = torch.zeros((1, 4, 3, 16))
    kv = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="heads"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(kv, kv, kv, window=0)
    with pytest.raises(TypeError):
        ops.flash_attention(kv.double(), kv, kv)


def _ssd_inputs(B, c, Q, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(B, c, Q, H, P)).astype(np.float32)
    cs = np.cumsum(-np.abs(rng.normal(size=(B, c, Q, H))), axis=2).astype(
        np.float32)
    Bm = rng.normal(size=(B, c, Q, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, c, Q, G, N)).astype(np.float32)
    return xdt, cs, Bm, Cm


@pytest.mark.parametrize("Q,H,P,G,N", [(8, 2, 8, 1, 8), (16, 4, 8, 2, 12),
                                       (32, 8, 16, 1, 16)])
def test_ssd_chunk_matches_jax(Q, H, P, G, N):
    args = _ssd_inputs(2, 3, Q, H, P, G, N)
    y, st = ops.ssd_chunk(*map(torch.from_numpy, args))
    assert y.dtype == st.dtype == torch.float32
    y_r, st_r = jax_ref.ssd_chunk_ref(*args)
    y_k, st_k = jax_ops.ssd_chunk(*args)
    for got, oracle, kern in ((y, y_r, y_k), (st, st_r, st_k)):
        _close(got, oracle, F32_REL)
        _close(got, kern, F32_REL)


@pytest.mark.parametrize("Q", [8, 19])
def test_ssd_chunk_jamba_shape_matches_pallas(Q):
    """(P, N) = (64, 16), jamba-v0.1's Mamba layers, against the Pallas
    kernel in interpret mode."""
    args = _ssd_inputs(1, 2, Q, 4, 64, 1, 16, seed=3)
    assert (64, 16) in kssd.SHAPES
    from repro_torch.configs import get_config
    ssm = get_config("jamba-v0.1-52b").ssm
    assert (ssm.head_dim, ssm.d_state) == (64, 16)
    y, st = ops.ssd_chunk(*map(torch.from_numpy, args))
    y_k, st_k = ssd_chunk_pallas(*args, interpret=True)
    _close(y, y_k, F32_REL)
    _close(st, st_k, F32_REL)


def test_ssd_chunk_bf16_projections():
    """B and C in bf16, as a bf16 mamba2 prefill hands them over."""
    xdt, cs, Bm, Cm = _ssd_inputs(1, 2, 16, 4, 16, 1, 16, seed=1)
    y, st = ops.ssd_chunk(torch.from_numpy(xdt), torch.from_numpy(cs),
                          torch.from_numpy(Bm).to(torch.bfloat16),
                          torch.from_numpy(Cm).to(torch.bfloat16))
    y_r, st_r = jax_ref.ssd_chunk_ref(xdt, cs, jnp.asarray(Bm, jnp.bfloat16),
                                      jnp.asarray(Cm, jnp.bfloat16))
    _close(y, y_r, F32_REL)
    _close(st, st_r, F32_REL)


def test_ssd_chunk_masks_before_the_exp():
    """A steep cumulative decay overflows exp above the diagonal; the
    masked form keeps every output finite."""
    xdt, cs, Bm, Cm = _ssd_inputs(1, 1, 8, 2, 8, 1, 8, seed=2)
    cs = cs * 200.0
    y, st = ref.ssd_chunk_ref(*map(torch.from_numpy, (xdt, cs, Bm, Cm)))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_r, _ = jax_ref.ssd_chunk_ref(xdt, cs, Bm, Cm)
    _close(y, y_r, F32_REL)


def test_ssd_chunk_refuses_mismatched_shapes():
    xdt, cs, Bm, Cm = map(torch.from_numpy, _ssd_inputs(1, 2, 8, 4, 8, 2, 8))
    with pytest.raises(ValueError, match="do not match"):
        ops.ssd_chunk(xdt, cs[:, :1], Bm, Cm)
    with pytest.raises(ValueError, match="do not match"):
        ops.ssd_chunk(xdt, cs, Bm, Cm[..., :4])


def test_lm_kernels_launch_nothing_on_the_cpu():
    ops.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 2, 1, 16))
    ops.flash_attention(q, k, v)
    ops.ssd_chunk(*map(torch.from_numpy, _ssd_inputs(1, 1, 8, 2, 8, 1, 8)))
    assert ops.LAUNCH_COUNTS["flash_attention"] == 0
    assert ops.LAUNCH_COUNTS["ssd_chunk"] == 0
