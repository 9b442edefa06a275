"""The port's Mamba-2 mixer against the JAX package's, toggle off and on.

Same numpy inputs and converted ``mamba_init`` weights in both packages.
With ``use_pallas`` on, the port's ``_ssd_chunked`` takes the intra-chunk
half of every chunk from one ``ops.ssd_chunk`` call (on the CPU, its
plain version) and runs the inter-chunk recurrence itself; the JAX
``_ssd_chunked`` (the plain chunk scan) is the oracle for both.  Covered:
ragged S (the zero-dt padding), an initial state h0, prefill,
continuation and single-token decode.  f32 to 1e-5 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.models import mamba as JM
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models import mamba as PM

REL = 1e-5


def _cfgs(chunk=8, state=16, head_dim=16, groups=1):
    kw = dict(name="m", arch_type="ssm", num_layers=1, d_model=32,
              num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
              vocab_size=64, attn_period=0, param_dtype="float32",
              compute_dtype="float32")
    ssm = dict(d_state=state, head_dim=head_dim, num_groups=groups,
               conv_width=4, chunk_size=chunk, expand=2)
    return (JaxModelConfig(ssm=JaxSSMConfig(**ssm), **kw),
            ModelConfig(ssm=SSMConfig(**ssm), **kw))


def _close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _ssd_inputs(b, S, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(b, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(b, S, G, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("S", [8, 16, 19, 5])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(S, use_pallas, with_h0):
    jcfg, pcfg = _cfgs(groups=2)
    b, H, P, G, N = 2, 4, 16, 2, 16
    args = _ssd_inputs(b, S, H, P, G, N)
    h0 = None
    if with_h0:
        h0 = np.random.default_rng(1).normal(
            size=(b, G, H // G, P, N)).astype(np.float32)
    y_j, h_j = JM._ssd_chunked(*map(jnp.asarray, args), jcfg,
                               None if h0 is None else jnp.asarray(h0))
    with ops.use_pallas_scoped(use_pallas):
        y_p, h_p = PM._ssd_chunked(*map(torch.from_numpy, args), pcfg,
                                   None if h0 is None else
                                   torch.from_numpy(h0))
    _close(y_p, y_j)
    _close(h_p, h_j)


def test_ssd_chunked_calls_the_kernel_once_per_prompt():
    _, pcfg = _cfgs()
    args = map(torch.from_numpy, _ssd_inputs(1, 27, 4, 16, 1, 16))
    calls = []
    real = ops.ssd_chunk

    def spy(xdt, *rest):
        calls.append(tuple(xdt.shape))
        return real(xdt, *rest)

    ops.ssd_chunk = spy
    try:
        with ops.use_pallas_scoped(True):
            PM._ssd_chunked(*args, pcfg, None)
    finally:
        ops.ssd_chunk = real
    assert calls == [(1, 4, 8, 4, 16)]      # ⌈27/8⌉ chunks in one call


def _params(jcfg):
    jp = JM.mamba_init(jax.random.PRNGKey(0), jcfg)
    pp = {}
    for k, v in jp.items():
        pp[k] = ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(np.array(v)))
    return jp, pp


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba_prefill_continuation_and_decode_match_jax(use_pallas):
    jcfg, pcfg = _cfgs(chunk=4)
    jp, pp = _params(jcfg)
    x = np.random.default_rng(2).normal(size=(2, 14, 32)).astype(np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    with ops.use_pallas_scoped(use_pallas):
        # full prompt, no cache
        want, _ = JM.mamba_apply(jp, jx, jcfg)
        got, cache = PM.mamba_apply(pp, px, pcfg)
        assert cache is None
        _close(got, want)
        # prefill 9 tokens into a cache, continue with 4, decode 1
        jc = JM.init_mamba_cache(jcfg, 2, jnp.float32)
        pc = PM.init_mamba_cache(pcfg, 2, torch.float32)
        for lo, hi in ((0, 9), (9, 13), (13, 14)):
            want, jc = JM.mamba_apply(jp, jx[:, lo:hi], jcfg, cache=jc)
            got, pc = PM.mamba_apply(pp, px[:, lo:hi], pcfg, cache=pc)
            _close(got, want)
            _close(pc["conv"], jc["conv"])
            _close(pc["ssm"], jc["ssm"])


def test_short_continuation_keeps_the_conv_tail():
    """A continuation shorter than the conv window shifts the old tail."""
    jcfg, pcfg = _cfgs(chunk=4)
    jp, pp = _params(jcfg)
    x = np.random.default_rng(3).normal(size=(1, 7, 32)).astype(np.float32)
    jc = JM.init_mamba_cache(jcfg, 1, jnp.float32)
    pc = PM.init_mamba_cache(pcfg, 1, torch.float32)
    for lo, hi in ((0, 5), (5, 7)):
        want, jc = JM.mamba_apply(jp, jnp.asarray(x[:, lo:hi]), jcfg,
                                  cache=jc)
        got, pc = PM.mamba_apply(pp, torch.from_numpy(x[:, lo:hi]), pcfg,
                                 cache=pc)
        _close(got, want)
    _close(pc["conv"], jc["conv"])


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    u = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    _close(PM._causal_conv(*map(torch.from_numpy, (u, w, b))),
           JM._causal_conv(*map(jnp.asarray, (u, w, b))))
