"""The port's attention module against the JAX package's, toggle off and on.

Both modules get the same weights (the JAX ``attn_init`` draw, converted)
and the same numpy inputs.  Covered: full causal attention, a prefill
into a cache, per-row decode, the windowed decode slice and the blocked
long-prompt path, and cross-attention through ``memory=``
(``tests/test_torch_encdec.py`` holds both cross routes).  With
``use_pallas`` on, the port's prompt attention
runs the flash-attention wrapper (on the CPU, its plain version); the
JAX module has no kernel route, so it is the oracle for both.  f32 to
1e-5 of the largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as PA

REL = 1e-5
ARCHS = ("qwen2-7b", "qwen3-14b")     # QKV bias; qk-norm


def _close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _setup(arch, seed=0, **overrides):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **overrides)
    pcfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    jp = JA.attn_init(jax.random.PRNGKey(seed), jcfg)
    pp = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in jp.items()}
    return jcfg, pcfg, jp, pp


def _x(B, S, d, seed=1):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("window", [None, 5])
def test_full_causal_attention(arch, use_pallas, window):
    jcfg, pcfg, jp, pp = _setup(arch)
    x = _x(2, 13, jcfg.d_model)
    want, _ = JA.attention(jp, jnp.asarray(x), jcfg, positions=jnp.arange(13),
                           window=window)
    with ops.use_pallas_scoped(use_pallas):
        got, cache = PA.attention(pp, torch.from_numpy(x), pcfg,
                                  positions=torch.arange(13), window=window)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_into_cache_then_per_row_decode(use_pallas):
    jcfg, pcfg, jp, pp = _setup("qwen2-7b")
    B, S, T = 2, 9, 16
    x = _x(B, S, jcfg.d_model)
    jc = JA.init_kv_cache(jcfg, B, T, jnp.float32)
    want, jc = JA.attention(jp, jnp.asarray(x), jcfg,
                            positions=jnp.arange(S), cache=jc, cache_pos=0)
    with ops.use_pallas_scoped(use_pallas):
        pc = PA.init_kv_cache(pcfg, B, T, torch.float32)
        ops.reset_launch_counts()
        got, pc = PA.attention(pp, torch.from_numpy(x), pcfg,
                               positions=torch.arange(S), cache=pc,
                               cache_pos=0)
    _close(got, want)
    _close(pc["k"], jc["k"])
    _close(pc["v"], jc["v"])

    # per-row decode: rows at different positions
    pos = np.array([S, S - 3], np.int32)
    xd = _x(B, 1, jcfg.d_model, seed=2)
    want, jc = JA.attention(jp, jnp.asarray(xd), jcfg,
                            positions=jnp.asarray(pos)[:, None], cache=jc,
                            cache_pos=jnp.asarray(pos))
    with ops.use_pallas_scoped(use_pallas):
        got, pc = PA.attention(pp, torch.from_numpy(xd), pcfg,
                               positions=torch.from_numpy(pos)[:, None],
                               cache=pc, cache_pos=torch.from_numpy(pos))
    _close(got, want)
    _close(pc["k"], jc["k"])


def test_per_row_cache_pos_needs_one_token():
    _, pcfg, _, pp = _setup("qwen2-7b")
    pc = PA.init_kv_cache(pcfg, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="S == 1"):
        PA.attention(pp, torch.zeros((2, 3, pcfg.d_model)), pcfg,
                     positions=torch.arange(3), cache=pc,
                     cache_pos=torch.tensor([0, 1]))


def test_windowed_decode_reads_the_live_window():
    """The scalar decode with a window over a long cache slices the
    window (the JAX H3 path) and matches JAX."""
    jcfg, pcfg, jp, pp = _setup("qwen2-7b")
    B, T, window, pos = 1, 40, 6, 25
    rng = np.random.default_rng(3)
    ck = rng.normal(size=(B, T, jcfg.num_kv_heads, jcfg.head_dim)).astype(
        np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    xd = _x(B, 1, jcfg.d_model, seed=4)
    want, _ = JA.attention(jp, jnp.asarray(xd), jcfg,
                           positions=pos + jnp.arange(1), window=window,
                           cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                           cache_pos=pos)
    got, _ = PA.attention(pp, torch.from_numpy(xd), pcfg,
                          positions=pos + torch.arange(1), window=window,
                          cache={"k": torch.from_numpy(ck.copy()),
                                 "v": torch.from_numpy(cv.copy())},
                          cache_pos=pos)
    _close(got, want)


def test_prefill_routes_through_the_flash_wrapper():
    """With the toggle on, a prompt's attention calls ops.flash_attention
    (once per call); decode and the toggle off do not."""
    _, pcfg, _, pp = _setup("qwen2-7b")
    calls = []
    real = ops.flash_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    x = torch.from_numpy(_x(1, 7, pcfg.d_model))
    ops.flash_attention = spy
    try:
        for flag in (False, True):
            with ops.use_pallas_scoped(flag):
                pc = PA.init_kv_cache(pcfg, 1, 12, torch.float32)
                PA.attention(pp, x, pcfg, positions=torch.arange(7),
                             cache=pc, cache_pos=0)
                PA.attention(pp, x[:, :1], pcfg,
                             positions=7 + torch.arange(1), cache=pc,
                             cache_pos=7)
    finally:
        ops.flash_attention = real
    assert len(calls) == 1 and calls[0][1] == 7


@pytest.mark.parametrize("causal, window, softcap", [
    (True, None, None), (True, 7, None), (False, None, 30.0)])
def test_blocked_attention_matches_jax(causal, window, softcap):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 45, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 45, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=16,
              kv_chunk=16)
    want = JA.blocked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = PA.blocked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, want)


def test_cross_attention_is_not_ported():
    """Cross-attention raised NotImplementedError until the
    encoder-decoder was ported (tests/test_torch_encdec.py holds both of
    its routes); now ``memory=`` gives the JAX module's output."""
    jcfg, pcfg, jp, pp = _setup("qwen2-7b")
    x, mem = _x(1, 2, jcfg.d_model), _x(1, 6, jcfg.d_model, seed=2)
    want, _ = JA.attention(jp, jnp.asarray(x), jcfg, positions=jnp.arange(2),
                           memory=jnp.asarray(mem))
    got, cache = PA.attention(pp, torch.from_numpy(x), pcfg,
                              positions=torch.arange(2),
                              memory=torch.from_numpy(mem))
    assert cache is None
    _close(got, want)
