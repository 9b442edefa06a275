"""The port's LM forward (prefill, slot prefill, decode) against the JAX
package's, on the reduced ``qwen2-7b`` and ``mamba2-2.7b``.

The JAX ``init_lm`` tree is converted with
``repro_torch.convert.lm_params_from_jax`` so both packages compute the
same function; tokens come from numpy.  Logits are held to 1e-4 of the
largest |logit|, caches to 1e-5 of their largest entry, with the
``use_pallas`` toggle off (the plain path) and on (the kernel wrappers,
plain versions on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import transformer as PT

ARCHS = ("qwen2-7b", "mamba2-2.7b")
LOGIT_REL = 1e-4
CACHE_REL = 1e-5


def _close(got, want, rel):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _close_caches(pc, jc):
    """The port's per-layer caches against the JAX segment-stacked ones."""
    flat = []
    for seg in jc:
        blocks = seg["blocks"]
        repeats = next(iter(blocks[0].values())).shape[0]
        for r in range(repeats):
            for blk in blocks:
                flat.append({k: np.asarray(v[r]) for k, v in blk.items()})
    assert len(flat) == len(pc)
    for got, want in zip(pc, flat):
        assert got.keys() == want.keys()
        for k in got:
            _close(got[k], want[k], CACHE_REL)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, pcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    pp = lm_params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    return jcfg, pcfg, jp, pp


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_then_decode(model, use_pallas):
    jcfg, pcfg, jp, pp = model
    B, S, T = 2, 13, 24
    toks = _tokens((B, S), jcfg.vocab_size)
    last = np.array([S - 1, 6], np.int32)
    jc = JT.init_lm_cache(jcfg, B, T)
    want, jc = JT.lm_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc,
                             last_pos=jnp.asarray(last))
    with ops.use_pallas_scoped(use_pallas):
        pc = PT.init_lm_cache(pcfg, B, T, device="cpu")
        got, pc = PT.lm_prefill(pp, pcfg,
                                {"tokens": torch.from_numpy(toks).long()},
                                pc, last_pos=torch.from_numpy(last))
        _close(got, want, LOGIT_REL)
        _close_caches(pc, jc)
        # two decode steps: per-row positions, then a scalar position
        for step, pos in enumerate((np.array([S, S], np.int32), S + 1)):
            tok = _tokens((B, 1), jcfg.vocab_size, seed=10 + step)
            want, jc = JT.lm_decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                         jnp.asarray(pos))
            ppos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) \
                else pos
            got, pc = PT.lm_decode_step(pp, pcfg,
                                        torch.from_numpy(tok).long(), pc,
                                        ppos)
            _close(got, want, LOGIT_REL)
        _close_caches(pc, jc)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_slot_touches_one_slot(model, use_pallas):
    jcfg, pcfg, jp, pp = model
    B, S, T = 3, 9, 16
    toks = _tokens((1, S), jcfg.vocab_size, seed=1)
    # a dirty cache: every slot holds an earlier prompt's state
    old = _tokens((B, 5), jcfg.vocab_size, seed=2)
    jc = JT.init_lm_cache(jcfg, B, T)
    _, jc = JT.lm_prefill(jp, jcfg, {"tokens": jnp.asarray(old)}, jc)
    want, jc = JT.lm_prefill_slot(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                  jc, 1, last_pos=jnp.asarray([S - 2]))
    with ops.use_pallas_scoped(use_pallas):
        pc = PT.init_lm_cache(pcfg, B, T, device="cpu")
        _, pc = PT.lm_prefill(pp, pcfg,
                              {"tokens": torch.from_numpy(old).long()}, pc)
        got, pc = PT.lm_prefill_slot(
            pp, pcfg, {"tokens": torch.from_numpy(toks).long()}, pc, 1,
            last_pos=[S - 2])
    _close(got, want, LOGIT_REL)
    _close_caches(pc, jc)


def test_port_init_has_the_jax_parameter_shapes(model):
    jcfg, pcfg, _, pp = model
    mine = PT.init_lm(torch.Generator().manual_seed(0), pcfg, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), pp)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    dtypes = {t.dtype for t in jax.tree.leaves(mine)}
    assert dtypes == {torch.float32}


@pytest.mark.parametrize("arch", list_archs())
def test_build_plan_matches_jax(arch):
    assert PT.build_plan(get_config(arch)) == JT.build_plan(jax_config(arch))
    assert PT.layer_types(get_config(arch)) == JT.layer_types(
        jax_config(arch))


def test_full_configs_have_the_published_sizes():
    """qwen2-7b: 7.62e9 parameters; mamba2-2.7b: 2.70e9."""
    qwen = get_config("qwen2-7b")
    mamba = get_config("mamba2-2.7b")
    assert round(qwen.param_count() / 1e9, 2) == 7.62
    assert round(mamba.param_count() / 1e9, 2) == 2.70
    assert (qwen.d_model, qwen.num_layers, qwen.num_heads, qwen.num_kv_heads,
            qwen.head_dim, qwen.d_ff, qwen.vocab_size) == (
        3584, 28, 28, 4, 128, 18944, 152064)
    s = mamba.ssm
    assert (mamba.d_model, s.d_inner(mamba.d_model), mamba.num_layers,
            s.num_heads(mamba.d_model), s.head_dim, s.d_state,
            s.chunk_size) == (2560, 5120, 64, 80, 64, 128, 256)
