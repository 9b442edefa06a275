"""The port's MLA (``repro_torch.models.mla``) against the JAX package's.

The four cases of ``tests/test_mla.py`` run on the port with the JAX
``mla_init`` draw converted to torch; then ``mla_attention`` is held to
the JAX function at a short and a blocked-length prefill, a lockstep, a
per-row and a windowed decode (the live-window slice), each with the
``use_pallas`` toggle off and on (on the CPU, on runs B9's plain
version).  Outputs and caches are held to 1e-5 of the largest |entry|
(f32).  Then reduced deepseek-v3 end to end: prefill and decode logits
on converted weights, the ``mtp`` head carried across, and the port's
``Server`` with the JAX ``Server``'s weights giving its greedy tokens
exactly (``tests/test_serve_lm.py``'s MLA oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.launch import serve as jax_serve
from repro.models import mla as JMLA
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import Request, Server
from repro_torch.models import mla as PMLA
from repro_torch.models import transformer as PT

KEY = jax.random.PRNGKey(0)
REL = 1e-5
ARCH = "deepseek-v3-671b"
PALLAS = pytest.mark.parametrize("use_pallas", [False, True])


def mk_cfgs():
    """(JAX config, port config) of tests/test_mla.py."""
    mla = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16)
    base = dict(name="t", arch_type="moe", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                vocab_size=64, use_mla=True, param_dtype="float32",
                compute_dtype="float32")
    return (JaxModelConfig(**base, mla=JaxMLAConfig(**mla)),
            ModelConfig(**base, mla=MLAConfig(**mla)))


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def x_of(shape):
    """tests/test_mla.py's input: ``jax.random.normal(KEY, shape)``."""
    return np.asarray(jax.random.normal(KEY, shape))


@pytest.fixture(scope="module")
def mla():
    jcfg, pcfg = mk_cfgs()
    jp = JMLA.mla_init(KEY, jcfg)
    return jcfg, pcfg, jp, to_torch(jp)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _close_cache(pc, jc):
    assert pc.keys() == jc.keys()
    for k in pc:
        _close(pc[k], jc[k])


def _port(p, x, cfg, positions, use_pallas, **kw):
    with ops.use_pallas_scoped(use_pallas):
        return PMLA.mla_attention(p, torch.from_numpy(np.array(x)), cfg,
                                  positions=torch.as_tensor(
                                      np.asarray(positions)), **kw)


# -- tests/test_mla.py's four cases, on converted parameters -----------------

@PALLAS
def test_expanded_forward_shapes(mla, use_pallas):
    jcfg, pcfg, jp, pp = mla
    x = x_of((2, 12, 64))
    out, cache = _port(pp, x, pcfg, np.arange(12), use_pallas)
    assert out.shape == (2, 12, 64)
    assert cache is None
    want, _ = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.arange(12))
    _close(out, want)


@PALLAS
def test_absorbed_decode_matches_expanded(mla, use_pallas):
    """The absorbed decode reproduces the expanded attention at the last
    position, as in the JAX package, and gives the JAX decode's output."""
    jcfg, pcfg, jp, pp = mla
    S = 9
    x = x_of((2, S, 64))
    full, _ = _port(pp, x, pcfg, np.arange(S), use_pallas)
    cache = PMLA.init_mla_cache(pcfg, 2, S, torch.float32, device="cpu")
    _, cache = _port(pp, x[:, : S - 1], pcfg, np.arange(S - 1), use_pallas,
                     cache=cache, cache_pos=0)
    step, _ = _port(pp, x[:, S - 1:], pcfg, np.arange(S - 1, S), use_pallas,
                    cache=cache, cache_pos=S - 1)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               atol=1e-4)
    jc = JMLA.init_mla_cache(jcfg, 2, S, jnp.float32)
    _, jc = JMLA.mla_attention(jp, jnp.asarray(x[:, : S - 1]), jcfg,
                               positions=jnp.arange(S - 1), cache=jc,
                               cache_pos=0)
    want, jc = JMLA.mla_attention(jp, jnp.asarray(x[:, S - 1:]), jcfg,
                                  positions=jnp.arange(S - 1, S), cache=jc,
                                  cache_pos=S - 1)
    _close(step, want)
    _close_cache(cache, jc)


def test_cache_is_compressed():
    """The JAX cache's shapes; cached entries a token are kv_lora +
    rope_dim, far below GQA's 2 · H · head_dim."""
    jcfg, pcfg = mk_cfgs()
    cache = PMLA.init_mla_cache(pcfg, 1, 128, torch.float32, device="cpu")
    jc = JMLA.init_mla_cache(jcfg, 1, 128, jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jc.items()}
    assert all(v.dtype == torch.float32 for v in cache.values())
    per_token = sum(np.prod(v.shape[2:]) for v in cache.values())
    gqa_per_token = 2 * pcfg.num_heads * (pcfg.mla.qk_nope_head_dim
                                          + pcfg.mla.qk_rope_head_dim)
    assert per_token < gqa_per_token / 3


@PALLAS
def test_window_masks_decode(mla, use_pallas):
    jcfg, pcfg, jp, pp = mla
    S = 12
    x = x_of((1, S, 64))
    cache = PMLA.init_mla_cache(pcfg, 1, S, torch.float32, device="cpu")
    _, cache = _port(pp, x[:, :-1], pcfg, np.arange(S - 1), use_pallas,
                     cache=cache, cache_pos=0)
    full_step, _ = _port(pp, x[:, -1:], pcfg, np.arange(S - 1, S),
                         use_pallas, cache=cache, cache_pos=S - 1)
    win_step, _ = _port(pp, x[:, -1:], pcfg, np.arange(S - 1, S),
                        use_pallas, cache=cache, cache_pos=S - 1, window=3)
    assert not np.allclose(full_step.numpy(), win_step.numpy(), atol=1e-4)
    jc = JMLA.init_mla_cache(jcfg, 1, S, jnp.float32)
    _, jc = JMLA.mla_attention(jp, jnp.asarray(x[:, :-1]), jcfg,
                               positions=jnp.arange(S - 1), cache=jc,
                               cache_pos=0)
    want, _ = JMLA.mla_attention(jp, jnp.asarray(x[:, -1:]), jcfg,
                                 positions=jnp.arange(S - 1, S), cache=jc,
                                 cache_pos=S - 1, window=3)
    _close(win_step, want)


# -- mla_attention against the JAX function ----------------------------------

@PALLAS
@pytest.mark.parametrize("S", [8, 2048])
def test_prefill_matches_jax(mla, use_pallas, S):
    """S = 2048 is the blocked path (BLOCKED_ATTN_THRESHOLD) off the
    kernels; the cache is written in place."""
    jcfg, pcfg, jp, pp = mla
    B, T = 2, S + 4
    x = np.random.default_rng(S).normal(size=(B, S, 64)).astype(np.float32)
    jc = JMLA.init_mla_cache(jcfg, B, T, jnp.float32)
    want, jc = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                                  positions=jnp.arange(S), cache=jc,
                                  cache_pos=0)
    cache = PMLA.init_mla_cache(pcfg, B, T, torch.float32, device="cpu")
    got, out_cache = _port(pp, x, pcfg, np.arange(S), use_pallas,
                           cache=cache, cache_pos=0)
    assert out_cache is cache               # written in place
    _close(got, want)
    _close_cache(cache, jc)


def _prefilled(mla, B, T, P, seed):
    """A JAX and a port cache holding the same P-token prefill."""
    jcfg, pcfg, jp, pp = mla
    x = np.random.default_rng(seed).normal(size=(B, P, 64)).astype(
        np.float32)
    jc = JMLA.init_mla_cache(jcfg, B, T, jnp.float32)
    _, jc = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                               positions=jnp.arange(P), cache=jc,
                               cache_pos=0)
    pc = PMLA.init_mla_cache(pcfg, B, T, torch.float32, device="cpu")
    _port(pp, x, pcfg, np.arange(P), False, cache=pc, cache_pos=0)
    return jc, pc


@PALLAS
def test_lockstep_decode_matches_jax(mla, use_pallas):
    jcfg, pcfg, jp, pp = mla
    jc, pc = _prefilled(mla, 2, 16, 7, seed=1)
    for pos in (7, 8):
        x = np.random.default_rng(pos).normal(size=(2, 1, 64)).astype(
            np.float32)
        want, jc = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                                      positions=jnp.asarray(pos) +
                                      jnp.arange(1), cache=jc,
                                      cache_pos=jnp.asarray(pos))
        got, pc = _port(pp, x, pcfg, pos + np.arange(1), use_pallas,
                        cache=pc, cache_pos=pos)
        _close(got, want)
    _close_cache(pc, jc)


@PALLAS
def test_per_row_decode_matches_jax(mla, use_pallas):
    """Row i writes at its own position and reads only [0, pos[i]]."""
    jcfg, pcfg, jp, pp = mla
    jc, pc = _prefilled(mla, 3, 16, 9, seed=2)
    pos = np.array([9, 4, 6], np.int32)
    x = np.random.default_rng(3).normal(size=(3, 1, 64)).astype(np.float32)
    want, jc = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                                  positions=jnp.asarray(pos)[:, None],
                                  cache=jc, cache_pos=jnp.asarray(pos))
    got, pc = _port(pp, x, pcfg, pos[:, None], use_pallas, cache=pc,
                    cache_pos=torch.from_numpy(pos))
    _close(got, want)
    _close_cache(pc, jc)
    with pytest.raises(ValueError, match="per-request cache_pos"):
        _port(pp, np.zeros((3, 2, 64), np.float32), pcfg, pos[:, None],
              use_pallas, cache=pc, cache_pos=torch.from_numpy(pos))


@PALLAS
@pytest.mark.parametrize("pos", [11, 2])
def test_windowed_decode_matches_jax(mla, use_pallas, pos):
    """A 16-row cache is longer than twice the window of 3, so the decode
    reads only the live window: starting at pos - 2, or at 0 (clamped)."""
    jcfg, pcfg, jp, pp = mla
    jc, pc = _prefilled(mla, 2, 16, pos, seed=4)
    x = np.random.default_rng(5).normal(size=(2, 1, 64)).astype(np.float32)
    want, jc = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                                  positions=pos + jnp.arange(1), cache=jc,
                                  cache_pos=pos, window=3)
    got, pc = _port(pp, x, pcfg, pos + np.arange(1), use_pallas, cache=pc,
                    cache_pos=pos, window=3)
    _close(got, want)
    _close_cache(pc, jc)


@PALLAS
def test_windowed_prefill_matches_jax(mla, use_pallas):
    jcfg, pcfg, jp, pp = mla
    x = np.random.default_rng(6).normal(size=(2, 20, 64)).astype(np.float32)
    want, _ = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.arange(20), window=5)
    got, _ = _port(pp, x, pcfg, np.arange(20), use_pallas, window=5)
    _close(got, want)


def test_expanded_prefill_launches_flash_with_the_mla_scale(mla,
                                                            monkeypatch):
    """Under use_pallas the expanded prefill calls B9 (its plain version
    on these CPU tensors) with q/k 24 wide, v 16 and scale 1/sqrt(24);
    off, or at decode, it does not."""
    _, pcfg, _, pp = mla
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], v.shape[-1], kw["scale"]))
        return real(q, k, v, **kw)

    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", spy)
    x = x_of((1, 6, 64))
    _port(pp, x, pcfg, np.arange(6), False)
    assert calls == []
    cache = PMLA.init_mla_cache(pcfg, 1, 8, device="cpu")
    _port(pp, x, pcfg, np.arange(6), True, cache=cache, cache_pos=0)
    _port(pp, x[:, :1], pcfg, np.arange(6, 7), True, cache=cache,
          cache_pos=6)
    assert calls == [(24, 16, pytest.approx(1 / np.sqrt(24)))]


# -- reduced deepseek-v3 end to end ------------------------------------------

@pytest.fixture(scope="module")
def deepseek():
    jcfg, pcfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JT.init_lm(KEY, jcfg)
    return jcfg, pcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              pcfg)


def test_mtp_head_is_carried_across(deepseek):
    jcfg, pcfg, jp, pp = deepseek
    assert "mtp" in jp and pcfg.mtp_depth == 1
    want = jax.tree_util.tree_flatten_with_path(jp["mtp"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(pp["mtp"])[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf))


def test_port_init_has_the_jax_tree(deepseek):
    """The port's own draw has the converted JAX tree's keys (``mtp``
    included), shapes and dtype."""
    _, pcfg, _, pp = deepseek
    mine = PT.init_lm(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert mine.keys() == pp.keys() and "mtp" in mine
    shapes = jax.tree.map(lambda t: tuple(t.shape), pp)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    assert {t.dtype for t in jax.tree.leaves(mine)} == {torch.float32}
    assert [m for m, _ in PT.layer_types(pcfg)] == ["mla", "mla"]


@PALLAS
def test_deepseek_prefill_then_decode_matches_jax(deepseek, use_pallas):
    jcfg, pcfg, jp, pp = deepseek
    B, S, T = 2, 13, 24
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    last = np.array([S - 1, 6], np.int32)
    jc = JT.init_lm_cache(jcfg, B, T)
    want, jc = JT.lm_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc,
                             last_pos=jnp.asarray(last))
    with ops.use_pallas_scoped(use_pallas):
        pc = PT.init_lm_cache(pcfg, B, T, device="cpu")
        got, pc = PT.lm_prefill(pp, pcfg,
                                {"tokens": torch.from_numpy(toks).long()},
                                pc, last_pos=torch.from_numpy(last))
        _close(got, want)
        for step, pos in enumerate((np.array([S, S - 3], np.int32), S + 1)):
            tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
            want, jc = JT.lm_decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                         jnp.asarray(pos))
            ppos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) \
                else pos
            got, pc = PT.lm_decode_step(pp, pcfg,
                                        torch.from_numpy(tok).long(), pc,
                                        ppos)
            _close(got, want)
    flat = [{k: np.asarray(v[r]) for k, v in blk.items()}
            for seg in jc for blk in seg["blocks"]
            for r in range(next(iter(blk.values())).shape[0])]
    assert len(flat) == len(pc)
    for got_c, want_c in zip(pc, flat):
        _close_cache(got_c, want_c)


# tests/test_serve_lm.py's MLA oracle: batch 2, max_seq 32, these prompt
# lengths and new tokens, prompts from seed 1
ORACLE_LENS = [(4, 4), (9, 3), (3, 5)]


def _reqs(vocab, cls):
    rng = np.random.default_rng(1)
    return [cls(i, rng.integers(0, vocab, p).astype(np.int32), g)
            for i, (p, g) in enumerate(ORACLE_LENS)]


@pytest.fixture(scope="module")
def jax_server_tokens():
    jcfg = jax_config(ARCH).reduced()
    srv = jax_serve.Server(jcfg, 2, 32, seed=0)
    done = srv.serve_batch(_reqs(jcfg.vocab_size, jax_serve.Request))
    return srv.params, {r.uid: r.generated for r in done}


@PALLAS
def test_server_gives_the_jax_servers_tokens(jax_server_tokens, use_pallas):
    """The port's ``Server`` holding the JAX ``Server``'s weights."""
    jparams, want = jax_server_tokens
    pcfg = get_config(ARCH).reduced()
    srv = Server(pcfg, 2, 32, seed=0, device="cpu")
    srv.params = srv.scheduler.params = lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), pcfg)
    with ops.use_pallas_scoped(use_pallas):
        done = srv.serve_batch(_reqs(pcfg.vocab_size, Request))
    assert {r.uid: r.generated for r in done} == want
    assert [len(want[i]) for i in range(3)] == [g for _, g in ORACLE_LENS]


def test_server_batch_matches_its_batch1_oracle():
    """On the port's own weights, as tests/test_serve_lm.py holds the
    JAX server."""
    cfg = get_config(ARCH).reduced()
    srv = Server(cfg, 2, 32, seed=0, device="cpu")
    done = srv.serve_batch(_reqs(cfg.vocab_size, Request))
    for r in done:
        solo = Server(cfg, 1, 32, seed=0, device="cpu")
        alone = Request(r.uid, r.prompt, r.max_new_tokens)
        solo.serve_batch([alone])
        assert r.generated == alone.generated
