"""The port's encoder-decoder (seamless-m4t-medium) against the JAX package.

The JAX ``init_encdec`` tree of the reduced config is converted with
``repro_torch.convert.encdec_params_from_jax``, so both packages compute
the same function; inputs come from numpy.  Covered: ``encode``,
``build_cross_cache``, ``_decoder`` over a memory, ``encdec_prefill``
(logits and both caches) and chained ``encdec_decode_step``s;
``tests/test_encdec.py``'s bidirectional-encoder, causal-decoder and
decode = teacher-forcing cases on the port; cross-attention alone
through the memory and the cross-cache routes; a source of another
length than ``encoder_seq_len`` and one of 2048 frames (the reference's
blocked non-causal path); the step builders of ``launch/steps.py``; and
reduced seamless through both ``Server``s, which serve it as a
decoder-only LM.  Every case runs with ``use_pallas`` off and on (on the
CPU, "on" is the flash-attention wrapper's plain version).  f32, to
1e-5 of the largest entry unless a case says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import serve as jax_serve
from repro.launch import steps as JS
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import encdec_params_from_jax, lm_params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as PS
from repro_torch.launch.serve import Request, Server
from repro_torch.models import attention as PA
from repro_torch.models import encdec as PE
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

KEY = jax.random.PRNGKey(0)
REL = 1e-5
ARCH = "seamless-m4t-medium"
B, S = 2, 12
PALLAS = pytest.mark.parametrize("use_pallas", [False, True])


def _close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.fixture(scope="module")
def model():
    jcfg, pcfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JE.init_encdec(KEY, jcfg)
    return jcfg, pcfg, jp, encdec_params_from_jax(
        jax.tree.map(np.asarray, jp), pcfg)


def _src(cfg, frames=None, seed=1):
    frames = cfg.encoder_seq_len if frames is None else frames
    return np.random.default_rng(seed).normal(
        size=(B, frames, cfg.d_model)).astype(np.float32)


def _tokens(cfg, shape=(B, S), seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _pt(a):
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


def _close_caches(got, want):
    """The port's per-layer cache lists against the JAX stacked ones."""
    for part in ("self", "cross"):
        assert len(got[part]) == want[part]["k"].shape[0]
        for i, layer in enumerate(got[part]):
            for name in ("k", "v"):
                _close(layer[name], want[part][name][i])


# -- parameters ---------------------------------------------------------------

def test_port_init_has_the_jax_tree(model):
    """The port's own draw has the converted tree's keys, shapes and
    dtype; the blocks are lists in layer order."""
    jcfg, pcfg, _, pp = model
    mine = PE.init_encdec(torch.Generator().manual_seed(0), pcfg,
                          device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), pp)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    assert {t.dtype for t in jax.tree.leaves(mine)} == {torch.float32}
    assert len(mine["encoder"]["blocks"]) == pcfg.num_encoder_layers == 2
    assert len(mine["decoder"]["blocks"]) == pcfg.num_layers == 2


def test_every_leaf_is_carried_across(model):
    """Block i of each stack is the JAX stack's entry i; every other leaf,
    the decoder's ``norm`` (which nothing reads) among them, as it is."""
    _, pcfg, jp, pp = model
    depth = {"encoder": pcfg.num_encoder_layers, "decoder": pcfg.num_layers}
    count = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [k.key for k in path]
        stacked = keys[1:2] == ["blocks"]
        for i in range(depth[keys[0]] if stacked else 1):
            node = pp
            for j, key in enumerate(keys):
                node = node[key]
                if stacked and j == 1:
                    node = node[i]
            want = np.asarray(leaf)[i] if stacked else np.asarray(leaf)
            np.testing.assert_array_equal(node.numpy(), want)
            count += 1
    assert count == len(jax.tree.leaves(pp))
    assert "norm" in pp["decoder"]


def test_conversion_checks_the_stack_depth(model):
    jcfg, pcfg, jp, _ = model
    with pytest.raises(ValueError, match="decoder"):
        encdec_params_from_jax(jax.tree.map(np.asarray, jp),
                               dataclasses.replace(pcfg, num_layers=3))


# -- the modules --------------------------------------------------------------

@PALLAS
@pytest.mark.parametrize("frames", [None, 24])
def test_encode_matches_jax(model, use_pallas, frames):
    """At ``encoder_seq_len`` (16) frames and at 24."""
    jcfg, pcfg, jp, pp = model
    src = _src(pcfg, frames)
    want = JE.encode(jp, jcfg, jnp.asarray(src))
    with ops.use_pallas_scoped(use_pallas):
        _close(PE.encode(pp, pcfg, _pt(src)), want)


@PALLAS
def test_build_cross_cache_matches_jax(model, use_pallas):
    jcfg, pcfg, jp, pp = model
    src = _src(pcfg, 24)
    want = JE.build_cross_cache(jp, jcfg, JE.encode(jp, jcfg,
                                                    jnp.asarray(src)))
    with ops.use_pallas_scoped(use_pallas):
        got = PE.build_cross_cache(pp, pcfg, PE.encode(pp, pcfg, _pt(src)))
    assert len(got) == pcfg.num_layers
    for i, layer in enumerate(got):
        assert layer["k"].shape == (B, 24, pcfg.num_kv_heads, pcfg.head_dim)
        for name in ("k", "v"):
            _close(layer[name], want[name][i])


@PALLAS
def test_decoder_over_memory_matches_jax(model, use_pallas):
    """Teacher forcing: the decoder over the encoder memory, no caches."""
    jcfg, pcfg, jp, pp = model
    src, toks = _src(pcfg), _tokens(pcfg)
    memory = JE.encode(jp, jcfg, jnp.asarray(src))
    h = JL.embed(jp["embed"], jnp.asarray(toks))
    want, none = JE._decoder(jp, jcfg, h, memory, positions=jnp.arange(S))
    assert none is None
    with ops.use_pallas_scoped(use_pallas):
        got, caches = PE._decoder(
            pp, pcfg, PL.embed(pp["embed"], _pt(toks)),
            PE.encode(pp, pcfg, _pt(src)),
            positions=torch.arange(S))
    assert caches is None
    _close(got, want)


@PALLAS
@pytest.mark.parametrize("frames", [None, 24])
def test_prefill_then_decode_matches_jax(model, use_pallas, frames):
    """Prefill (logits, the self cache written from 0 and the cross cache
    of the source's length), then 4 chained decode steps."""
    jcfg, pcfg, jp, pp = model
    T = 20
    src, toks = _src(pcfg, frames), _tokens(pcfg)
    batch = {"src_embeds": src, "tokens": toks}
    want, jc = JE.encdec_prefill(jp, jcfg, jax.tree.map(jnp.asarray, batch),
                                 JE.init_encdec_cache(jcfg, B, T))
    rng = np.random.default_rng(3)
    with ops.use_pallas_scoped(use_pallas):
        pc = PE.init_encdec_cache(pcfg, B, T, device="cpu")
        got, pc = PE.encdec_prefill(pp, pcfg, jax.tree.map(_pt, batch), pc)
        _close(got, want)
        _close_caches(pc, jc)
        assert pc["cross"][0]["k"].shape[1] == src.shape[1]
        for step in range(4):
            tok = rng.integers(0, pcfg.vocab_size, (B, 1)).astype(np.int32)
            want, jc = JE.encdec_decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                             jnp.int32(S + step))
            got, pc = PE.encdec_decode_step(pp, pcfg, _pt(tok), pc,
                                            S + step)
            _close(got, want)
    _close_caches(pc, jc)


@PALLAS
def test_long_source_takes_the_blocked_noncausal_path(model, use_pallas):
    """2048 frames: the reference's encoder runs its blocked path
    (``BLOCKED_ATTN_THRESHOLD``), non-causal; the prefill's cross cache
    is 2048 rows long."""
    jcfg, pcfg, jp, pp = model
    frames = JA.BLOCKED_ATTN_THRESHOLD
    assert frames == PA.BLOCKED_ATTN_THRESHOLD
    src, toks = _src(pcfg, frames), _tokens(pcfg, (B, 5))
    batch = {"src_embeds": src, "tokens": toks}
    memory = JE.encode(jp, jcfg, jnp.asarray(src))
    want, jc = JE.encdec_prefill(jp, jcfg, jax.tree.map(jnp.asarray, batch),
                                 JE.init_encdec_cache(jcfg, B, 8))
    with ops.use_pallas_scoped(use_pallas):
        _close(PE.encode(pp, pcfg, _pt(src)), memory)
        got, pc = PE.encdec_prefill(pp, pcfg, jax.tree.map(_pt, batch),
                                    PE.init_encdec_cache(pcfg, B, 8,
                                                         device="cpu"))
    _close(got, want)
    _close_caches(pc, jc)


# -- tests/test_encdec.py's cases on the port ---------------------------------

def _embed(pp, pcfg, toks):
    return PL.embed(pp["embed"], _pt(toks)).to(PL.dtype_of(pcfg.compute_dtype))


@PALLAS
def test_encoder_is_bidirectional(model, use_pallas):
    """Changing a late source frame changes EARLY encoder outputs."""
    jcfg, pcfg, jp, pp = model
    src = _src(pcfg)
    src2 = src.copy()
    src2[:, -1] += 3.0
    with ops.use_pallas_scoped(use_pallas):
        m1 = PE.encode(pp, pcfg, _pt(src))
        m2 = PE.encode(pp, pcfg, _pt(src2))
    assert not np.allclose(m1[:, 0].numpy(), m2[:, 0].numpy(), atol=1e-5)
    _close(m2, JE.encode(jp, jcfg, jnp.asarray(src2)))


@PALLAS
def test_decoder_is_causal(model, use_pallas):
    """Changing a late target token does not change earlier outputs."""
    jcfg, pcfg, jp, pp = model
    src, toks = _src(pcfg), _tokens(pcfg)
    toks2 = toks.copy()
    toks2[:, -1] = 0
    with ops.use_pallas_scoped(use_pallas):
        memory = PE.encode(pp, pcfg, _pt(src))
        out1, _ = PE._decoder(pp, pcfg, _embed(pp, pcfg, toks), memory,
                              positions=torch.arange(S))
        out2, _ = PE._decoder(pp, pcfg, _embed(pp, pcfg, toks2), memory,
                              positions=torch.arange(S))
    np.testing.assert_allclose(out1[:, :-1].numpy(), out2[:, :-1].numpy(),
                               atol=1e-5)
    want, _ = JE._decoder(jp, jcfg, JL.embed(jp["embed"], jnp.asarray(toks2)),
                          JE.encode(jp, jcfg, jnp.asarray(src)),
                          positions=jnp.arange(S))
    _close(out2, want)


@PALLAS
def test_decode_step_matches_teacher_forcing(model, use_pallas):
    """A prefill of S - 1 tokens and one decode step give the teacher-
    forced logits of the last position (the JAX test's atol 2e-3); the
    step is also held to JAX's at 1e-5."""
    jcfg, pcfg, jp, pp = model
    src, toks = _src(pcfg), _tokens(pcfg)
    with ops.use_pallas_scoped(use_pallas):
        memory = PE.encode(pp, pcfg, _pt(src))
        full, _ = PE._decoder(pp, pcfg, _embed(pp, pcfg, toks), memory,
                              positions=torch.arange(S))
        full_logits = PT.lm_logits(pp, pcfg, full)
        _, caches = PE.encdec_prefill(
            pp, pcfg, {"src_embeds": _pt(src), "tokens": _pt(toks[:, :-1])},
            PE.init_encdec_cache(pcfg, B, S, device="cpu"))
        step, _ = PE.encdec_decode_step(pp, pcfg, _pt(toks[:, -1:]), caches,
                                        S - 1)
    np.testing.assert_allclose(step.numpy(), full_logits[:, -1].numpy(),
                               atol=2e-3)
    _, jc = JE.encdec_prefill(jp, jcfg, {"src_embeds": jnp.asarray(src),
                                         "tokens": jnp.asarray(toks[:, :-1])},
                              JE.init_encdec_cache(jcfg, B, S))
    want, _ = JE.encdec_decode_step(jp, jcfg, jnp.asarray(toks[:, -1:]), jc,
                                    jnp.int32(S - 1))
    _close(step, want)


# -- cross-attention alone ------------------------------------------------------

def _attn_setup(arch, seed=0):
    jcfg = jax_config(arch).reduced()
    pcfg = get_config(arch).reduced()
    jp = JA.attn_init(jax.random.PRNGKey(seed), jcfg, cross=True)
    pp = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in jp.items()}
    return jcfg, pcfg, jp, pp


@PALLAS
@pytest.mark.parametrize("arch", [ARCH, "qwen3-14b"])     # qwen3: qk-norm
@pytest.mark.parametrize("route", ["memory", "cache"])
@pytest.mark.parametrize("Sq", [1, 7])
def test_cross_attention_matches_jax(arch, route, Sq, use_pallas):
    """K/V from ``memory`` (q and k normalized), or from a cross cache
    (q normalized only), against the JAX ``attention``; S = 1 (decode)
    and S > 1 (a prompt), 19 memory rows, no RoPE, no causal mask."""
    jcfg, pcfg, jp, pp = _attn_setup(arch)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, Sq, jcfg.d_model)).astype(np.float32)
    pos = 5 + np.arange(Sq)
    if route == "memory":
        mem = rng.normal(size=(2, 19, jcfg.d_model)).astype(np.float32)
        kw_j = dict(memory=jnp.asarray(mem))
        kw_p = dict(memory=torch.from_numpy(mem))
    else:
        kv = rng.normal(size=(2, 2, 19, jcfg.num_kv_heads,
                              jcfg.head_dim)).astype(np.float32)
        kw_j = dict(cross=True, cache={"k": jnp.asarray(kv[0]),
                                       "v": jnp.asarray(kv[1])})
        cache = {"k": torch.from_numpy(kv[0]), "v": torch.from_numpy(kv[1])}
        kw_p = dict(cross=True, cache=cache)
    want, want_c = JA.attention(jp, jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos), **kw_j)
    with ops.use_pallas_scoped(use_pallas):
        got, got_c = PA.attention(pp, torch.from_numpy(x), pcfg,
                                  positions=torch.from_numpy(pos), **kw_p)
    _close(got, want)
    if route == "memory":
        assert got_c is None and want_c is None
    else:
        assert got_c is cache               # the cross cache, as given


def _flash_calls(monkeypatch):
    """(S, T, causal) of every flash-attention call (on the CPU, the
    wrapper's plain version)."""
    calls = []
    real = ref.flash_attention_ref

    def recorded(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ref, "flash_attention_ref", recorded)
    return calls


def test_prefill_runs_flash_in_all_three_attentions(model, monkeypatch):
    """With the kernels on, a prefill calls B9 once in every encoder layer
    (non-causal, S = T = frames), every decoder self-attention (causal,
    the prompt against the whole self cache) and every cross-attention
    (non-causal, the prompt against the frames); a decode step none."""
    jcfg, pcfg, jp, pp = model
    calls = _flash_calls(monkeypatch)
    src, toks = _src(pcfg, 24), _tokens(pcfg)
    with ops.use_pallas_scoped(True):
        _, caches = PE.encdec_prefill(
            pp, pcfg, {"src_embeds": _pt(src), "tokens": _pt(toks)},
            PE.init_encdec_cache(pcfg, B, 20, device="cpu"))
        n = pcfg.num_layers
        assert calls == [(24, 24, False)] * pcfg.num_encoder_layers + \
            [(S, 20, True), (S, 24, False)] * n
        del calls[:]
        PE.encdec_decode_step(pp, pcfg, _pt(toks[:, :1]), caches, S)
    assert calls == []


def test_noncausal_window_raises_on_the_flash_route():
    """The reference drops a non-causal call's window on its einsum path
    and keeps it on its blocked path; the flash route refuses it."""
    _, pcfg, _, pp = _attn_setup(ARCH)
    x = torch.zeros((1, 3, pcfg.d_model))
    mem = torch.zeros((1, 5, pcfg.d_model))
    with ops.use_pallas_scoped(True):
        with pytest.raises(ValueError, match="window"):
            PA.attention(pp, x, pcfg, positions=torch.arange(3), memory=mem,
                         window=2)
    with ops.use_pallas_scoped(False):
        out, _ = PA.attention(pp, x, pcfg, positions=torch.arange(3),
                              memory=mem, window=2)
    assert out.shape == x.shape


# -- the step builders ----------------------------------------------------------

def test_decode_window():
    long = ShapeConfig("long_500k", 524_288, 1, "decode")
    short = ShapeConfig("decode_32k", 32_768, 128, "decode")
    qwen, seamless = get_config("qwen2-7b"), get_config(ARCH)
    jlong = JaxShapeConfig("long_500k", 524_288, 1, "decode")
    assert PS.decode_window(qwen, long) == JS.decode_window(
        jax_config("qwen2-7b"), jlong) == qwen.long_context_window
    assert PS.decode_window(seamless, long) is None
    assert PS.decode_window(qwen, short) is None


@pytest.fixture(scope="module")
def qwen():
    jcfg, pcfg = jax_config("qwen2-7b").reduced(), get_config(
        "qwen2-7b").reduced()
    jp = JT.init_lm(KEY, jcfg)
    return jcfg, pcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              pcfg)


@PALLAS
@pytest.mark.parametrize("arch", [ARCH, "qwen2-7b"])
def test_step_builders_match_jax(model, qwen, arch, use_pallas):
    """``make_prefill_step`` then 3 ``make_decode_step`` steps, the port's
    against the JAX package's; the caches land on the parameters'
    device."""
    jcfg, pcfg, jp, pp = model if arch == ARCH else qwen
    seq_len = 24
    jshape = JaxShapeConfig("prefill_smoke", seq_len, B, "prefill")
    pshape = ShapeConfig("prefill_smoke", seq_len, B, "prefill")
    toks = _tokens(pcfg)
    batch = {"tokens": toks}
    if pcfg.is_encoder_decoder:
        batch["src_embeds"] = _src(pcfg)
    want, jc = JS.make_prefill_step(jcfg, jshape)(
        jp, jax.tree.map(jnp.asarray, batch))
    jdecode = JS.make_decode_step(jcfg, jshape)
    pdecode = PS.make_decode_step(pcfg, pshape)
    rng = np.random.default_rng(5)
    with ops.use_pallas_scoped(use_pallas):
        got, pc = PS.make_prefill_step(pcfg, pshape)(
            pp, jax.tree.map(_pt, batch))
        _close(got, want, 1e-5)
        for step in range(3):
            tok = rng.integers(0, pcfg.vocab_size, (B, 1)).astype(np.int32)
            want, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(S + step))
            got, pc = pdecode(pp, pc, _pt(tok), S + step)
            _close(got, want, 1e-5)
    first = pc["self"][0] if pcfg.is_encoder_decoder else pc[0]
    assert first["k"].device.type == "cpu"
    assert first["k"].shape[:2] == (B, seq_len)


# -- Server: seamless as a decoder-only LM, as the JAX Server serves it --------

# tests/test_serve_lm.py's batch, max_seq and prompt lengths
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


def test_server_builds_seamless_as_a_decoder_only_stack():
    cfg = get_config(ARCH).reduced()
    assert PT.layer_types(cfg) == [("attn", "dense")] * cfg.num_layers
    assert PT.layer_types(get_config(ARCH)) == [("attn", "dense")] * 12
    srv = Server(cfg, 2, 32, seed=0, device="cpu")
    assert len(srv.params["layers"]) == cfg.num_layers
    assert "encoder" not in srv.params


@PALLAS
def test_server_gives_the_jax_servers_tokens(jax_server_tokens, use_pallas):
    """The port's ``Server`` holding the JAX ``Server``'s weights; the
    reference serves the encoder-decoder config as a decoder-only LM."""
    jparams, want = jax_server_tokens
    pcfg = get_config(ARCH).reduced()
    srv = Server(pcfg, 2, 32, seed=0, device="cpu")
    srv.params = srv.scheduler.params = lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), pcfg)
    with ops.use_pallas_scoped(use_pallas):
        done = srv.serve_batch(_reqs(pcfg.vocab_size, Request))
    assert {r.uid: r.generated for r in done} == want
    assert [len(want[i]) for i in range(3)] == [g for _, g in ORACLE_LENS]
