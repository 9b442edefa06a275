"""VLM prefix embeddings in the port's LM against the JAX package's, on
reduced ``internvl2-26b``.

The JAX ``init_lm`` tree is converted with
``repro_torch.convert.lm_params_from_jax``; tokens and the projected
patch embeddings come from numpy.  ``embed_inputs`` puts the prefix
before the tokens, and ``lm_prefill`` runs positions over both, so its
logits (read at ``last_pos`` inside the text), its caches and the decode
steps after it are held to 1e-5 of the largest |entry| (f32), with the
``use_pallas`` toggle off and on.  The JAX ``Request`` carries no
prefix, so the JAX ``Server`` serves this arch on tokens alone, and so
does the port's: its greedy tokens are the JAX ``Server``'s exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import Request, Server
from repro_torch.models import transformer as PT

ARCH = "internvl2-26b"
REL = 1e-5
PALLAS = pytest.mark.parametrize("use_pallas", [False, True])


@pytest.fixture(scope="module")
def vlm():
    jcfg, pcfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              pcfg)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _inputs(cfg, B, S, seed):
    """(tokens (B, S), prefix embeddings (B, num_prefix_embeds, d))."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pfx = rng.normal(size=(B, cfg.num_prefix_embeds, cfg.d_model)).astype(
        np.float32)
    return toks, pfx


def _jax_batch(toks, pfx):
    return {"tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pfx)}


def _port_batch(toks, pfx):
    return {"tokens": torch.from_numpy(toks).long(),
            "prefix_embeds": torch.from_numpy(pfx)}


def test_init_and_plan_match_jax(vlm):
    jcfg, pcfg, _, pp = vlm
    assert pcfg.num_prefix_embeds == 4
    mine = PT.init_lm(torch.Generator().manual_seed(0), pcfg, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), pp)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    assert PT.layer_types(pcfg) == JT.layer_types(jcfg)


@pytest.mark.parametrize("parts", ["both", "prefix", "tokens"])
def test_embed_inputs_matches_jax(vlm, parts):
    """The prefix first, in the compute dtype; either part alone."""
    jcfg, pcfg, jp, pp = vlm
    toks, pfx = _inputs(pcfg, 2, 7, seed=0)
    jt = None if parts == "prefix" else jnp.asarray(toks)
    jx = None if parts == "tokens" else jnp.asarray(pfx)
    want = JT.embed_inputs(jp, jcfg, jt, jx)
    got = PT.embed_inputs(
        pp, pcfg, None if jt is None else torch.from_numpy(toks).long(),
        None if jx is None else torch.from_numpy(pfx))
    assert got.dtype == torch.float32
    _close(got, want, 0.0)


@PALLAS
def test_prefill_with_prefix_then_decode_matches_jax(vlm, use_pallas):
    """``last_pos`` indexes the concatenated sequence: the text's last
    token of each row (the second row's prompt is shorter)."""
    jcfg, pcfg, jp, pp = vlm
    B, S, T = 2, 11, 24
    P = pcfg.num_prefix_embeds
    toks, pfx = _inputs(pcfg, B, S, seed=1)
    last = np.array([P + S - 1, P + 5], np.int32)
    jc = JT.init_lm_cache(jcfg, B, T)
    want, jc = JT.lm_prefill(jp, jcfg, _jax_batch(toks, pfx), jc,
                             last_pos=jnp.asarray(last))
    with ops.use_pallas_scoped(use_pallas):
        pc = PT.init_lm_cache(pcfg, B, T, device="cpu")
        got, pc = PT.lm_prefill(pp, pcfg, _port_batch(toks, pfx), pc,
                                last_pos=torch.from_numpy(last))
        _close(got, want)
        rng = np.random.default_rng(2)
        for pos in (last + 1, P + S + 1):
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
        assert got_c.keys() == want_c.keys()
        for k in got_c:
            _close(got_c[k], want_c[k])


@PALLAS
def test_prefill_slot_with_prefix_matches_jax(vlm, use_pallas):
    """A prefix prompt into slot 1 of a 3-slot cache; the last position
    read at the default (the sequence's end)."""
    jcfg, pcfg, jp, pp = vlm
    toks, pfx = _inputs(pcfg, 1, 6, seed=3)
    jc = JT.init_lm_cache(jcfg, 3, 16)
    want, _ = JT.lm_prefill_slot(jp, jcfg, _jax_batch(toks, pfx), jc, 1)
    with ops.use_pallas_scoped(use_pallas):
        pc = PT.init_lm_cache(pcfg, 3, 16, device="cpu")
        got, pc = PT.lm_prefill_slot(pp, pcfg, _port_batch(toks, pfx), pc, 1)
    _close(got, want)
    for layer in pc:
        assert all(float(t[0].abs().max()) == 0.0 == float(t[2].abs().max())
                   for t in layer.values())


def test_prefix_changes_the_logits(vlm):
    """The prefix is attended: without it the same text gives other
    logits."""
    _, pcfg, _, pp = vlm
    toks, pfx = _inputs(pcfg, 1, 5, seed=4)
    P = pcfg.num_prefix_embeds
    with_pfx, _ = PT.lm_prefill(pp, pcfg, _port_batch(toks, pfx),
                                PT.init_lm_cache(pcfg, 1, 16, device="cpu"),
                                last_pos=[P + 4])
    alone, _ = PT.lm_prefill(pp, pcfg,
                             {"tokens": torch.from_numpy(toks).long()},
                             PT.init_lm_cache(pcfg, 1, 16, device="cpu"))
    assert not torch.allclose(with_pfx, alone, atol=1e-3)


# the JAX Server's own draw, batch 2, max_seq 32; requests from seed 0
LENS = [(5, 6), (11, 4), (2, 8), (7, 3)]


def _reqs(vocab, cls):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, vocab, p).astype(np.int32), g)
            for i, (p, g) in enumerate(LENS)]


@pytest.fixture(scope="module")
def jax_server_tokens():
    jcfg = jax_config(ARCH).reduced()
    srv = jax_serve.Server(jcfg, 2, 32, seed=0)
    done = srv.serve_batch(_reqs(jcfg.vocab_size, jax_serve.Request))
    return srv.params, {r.uid: r.generated for r in done}


@PALLAS
def test_server_gives_the_jax_servers_tokens(jax_server_tokens, use_pallas):
    """The port's ``Server`` holding the JAX ``Server``'s weights serves
    token prompts, as the JAX one does."""
    jparams, want = jax_server_tokens
    pcfg = get_config(ARCH).reduced()
    srv = Server(pcfg, 2, 32, seed=0, device="cpu")
    srv.params = srv.scheduler.params = lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), pcfg)
    with ops.use_pallas_scoped(use_pallas):
        done = srv.serve_batch(_reqs(pcfg.vocab_size, Request))
    assert {r.uid: r.generated for r in done} == want
    assert [len(want[i]) for i in range(len(LENS))] == [g for _, g in LENS]


def test_server_batch_matches_its_batch1_oracle():
    cfg = get_config(ARCH).reduced()
    srv = Server(cfg, 2, 32, seed=0, device="cpu")
    done = srv.serve_batch(_reqs(cfg.vocab_size, Request))
    for r in done:
        solo = Server(cfg, 1, 32, seed=0, device="cpu")
        alone = Request(r.uid, r.prompt, r.max_new_tokens)
        solo.serve_batch([alone])
        assert r.generated == alone.generated
