"""The encoder-decoder served over a data x model mesh:
``launch/steps.py::build_step``'s prefill and decode bundles for
seamless-m4t-medium (``encdec.encdec_prefill_mesh``,
``encdec_decode_step_mesh``).

Reduced f32 seamless (2 encoder and 2 decoder layers, a source of its 16
frames) on meshes (1, 2), (2, 2) and (1, 4) of the CPU, with the
kernels' routes on, against the JAX package's jitted one-device
``make_prefill_step`` / ``make_decode_step`` on the same weights
(``convert.encdec_params_from_jax``): 2 lockstep rows, a prompt of 6
tokens into a 24-row self cache, 4 greedy decode steps.  Held: the
logits within ``LOGIT_REL`` of their largest entry, the same greedy
tokens, every shard of the self and cross caches equal to the block of
the JAX cache its spec names, and the cross cache's shards unchanged by
the decode steps (it is written once, at the prefill).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import encdec as PE
from repro_torch.tree import leaves
from test_torch_serve_mesh_mla import (LOGIT_REL, assert_serves_like_jax,
                                       cfgs, check_shards, jax_serve,
                                       mesh_serve, port_params, prompt, rel,
                                       torch_batch)
from test_torch_train_mesh import one_thread  # noqa: F401

ARCH = "seamless-m4t-medium"
B, MAX, PROMPT, STEPS = 2, 24, 6, 4
POSITIONS = [PROMPT + i for i in range(STEPS)]
MESHES = ((1, 2), (2, 2), (1, 4))

_RUN = {}


def _jax_run():
    if not _RUN:
        jcfg, _ = cfgs(ARCH)
        _RUN[0] = jax_serve(jcfg, prompt(jcfg, B, PROMPT), MAX, POSITIONS)
    return _RUN[0]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_encdec_mesh_serving_matches_jax(mesh_shape):
    _, cfg = cfgs(ARCH)
    mesh = make_test_mesh(*mesh_shape, device="cpu")
    cross = []

    def cross_unchanged(caches, i):
        shards = [s.clone() for x in leaves(caches["cross"])
                  for s in x.shards]
        if cross:
            assert all(torch.equal(a, b) for a, b in zip(shards, cross[0]))
        else:
            cross.append(shards)

    assert_serves_like_jax(cfg, _jax_run(), mesh, prompt(cfg, B, PROMPT),
                           MAX, POSITIONS, check=cross_unchanged)
    assert cross and any(s.any() for s in cross[0])


def test_encdec_prefill_launches_per_rank_in_three_roles(monkeypatch):
    """With the kernels on, each rank of a (1, 2) mesh sends B9 (its
    plain version here) the three attentions of the prefill: the
    encoder's non-causal self-attention over the frames, the decoder's
    causal self-attention over the prompt, and cross-attention of the
    prompt against the frames (Sq != T, non-causal), each at its heads;
    the decode steps reach no kernel."""
    _, cfg = cfgs(ARCH)
    mesh = make_test_mesh(1, 2, device="cpu")
    calls = []
    plain = ref.flash_attention_ref

    def record(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], q.shape[2], kw["causal"]))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(ref, "flash_attention_ref", record)
    params = PE.init_encdec(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    mesh_serve(cfg, params, mesh, torch_batch(prompt(cfg, B, PROMPT)), MAX,
               POSITIONS[:2], check=lambda caches, i: calls.append(i))
    T, H = cfg.encoder_seq_len, cfg.num_heads // 2
    enc, self_, cross = (T, T, H, False), (PROMPT, PROMPT, H, True), \
        (PROMPT, T, H, False)
    want = [enc] * 2 * cfg.num_encoder_layers \
        + [self_, self_, cross, cross] * cfg.num_layers
    assert calls == want + [0, 1, 2]


def test_encdec_source_must_fill_the_cross_cache():
    """The mesh's cross caches hold the source's frames, as the JAX
    prefill and the port's one-device prefill build them: a source one
    frame short of ``encoder_seq_len`` fills cross caches of its own
    length, laid out by ``cache_pspecs`` for that length, and the mesh
    serves it as the JAX package does."""
    jcfg, cfg = cfgs(ARCH)
    batch = prompt(jcfg, B, PROMPT)
    batch["src_embeds"] = batch["src_embeds"][:, :-1]
    jparams, jlogits, jtoks, jcaches = jax_serve(jcfg, batch, MAX,
                                                 POSITIONS)
    mesh = make_test_mesh(1, 2, device="cpu")
    logits, toks, caches = mesh_serve(cfg, port_params(jparams, cfg), mesh,
                                      torch_batch(batch), MAX, POSITIONS)
    for i, (got, want) in enumerate(zip(logits, jlogits)):
        assert rel(got, want) <= LOGIT_REL, i
    for got, want in zip(toks, jtoks):
        assert np.array_equal(got.numpy(), want)
    frames = dataclasses.replace(cfg, encoder_seq_len=cfg.encoder_seq_len - 1)
    assert caches["cross"][0]["k"].shape[1] == frames.encoder_seq_len
    check_shards(frames, mesh, caches, jcaches[-1], B, MAX)
