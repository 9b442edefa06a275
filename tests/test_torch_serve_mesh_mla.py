"""MLA served over a data x model mesh: ``launch/steps.py::build_step``'s
prefill and decode bundles for deepseek-v3 (``mla.mla_attention_tp``'s
prefill, B9 per rank, and ``mla.mla_decode_mesh``, the absorbed path as
a flash-decode over the latent cache's slices).

Reduced f32 deepseek-v3 (its dense MLA layer, an MoE layer) on meshes
(1, 2), (2, 2) and (1, 4) of the CPU, with the kernels' routes on (their
plain versions here), against the JAX package's jitted one-device
``make_prefill_step`` / ``make_decode_step`` on the same weights
(``convert.lm_params_from_jax``): the JAX sharded path is among the
reference failures, so the one-device step is the oracle.  A prompt of
4 tokens into a 32-row cache, then 3 greedy decode steps at per-row
positions: row 0 inside rank 0's slice of the sequence at every M (the
other ranks see no key of it and weigh exactly 0), row 1 past unwritten
rows.  Held: the logits within ``LOGIT_REL`` of their largest entry,
the same greedy tokens, and every cache shard equal to the block of the
JAX cache its spec names.  The helpers here (the JAX run, the mesh run,
the shard check) serve the encoder-decoder's and the batch-1 long
context's files too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import steps as JS
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import encdec_params_from_jax, lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as PT
from repro_torch.models.parallel import Group
from repro_torch.tree import leaves
from test_torch_train_mesh import one_thread  # noqa: F401

B, MAX, PROMPT = 2, 32, 4
POSITIONS = [np.array([4, 13]) + i for i in range(3)]
MESHES = ((1, 2), (2, 2), (1, 4))
LOGIT_REL, CACHE_ABS = 1e-4, 1e-5
ARCH = "deepseek-v3-671b"


def cfgs(arch, **changes):
    """The reduced JAX and port configs of ``arch``, with ``changes``."""
    return (dataclasses.replace(jax_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def prompt(cfg, batch, length, seed=0):
    """``batch`` rows of ``length`` token ids (and an encoder-decoder's
    source frames, the config's ``encoder_seq_len`` of them), numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (batch, length)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["src_embeds"] = rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def jax_serve(jcfg, batch, max_seq, positions, shape_name="decode"):
    """The JAX one-device prefill and greedy decode, jitted: (numpy
    parameters, [logits of the prefill and of each step], [greedy
    tokens], [numpy caches after the prefill and after each step]).
    ``positions``: each step's (B,) array, or an int for every row."""
    init = JE.init_encdec if jcfg.is_encoder_decoder else JT.init_lm
    jp = init(jax.random.PRNGKey(0), jcfg)
    rows = batch["tokens"].shape[0]
    prefill = jax.jit(JS.make_prefill_step(
        jcfg, JaxShapeConfig("prefill", max_seq, rows, "prefill")))
    decode = jax.jit(JS.make_decode_step(
        jcfg, JaxShapeConfig(shape_name, max_seq, rows, "decode")))
    logits, caches = prefill(jp, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    out, toks = [np.asarray(logits)], []
    kept = [jax.tree.map(np.asarray, caches)]
    for p in positions:
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, caches = decode(jp, caches, tok, jnp.asarray(p, jnp.int32))
        out.append(np.asarray(logits))
        kept.append(jax.tree.map(np.asarray, caches))
    return jax.tree.map(np.asarray, jp), out, toks, kept


def port_params(jparams, cfg):
    convert = (encdec_params_from_jax if cfg.is_encoder_decoder
               else lm_params_from_jax)
    return convert(jparams, cfg)


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def mesh_serve(cfg, params, mesh, batch, max_seq, positions,
               shape_name="decode", check=None):
    """The bundles' prefill and greedy decode on ``mesh``: (logits,
    tokens, caches).  ``check(caches, i)`` runs after the prefill (i =
    0) and after each decode step."""
    rows = batch["tokens"].shape[0]
    sp = SH.shard_params(params, mesh)
    pre = PS.build_step(cfg, ShapeConfig("prefill", max_seq, rows,
                                         "prefill"), mesh)
    dec = PS.build_step(cfg, ShapeConfig(shape_name, max_seq, rows,
                                         "decode"), mesh)
    with ops.use_pallas_scoped(True):
        logits, caches = pre.fn(sp, batch)
        out, toks = [logits], []
        if check:
            check(caches, 0)
        for i, p in enumerate(positions):
            tok = logits.argmax(-1, keepdim=True)
            toks.append(tok)
            pos = torch.as_tensor(p) if np.ndim(p) else int(p)
            logits, caches = dec.fn(sp, caches, tok, pos)
            out.append(logits)
            if check:
                check(caches, i + 1)
    return out, toks, caches


def port_layout(jcaches, cfg):
    """A JAX cache (numpy, stacked on a layer axis) in the port's
    layout: a list of layers, or ``{"self", "cross"}`` lists."""
    if cfg.is_encoder_decoder:
        return {part: [{k: v[i] for k, v in jcaches[part].items()}
                       for i in range(cfg.num_layers)]
                for part in ("self", "cross")}
    out = []
    for (repeats, types), seg in zip(PT.build_plan(cfg), jcaches):
        for r in range(repeats):
            out.extend({k: v[r] for k, v in seg["blocks"][pos].items()}
                       for pos in range(len(types)))
    return out


def check_shards(cfg, mesh, caches, jcaches, rows, max_seq):
    """Every shard equals, within ``CACHE_ABS``, the block of the JAX
    cache its spec names, and has the layout the spec gives."""
    want = leaves(port_layout(jcaches, cfg))
    specs = SH._spec_leaves(PS.cache_pspecs(
        PS.cache_specs(cfg, rows, max_seq), mesh, rows))
    assert len(want) == len(specs) == len(leaves(caches))
    for x, full, spec in zip(leaves(caches), want, specs):
        assert x._layout() == SH._placement(spec, mesh)
        blocks = x.place(torch.from_numpy(np.array(full)))
        for got, block in zip(x.shards, blocks.shards):
            assert float((got - block).abs().max()) <= CACHE_ABS, spec


def rel(got, want):
    want = torch.from_numpy(np.array(want))
    return float((got - want).abs().max() / want.abs().max())


def assert_serves_like_jax(cfg, jrun, mesh, batch, max_seq, positions,
                           shape_name="decode", check=None):
    """The mesh's logits, tokens and caches against ``jrun``
    (:func:`jax_serve`'s): the logits within ``LOGIT_REL`` of their
    largest entry at every step, the same greedy tokens, every cache
    shard the JAX block after the prefill and after the last step.
    Returns the mesh's caches."""
    jparams, jlogits, jtoks, jcaches = jrun
    rows = batch["tokens"].shape[0]

    def each(caches, i):
        if i == 0:
            check_shards(cfg, mesh, caches, jcaches[0], rows, max_seq)
        if check:
            check(caches, i)

    logits, toks, caches = mesh_serve(
        cfg, port_params(jparams, cfg), mesh, torch_batch(batch), max_seq,
        positions, shape_name, each)
    for i, (got, want) in enumerate(zip(logits, jlogits)):
        assert rel(got, want) <= LOGIT_REL, i
    for got, want in zip(toks, jtoks):
        assert np.array_equal(got.numpy(), want)
    check_shards(cfg, mesh, caches, jcaches[-1], rows, max_seq)
    return caches


_RUNS = {}


def _jax_run(heads=None):
    if heads not in _RUNS:
        changes = {} if heads is None else {"num_heads": heads,
                                            "num_kv_heads": heads}
        jcfg, _ = cfgs(ARCH, **changes)
        _RUNS[heads] = jax_serve(jcfg, prompt(jcfg, B, PROMPT), MAX,
                                 POSITIONS)
    return _RUNS[heads]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_mla_mesh_serving_matches_jax(mesh_shape):
    _, cfg = cfgs(ARCH)
    mesh = make_test_mesh(*mesh_shape, device="cpu")
    # row 0's positions lie in rank 0's slice of the latent cache only
    assert PS.cache_pspecs(PS.cache_specs(cfg, B, MAX), mesh,
                           B)[0]["ckv"][1] == "model"
    assert POSITIONS[-1][0] < MAX // mesh_shape[1]
    assert_serves_like_jax(cfg, _jax_run(), mesh, prompt(cfg, B, PROMPT),
                           MAX, POSITIONS)


def test_mla_heads_split_mid_head():
    """Three heads over two ranks: the cuts of ``wq_b``, ``wkv_b`` and
    ``wo_mla`` fall inside head 1, so each rank gathers the columns of
    its heads (``q_abs`` through W_uk, and W_uv) and both compute head
    1; the decode still matches the JAX one-device step."""
    _, cfg = cfgs(ARCH, num_heads=3, num_kv_heads=3)
    mesh = make_test_mesh(1, 2, device="cpu")
    m = cfg.mla
    assert (3 * m.v_head_dim) % 2 == 0 and (3 * m.v_head_dim // 2) \
        % m.v_head_dim
    assert_serves_like_jax(cfg, _jax_run(3), mesh, prompt(cfg, B, PROMPT),
                           MAX, POSITIONS)


def test_latent_cache_whole_when_model_does_not_divide_it():
    """A latent cache of 30 rows at M = 4: ``cache_pspecs`` leaves its
    sequence whole on every rank, and rank 0 alone computes the decode's
    partials (``attention.cache_regions``)."""
    _, cfg = cfgs(ARCH)
    mesh = make_test_mesh(1, 4, device="cpu")
    assert PS.cache_pspecs(PS.cache_specs(cfg, B, 30), mesh,
                           B)[0]["ckv"][1] is None
    jcfg, _ = cfgs(ARCH)
    run = jax_serve(jcfg, prompt(jcfg, B, PROMPT), 30, POSITIONS)
    assert_serves_like_jax(cfg, run, mesh, prompt(cfg, B, PROMPT), 30,
                           POSITIONS)


def test_mla_prefill_launches_the_kernel_per_rank(monkeypatch):
    """With the kernels on, the mesh's MLA prefill sends each rank's
    heads to B9 (here its plain version, as the CPU runs it) with the
    expanded widths and ``scale = 1/sqrt(qk_nope + qk_rope)``; the
    decode steps reach no kernel."""
    from repro_torch.kernels import ref

    _, cfg = cfgs(ARCH)
    mesh = make_test_mesh(1, 2, device="cpu")
    calls = []
    plain = ref.flash_attention_ref

    def record(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(v.shape), kw["scale"]))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(ref, "flash_attention_ref", record)
    params = PT.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = torch_batch(prompt(cfg, B, PROMPT))
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    mesh_serve(cfg, params, mesh, batch, MAX, POSITIONS[:1],
               check=lambda caches, i: calls.append(i))
    H = cfg.num_heads // 2
    want = (B, PROMPT, H, qk), (B, PROMPT, H, m.v_head_dim), 1 / np.sqrt(qk)
    # two MLA layers (the MTP head is not served) x two ranks, then the
    # check after the prefill and after the decode step
    assert [c for c in calls if c not in (0, 1)] == [want] * 4
    assert calls[-2:] == [0, 1]


def test_a_whole_mesh_combine_weighs_a_device_with_no_key_at_zero():
    """The whole mesh's combine (a batch every replica holds): a device
    whose slice holds no key of a row (max -inf, sum 0) weighs exactly
    0, every device gets the softmax of the whole row, and the result
    has no NaN."""
    gen = torch.Generator().manual_seed(0)
    group = Group(("cpu",) * 4)
    s = torch.randn(2, 1, 16, generator=gen)
    o_lat = torch.randn(2, 16, 5, generator=gen)
    s[0, :, 4:] = -float("inf")       # row 0: keys in device 0's slice
    s[1, :, :12] = -float("inf")      # row 1: keys in device 3's slice
    parts = []
    for d in range(4):
        sl = slice(4 * d, 4 * d + 4)
        m = s[..., sl].amax(-1)
        p = torch.exp(s[..., sl] - torch.where(torch.isneginf(m), 0.0,
                                               m)[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bht,btr->bhr", p,
                                                 o_lat[:, sl])))
    out = group.lse_combine(*map(list, zip(*parts)))
    want = torch.einsum("bht,btr->bhr", torch.softmax(s, -1), o_lat)
    assert all(torch.isfinite(o).all() for o in out)
    assert torch.allclose(out[0], want, atol=1e-6)
    assert all(torch.equal(o, out[0]) for o in out)
