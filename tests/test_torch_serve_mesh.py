"""Serving over a data x model mesh: ``launch/steps.py::build_step``'s
prefill and decode bundles on trees placed by ``shard_params``, caches
placed by ``shard_cache``.

A mesh repeats the CPU, ``(cpu,) * n``, as ``(cuda:0,) * n`` does on one
card: every cut, exchange and rank-order combine runs.  Reduced f32
jamba-v0.1 (Mamba-2, attention and MoE layers), llama4-scout (MoE with a
shared expert) and gemma-2b (one KV head, split mid-head at M = 2) on
meshes (1, 2), (2, 2) and (1, 4), with the kernels' routes on (their
plain versions on the CPU), against the JAX package's jitted one-device
``make_prefill_step`` / ``make_decode_step`` on the same weights
(``convert.lm_params_from_jax``): a prompt of 4 tokens into a 32-row
cache, then 3 greedy decode steps at per-row positions.  Row 0 decodes
at positions 4-6, inside rank 0's slice of the sequence at every M, so
the other ranks see no key of it; row 1 at 13-15, past unwritten rows.
Held: the logits within 1e-4 of their largest entry, the same greedy
tokens, and every cache shard within 1e-5 of the block of the JAX cache
that its spec names.  The other decoder-only families (qwen2-7b,
mamba2-2.7b, internvl2-26b with its prefix) are held against the port's
own one-device steps.
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
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention as PA
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as PT
from repro_torch.models.parallel import Group
from repro_torch.tree import leaves
from test_torch_train_mesh import one_thread  # noqa: F401

B, MAX, PROMPT, STEPS = 2, 32, 4, 3
POS0 = (PROMPT, 13)
MESHES = ((1, 2), (2, 2), (1, 4))
LOGIT_REL, CACHE_ABS = 1e-4, 1e-5
JAX_FAMILIES = ("jamba-v0.1-52b", "llama4-scout-17b-a16e", "gemma-2b")
PORT_FAMILIES = ("qwen2-7b", "mamba2-2.7b", "internvl2-26b")


def _cfgs(arch, d_state=None):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if d_state is not None:
        jcfg = dataclasses.replace(
            jcfg, ssm=dataclasses.replace(jcfg.ssm, d_state=d_state))
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, d_state=d_state))
    return jcfg, cfg


def _prompt(cfg):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT))}
    if cfg.num_prefix_embeds:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


_JAX_RUNS = {}


def _jax_run(arch, d_state=None):
    """The JAX one-device run, jitted once a config: (numpy parameters,
    [logits of the prefill and of each decode step], [greedy tokens],
    the caches after the prefill and after the last step, numpy)."""
    key = (arch, d_state)
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    jcfg, _ = _cfgs(arch, d_state)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    batch = {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
             for k, v in _prompt(jcfg).items()}
    prefill = jax.jit(JS.make_prefill_step(
        jcfg, JaxShapeConfig("prefill", MAX, B, "prefill")))
    decode = jax.jit(JS.make_decode_step(
        jcfg, JaxShapeConfig("decode", MAX, B, "decode")))
    logits, caches = prefill(jp, batch)
    out, toks = [np.asarray(logits)], []
    after_prefill = jax.tree.map(np.asarray, caches)
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, caches = decode(jp, caches, tok,
                                jnp.asarray(POS0, jnp.int32) + i)
        out.append(np.asarray(logits))
    _JAX_RUNS[key] = (jax.tree.map(np.asarray, jp), out, toks,
                      after_prefill, jax.tree.map(np.asarray, caches))
    return _JAX_RUNS[key]


def _mesh_run(cfg, params, mesh, batch, check_caches=None):
    """The bundles' prefill and greedy decode on ``mesh``: (logits,
    tokens, caches).  ``check_caches(caches, i)`` runs after the prefill
    (i = 0) and after each decode step.  ``mesh`` None: the bundles
    without a mesh, on the whole tree."""
    sp = params if mesh is None else SH.shard_params(params, mesh)
    prefill = PS.build_step(cfg, ShapeConfig("prefill", MAX, B, "prefill"),
                            mesh)
    decode = PS.build_step(cfg, ShapeConfig("decode", MAX, B, "decode"),
                           mesh)
    with ops.use_pallas_scoped(True):
        logits, caches = prefill.fn(sp, batch)
        out, toks = [logits], []
        if check_caches:
            check_caches(caches, 0)
        for i in range(STEPS):
            tok = logits.argmax(-1, keepdim=True)
            toks.append(tok)
            logits, caches = decode.fn(sp, caches, tok,
                                       torch.tensor(POS0) + i)
            out.append(logits)
            if check_caches:
                check_caches(caches, i + 1)
    return out, toks, caches


def _layers(jcaches, cfg):
    """The JAX LM caches (numpy, stacked) as the port's list of layers."""
    out = []
    for (repeats, types), seg in zip(PT.build_plan(cfg), jcaches):
        for r in range(repeats):
            out.extend({k: v[r] for k, v in seg["blocks"][pos].items()}
                       for pos in range(len(types)))
    return out


def _check_shards(cfg, mesh, caches, jcaches):
    """Every shard equals the block of the JAX cache its spec names."""
    want = leaves(_layers(jcaches, cfg))
    specs = SH._spec_leaves(PS.cache_pspecs(PS.cache_specs(cfg, B, MAX),
                                            mesh, B))
    for x, full, spec in zip(leaves(caches), want, specs):
        assert x._layout() == SH._placement(spec, mesh)
        blocks = x.place(torch.from_numpy(np.array(full)))
        for got, block in zip(x.shards, blocks.shards):
            assert float((got - block).abs().max()) <= CACHE_ABS, spec


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", JAX_FAMILIES)
def test_mesh_serving_matches_jax(arch, mesh_shape):
    _, cfg = _cfgs(arch)
    p0, jlogits, jtoks, jpre, jlast = _jax_run(arch)
    params = lm_params_from_jax(p0, cfg)
    mesh = make_test_mesh(*mesh_shape, device="cpu")
    M = mesh_shape[1]
    # row 0's positions lie in rank 0's slice of the sequence only
    assert POS0[0] + STEPS - 1 < MAX // M

    def check(caches, i):
        if i == 0:
            _check_shards(cfg, mesh, caches, jpre)

    logits, toks, caches = _mesh_run(cfg, params, mesh,
                                     _torch_batch(_prompt(cfg)), check)
    for got, want in zip(logits, jlogits):
        assert _rel(got, torch.tensor(want)) <= LOGIT_REL
    for got, want in zip(toks, jtoks):
        assert np.array_equal(got.numpy(), want)
    _check_shards(cfg, mesh, caches, jlast)


@pytest.mark.parametrize("d_state, mesh_shape, conv_cut", [
    (16, (1, 2), True), (16, (1, 4), True), (15, (1, 4), False)],
    ids=["x|xBC-M2", "x|x|x|xBC-M4", "whole-M4"])
def test_conv_cache_cut_across_x_b_c(d_state, mesh_shape, conv_cut):
    """jamba's conv tail (x | B | C channels) cut contiguously over
    ``model``: the cut falls inside x, so the last rank holds the end of
    x with all of B and C; with 542 channels (N = 15) M = 4 does not
    divide it and every rank holds it whole."""
    arch = "jamba-v0.1-52b"
    _, cfg = _cfgs(arch, d_state)
    mesh = make_test_mesh(*mesh_shape, device="cpu")
    s = cfg.ssm
    di, ch = s.d_inner(cfg.d_model), s.d_inner(cfg.d_model) + 2 * s.d_state
    spec = PS.cache_pspecs(PS.cache_specs(cfg, B, MAX), mesh, B)[0]["conv"]
    assert (spec[2] == "model") == conv_cut
    if conv_cut:
        M = mesh_shape[1]
        assert ch % M == 0 and (M - 1) * ch // M < di
    p0, jlogits, jtoks, _, jlast = (_jax_run(arch) if d_state == 16
                                    else _jax_run(arch, d_state))
    params = lm_params_from_jax(p0, cfg)
    logits, toks, caches = _mesh_run(cfg, params, mesh,
                                     _torch_batch(_prompt(cfg)))
    for got, want in zip(logits, jlogits):
        assert _rel(got, torch.tensor(want)) <= LOGIT_REL
    for got, want in zip(toks, jtoks):
        assert np.array_equal(got.numpy(), want)
    _check_shards(cfg, mesh, caches, jlast)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", PORT_FAMILIES)
def test_mesh_serving_matches_one_device(arch, mesh_shape):
    cfg = get_config(arch).reduced()
    params = PT.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _torch_batch(_prompt(cfg))
    npfx = cfg.num_prefix_embeds
    pos0 = torch.tensor(POS0) + npfx
    with torch.no_grad(), ops.use_pallas_scoped(True):
        logits, caches = PS.make_prefill_step(
            cfg, ShapeConfig("prefill", MAX, B, "prefill"))(params, batch)
        decode = PS.make_decode_step(cfg, ShapeConfig("decode", MAX, B,
                                                      "decode"))
        want = [logits]
        for i in range(STEPS):
            logits, caches = decode(params, caches,
                                    logits.argmax(-1, keepdim=True), pos0 + i)
            want.append(logits)
    mesh = make_test_mesh(*mesh_shape, device="cpu")
    sp = SH.shard_params(params, mesh)
    pre = PS.build_step(cfg, ShapeConfig("prefill", MAX, B, "prefill"), mesh)
    dec = PS.build_step(cfg, ShapeConfig("decode", MAX, B, "decode"), mesh)
    with ops.use_pallas_scoped(True):
        logits, got_caches = pre.fn(sp, batch)
        got = [logits]
        for i in range(STEPS):
            logits, got_caches = dec.fn(sp, got_caches,
                                        logits.argmax(-1, keepdim=True),
                                        pos0 + i)
            got.append(logits)
    for g, w in zip(got, want):
        assert _rel(g, w) <= LOGIT_REL
        assert torch.equal(g.argmax(-1), w.argmax(-1))
    for g, w in zip(leaves(SH.gather_cache(got_caches, "cpu")),
                    leaves(caches)):
        assert float((g - w).abs().max()) <= CACHE_ABS


def test_one_device_mesh_is_the_one_device_step():
    """On a one-device mesh the bundles run the one-device steps on its
    shards: bit for bit, caches included."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    params = PT.init_lm(torch.Generator().manual_seed(1), cfg, device="cpu")
    batch = _torch_batch(_prompt(cfg))
    mesh = make_test_mesh(1, 1, device="cpu")
    got, _, caches = _mesh_run(cfg, params, mesh, batch)
    want, _, want_caches = _mesh_run(cfg, params, None, batch)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(
        leaves(SH.gather_cache(caches, "cpu")), leaves(want_caches)))


def test_a_rank_that_sees_no_key_weighs_nothing():
    """The rank-order combine of flash-decode: a rank whose slice holds
    no position of a row (max -inf, sum 0) gets weight exactly 0, and
    the others' partials give the softmax of the whole row."""
    g = torch.Generator().manual_seed(0)
    group = Group(("cpu",) * 3)
    s = torch.randn(2, 12, generator=g)
    v = torch.randn(2, 12, 5, generator=g)
    s[0, 4:] = -float("inf")            # row 0: keys in rank 0's slice only
    ms, ls, os = [], [], []
    for j in range(3):
        sj, vj = s[:, 4 * j:4 * j + 4], v[:, 4 * j:4 * j + 4]
        m = sj.amax(-1)
        p = torch.exp(sj - torch.where(torch.isneginf(m), 0.0, m)[:, None])
        ms.append(m)
        ls.append(p.sum(-1))
        os.append(torch.einsum("bt,btd->bd", p, vj))
    out = group.lse_combine(ms, ls, os)
    want = torch.einsum("bt,btd->bd", torch.softmax(s, -1), v)
    assert all(torch.isfinite(o).all() for o in out)
    assert torch.allclose(out[0], want, atol=1e-6)
    assert all(torch.equal(o, out[0]) for o in out)


def test_cache_regions_tile_the_cache():
    """Each KV layout's decode regions cover every (row, head) once in
    each combine: a replica's ranks for a batch the data axes divide
    (the sequence cut over model, the KV-head cut, the whole cache on
    rank 0 alone), the whole mesh for one they do not (the sequence
    over (data, model), over data alone, the KV heads, or whole)."""
    cfg = get_config("qwen2-7b").reduced()
    K = cfg.num_kv_heads
    for (data, model), B, T in (((1, 2), 2, 16), ((1, 2), 2, 15),
                                ((1, 3), 3, 16), ((2, 2), 2, 16),
                                ((2, 2), 1, 16), ((2, 2), 1, 18),
                                ((2, 2), 1, 15), ((2, 3), 1, 15)):
        mesh = make_test_mesh(data, model, device="cpu")
        placed = SH.shard_cache(PS.cache_specs(cfg, B, T), mesh, B)
        k = placed[0]["k"]
        # every replica holds the whole batch where data does not divide it
        assert SH.replicated(placed) == bool(B % data)
        groups = [Group(g) for g in mesh.replicas]
        blocks = [k.spans(d)[1:3] for d in range(mesh.size)]
        assert all(tuple(s.shape[1:3]) == tuple(hi - lo for lo, hi in b)
                   for s, b in zip(k.shards, blocks))
        for scope in PA.decode_scopes(groups, SH.replicated(placed)):
            cover = torch.zeros(T, K, dtype=torch.long)
            for region in PA.cache_regions([blocks[d] for d in scope]):
                if region is not None:
                    (r0, r1), (h0, h1) = region
                    cover[r0:r1, h0:h1] += 1
            assert bool((cover == 1).all()), (data, model, B, T)


@pytest.mark.parametrize("arch", ("jamba-v0.1-52b", "deepseek-v3-671b"))
def test_init_lm_placed_part_by_part_is_shard_params(arch):
    """``init_lm(place=sharding.placer(mesh))`` draws the numbers that
    ``init_lm`` draws and cuts each part as ``shard_params`` cuts the
    whole tree: a layer's specs without the stack entry, the expert
    leaves marked, the MTP head (deepseek-v3) as its own part."""
    cfg = get_config(arch).reduced()
    mesh = make_test_mesh(2, 2, device="cpu")
    want = SH.shard_params(PT.init_lm(torch.Generator().manual_seed(3), cfg,
                                      device="cpu"), mesh)
    got = PT.init_lm(torch.Generator().manual_seed(3), cfg, device="cpu",
                     place=SH.placer(mesh))
    assert sorted(got) == sorted(want)
    assert len(leaves(got)) == len(leaves(want))
    for g, w in zip(leaves(got), leaves(want)):
        assert g._layout() == w._layout()
        assert all(torch.equal(a, b) for a, b in zip(g.shards, w.shards))


def test_a_placed_part_is_freed_at_once():
    """``init_lm(place=sharding.placer(mesh))`` frees each whole part as
    soon as it is cut, with the cyclic garbage collector off: no
    reference cycle (``tree.leaves``'s walk once was one) keeps a drawn
    layer alive beside the next, which at full width is what fits a
    model's draw on one card."""
    import gc
    import weakref

    cfg = get_config("deepseek-v3-671b").reduced()
    mesh = make_test_mesh(1, 2, device="cpu")
    cut = SH.placer(mesh)
    drawn = []

    def place(path, part):
        out = cut(path, part)
        assert all(r() is None for r in drawn), path
        drawn[:] = [weakref.ref(t) for t in leaves(part)]
        return out

    enabled = gc.isenabled()
    gc.disable()
    try:
        PT.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu",
                   place=place)
    finally:
        if enabled:
            gc.enable()
    assert drawn and all(r() is None for r in drawn)

