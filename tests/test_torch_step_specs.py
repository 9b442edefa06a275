"""The port's step specs and bundles (``repro_torch/launch/steps.py``)
against the JAX package's.

For every arch at full width: ``batch_specs``, ``cache_specs`` and
``params_specs`` (``device="meta"`` trees on the port's side,
``jax.eval_shape`` stand-ins on the JAX side) give the same shapes and
dtypes, a layer leaf against its JAX stack without the stack dimension;
``cache_pspecs`` gives each cache leaf the JAX spec without its stack
entry, on the five meshes of ``test_torch_sharding.py``, for a batch the
data axes divide and one they do not, and for a cache length ``model``
divides and one it does not; ``build_step``'s spec trees are the ones
the JAX bundle assembles from ``params_pspecs``, ``cache_pspecs`` and
``batch_pspec`` (the JAX ``build_step`` itself needs a real JAX mesh).
"""

import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.launch import steps as JS
from repro.models import sharding as JSH
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import encdec as ED
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves
from test_torch_sharding import MESHES, _flat, _mesh, _port_layout

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# (batch, cache rows): the data axes of every test mesh divide 8 and none
# divides 3; model 4 divides 4096 and not 4098
CACHE_CASES = {"divides": ((8, 4096), (8, 4098)),
               "does_not_divide": ((3, 4096), (3, 4098))}
# the two families served over a mesh since the serving mesh took MLA
# and the encoder-decoder
MESH_SERVED = ("deepseek-v3-671b", "seamless-m4t-medium")


def _is_leaf(x):
    return isinstance(x, (P, jax.ShapeDtypeStruct))


def _sds(a):
    return tuple(a.shape), str(a.dtype)


def _sds_layer(a):
    """A stacked stand-in's one layer."""
    return tuple(a.shape[1:]), str(a.dtype)


def _meta(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _unstack_cache(jtree, cfg, drop):
    """A JAX cache tree (stacked leaves) in the port's layout, each leaf
    through ``drop``."""
    def each(tree):
        return jax.tree.map(drop, tree, is_leaf=_is_leaf)

    if cfg.is_encoder_decoder:
        return {k: [each(jtree[k])] * cfg.num_layers
                for k in ("self", "cross")}
    layers = []
    for (repeats, types), seg in zip(PT.build_plan(cfg), jtree):
        for _ in range(repeats):
            layers.extend(each(seg["blocks"][pos])
                          for pos in range(len(types)))
    return layers


def _unstack_params(jtree, cfg):
    """A JAX parameter tree of stand-ins in the port's layout, as
    ``test_torch_sharding._port_layout`` rearranges spec trees."""
    if cfg.is_encoder_decoder:
        out = {k: jax.tree.map(_sds, jtree[k], is_leaf=_is_leaf)
               for k in ("embed", "final_norm", "lm_head") if k in jtree}
        for part, n in (("encoder", cfg.num_encoder_layers),
                        ("decoder", cfg.num_layers)):
            blocks = jax.tree.map(_sds_layer, jtree[part]["blocks"],
                                  is_leaf=_is_leaf)
            out[part] = {"blocks": [blocks] * n,
                         "norm": jax.tree.map(_sds, jtree[part]["norm"],
                                              is_leaf=_is_leaf)}
        return out
    out = {k: jax.tree.map(_sds, jtree[k], is_leaf=_is_leaf)
           for k in ("embed", "final_norm", "lm_head", "mtp") if k in jtree}
    layers = []
    for (repeats, types), seg in zip(PT.build_plan(cfg), jtree["segments"]):
        for _ in range(repeats):
            layers.extend(jax.tree.map(_sds_layer, seg["blocks"][pos],
                                       is_leaf=_is_leaf)
                          for pos in range(len(types)))
    out["layers"] = layers
    return out


def _flat_meta(tree):
    return {k: _meta(v) for k, v in _flat(tree).items()}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JS.params_specs(jax_config(arch))


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, batch, seq):
    return JS.cache_specs(jax_config(arch), batch, seq)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return PS.params_specs(get_config(arch))


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_jax(arch, shape_name):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jshape, shape = JAX_SHAPES[shape_name], SHAPES[shape_name]
    want = {k: _sds(v) for k, v in JS.batch_specs(jcfg, jshape).items()}
    assert {k: _meta(v) for k, v in PS.batch_specs(cfg, shape).items()} \
        == want
    B, S = shape.global_batch, shape.seq_len
    want = _flat(_unstack_cache(_jax_cache(arch, B, S), cfg, _sds_layer))
    assert _flat_meta(PS.cache_specs(cfg, B, S)) == want


@pytest.mark.parametrize("arch", list_archs())
def test_params_specs_match_jax(arch):
    cfg = get_config(arch)
    want = _flat(_unstack_params(_jax_params(arch), cfg))
    got = _flat_meta(_port_params(arch))
    assert got == want
    assert all(t.device.type == "meta" for t in
               _flat(_port_params(arch)).values())


@pytest.mark.parametrize("batch_case", sorted(CACHE_CASES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_pspecs_match_jax(arch, mesh_name, batch_case):
    cfg = get_config(arch)
    mesh = _mesh(mesh_name)
    for B, S in CACHE_CASES[batch_case]:
        jspecs = JS.cache_pspecs(_jax_cache(arch, B, S), mesh, B)
        want = _flat(_unstack_cache(jspecs, cfg, lambda p: tuple(p)[1:]))
        got = _flat(PS.cache_pspecs(PS.cache_specs(cfg, B, S), mesh, B))
        assert got == want, (B, S)


def _jax_bundle_specs(arch, shape_name, mesh):
    """The spec trees the JAX ``build_step`` assembles, in the port's
    layout: (in_shardings, out_shardings)."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    shape = JAX_SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    p_shard = _port_layout(JSH.params_pspecs(_jax_params(arch), mesh), cfg)
    b_shard = {k: tuple(JSH.batch_pspec(mesh, v.ndim, 0, B))
               for k, v in JS.batch_specs(jcfg, shape).items()}
    if shape.kind == "train":
        opt = JS.make_optimizer(jcfg)
        jopt = jax.eval_shape(opt.init, _jax_params(arch))
        o_shard = {k: _port_layout(JSH.params_pspecs(jopt[k], mesh), cfg)
                   for k in ("m", "v")}
        return (p_shard, o_shard, (), b_shard), (p_shard, o_shard, None)
    c_shard = _unstack_cache(JS.cache_pspecs(_jax_cache(arch, B, S), mesh, B),
                             cfg, lambda p: tuple(p)[1:])
    if shape.kind == "prefill":
        b_shard.pop("labels")
        return (p_shard, b_shard), (None, c_shard)
    scalar = (jcfg.is_encoder_decoder
              or JS.decode_window(jcfg, shape) is not None)
    pos = () if scalar else tuple(JSH.batch_pspec(mesh, 1, 0, B))
    return ((p_shard, c_shard, tuple(JSH.batch_pspec(mesh, 2, 0, B)), pos),
            (None, c_shard))


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", list_archs())
def test_bundle_specs_match_jax(arch, shape_name):
    # one mesh: the pod axis's specs are held by the cache and parameter
    # tests, and each bundle builds the whole parameter tree
    cfg, mesh = get_config(arch), _mesh("pod2_data2_model2")
    shape = SHAPES[shape_name]
    bundle = PS.build_step(cfg, shape, mesh)
    want_in, want_out = _jax_bundle_specs(arch, shape_name, mesh)
    if shape.kind == "train":
        p, o, step, b = bundle.in_shardings
        got_in = (_flat(p), {k: _flat(o[k]) for k in ("m", "v")}, step, b)
        want_in = (_flat(want_in[0]),
                   {k: _flat(want_in[1][k]) for k in ("m", "v")},
                   want_in[2], want_in[3])
        assert set(o) == {"m", "v"}
        assert got_in == want_in
        assert _flat(bundle.out_shardings[0]) == _flat(want_out[0])
        assert bundle.out_shardings[2] is None
    else:
        got = [(_flat(x) if isinstance(x, (dict, list)) else x)
               for x in bundle.in_shardings]
        want = [(_flat(x) if isinstance(x, (dict, list)) else x)
                for x in want_in]
        assert got == want
        assert bundle.out_shardings[0] is None
        assert _flat(bundle.out_shardings[1]) == _flat(want_out[1])
    # the stand-ins are the bundle's inputs, on the meta device
    for arg in bundle.args:
        for t in _flat(arg).values() if isinstance(arg, (dict, list)) \
                else [arg]:
            assert t.device.type == "meta"


@pytest.mark.parametrize("arch", MESH_SERVED)
def test_mla_and_encdec_serve_on_one_device(arch):
    """MLA and the encoder-decoder build on one device (no mesh, and a
    one-device mesh) and over a mesh of more than one: the (1, 2) and
    (2, 2) bundles carry the JAX cache specs, and each serves its
    reduced config, a prefill and a decode step, with finite logits."""
    cfg = get_config(arch)
    for shape_name in ("prefill_32k", "decode_32k"):
        shape = SHAPES[shape_name]
        assert PS.build_step(cfg, shape).in_shardings is None
        PS.build_step(cfg, shape, make_test_mesh(1, 1, device="cpu"))
        for data, model in ((1, 2), (2, 2)):
            mesh = make_test_mesh(data, model, device="cpu")
            bundle = PS.build_step(cfg, shape, mesh)
            want = _flat(_unstack_cache(JS.cache_pspecs(
                _jax_cache(arch, shape.global_batch, shape.seq_len), mesh,
                shape.global_batch), cfg, lambda p: tuple(p)[1:]))
            assert _flat(bundle.out_shardings[1]) == want
    small = get_config(arch).reduced()
    mesh = make_test_mesh(1, 2, device="cpu")
    B, S = 2, 4
    gen = torch.Generator().manual_seed(0)
    init = ED.init_encdec if small.is_encoder_decoder else PT.init_lm
    params = SH.shard_params(init(gen, small, device="cpu"), mesh)
    batch = {"tokens": torch.randint(0, small.vocab_size, (B, S),
                                     generator=gen)}
    if small.is_encoder_decoder:
        batch["src_embeds"] = torch.randn(B, small.encoder_seq_len,
                                          small.d_model, generator=gen)
    pre = PS.build_step(small, SHAPES["prefill_32k"].__class__(
        "prefill", 16, B, "prefill"), mesh)
    dec = PS.build_step(small, SHAPES["decode_32k"].__class__(
        "decode", 16, B, "decode"), mesh)
    logits, caches = pre.fn(params, batch)
    pos = S if small.is_encoder_decoder else torch.full((B,), S)
    logits, _ = dec.fn(params, caches, logits.argmax(-1, keepdim=True), pos)
    assert logits.shape == (B, small.vocab_size)
    assert torch.isfinite(logits).all()


def test_shard_cache_places_a_dimension_on_two_axes():
    """The batch-1 long-context layout cuts a cache's sequence over
    (data, model): ``shard_cache`` places it in ``mesh.size`` slices in
    the mesh's device order (``model`` innermost) instead of refusing
    it, the other leaves whole over data; with a length only ``data``
    divides, the sequence goes over ``data`` alone, whole over
    ``model``.  Placing a whole cache and gathering it back is the
    identity; a batch the data axes divide is placed as before."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    mesh = make_test_mesh(2, 2, device="cpu")
    cache = PS.cache_specs(cfg, 1, 64)
    attn = next(i for i, layer in enumerate(cache) if "k" in layer)
    ssm = next(i for i, layer in enumerate(cache) if "ssm" in layer)
    assert PS.cache_pspecs(cache, mesh, 1)[attn]["k"][1] == ("data", "model")
    placed = SH.shard_cache(cache, mesh, 1)
    assert SH.replicated(placed)
    k = placed[attn]["k"]
    assert (k.dim, k.parts, k.model_dim, k.model_parts) == (1, 2, 1, 2)
    assert [k.spans(d)[1] for d in range(4)] == [
        (0, 16), (16, 32), (32, 48), (48, 64)]
    assert tuple(k.shards[0].shape) == (1, 16, cfg.num_kv_heads,
                                        cfg.head_dim)
    assert all(not s.any() for s in k.shards)
    state = placed[ssm]["ssm"]
    assert state.dim is None and state.parts == 1
    gen = torch.Generator().manual_seed(0)
    whole = [{name: torch.randn(t.shape, generator=gen)
              for name, t in layer.items()} for layer in cache]
    back = SH.gather_cache(SH.shard_cache(whole, mesh, 1), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(whole)))
    # a length only data divides: the sequence over data, whole over model
    k66 = SH.shard_cache(PS.cache_specs(cfg, 1, 66), mesh, 1)[attn]["k"]
    assert [k66.spans(d)[1] for d in range(4)] == [
        (0, 33), (0, 33), (33, 66), (33, 66)]
    # a batch the data axes divide is placed: zeroed shards on the mesh
    cfg = get_config("qwen2-7b").reduced()
    placed = SH.shard_cache(PS.cache_specs(cfg, 4, 64), mesh, 4)
    k = placed[0]["k"]
    assert k.dim == 0 and k.parts == 2 and k.model_dim == 1
    assert tuple(k.shards[0].shape) == (2, 32, cfg.num_kv_heads,
                                        cfg.head_dim)
    assert all(not s.any() for s in k.shards)
    assert tuple(SH.gather_cache(placed, "cpu")[0]["k"].shape) == \
        (4, 64, cfg.num_kv_heads, cfg.head_dim)


def test_one_device_bundles_run_without_a_mesh():
    """``build_step`` without a mesh returns the one-device builders'
    steps, which serve a reduced arch."""
    cfg = get_config("gemma-2b").reduced()
    params = PT.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    pre = PS.build_step(cfg, SHAPES["prefill_32k"].__class__(
        "prefill", 16, 2, "prefill"))
    logits, _ = pre.fn(params, {"tokens": torch.zeros(
        (2, 4), dtype=torch.long)})
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits).all()
