"""The port's sharding rule engine (``repro_torch/models/sharding.py``)
against the JAX package's, and its placement of trees on a mesh.

For every arch at full width (a ``jax.eval_shape`` tree on the JAX side,
a ``device="meta"`` init on the port's), on five meshes, the port's spec
of each leaf must equal the JAX spec of its counterpart, with the stack
dimension dropped for a layer leaf (the JAX package stacks its layers on
a leading axis, the port lists them); the same for AdamW's moments.  The
mesh objects are the port's ``NamedMesh``, which the JAX rule engine
reads as it reads a JAX ``Mesh`` (axis names and sizes only).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import optim as JO
from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.launch.steps import params_specs as jax_params_specs
from repro.models import sharding as JSH
from repro_torch import optim as PO
from repro_torch.configs import get_config
from repro_torch.launch.mesh import NamedMesh, make_test_mesh
from repro_torch.models import encdec as PE
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves

MESHES = {"data4": (4, 1, 1), "data8": (8, 1, 1), "data2_model2": (2, 2, 1),
          "data4_model4": (4, 4, 1), "pod2_data2_model2": (2, 2, 2)}


def _mesh(name):
    data, model, pod = MESHES[name]
    return make_test_mesh(data, model, pod, device="cpu")


def _spec(p):
    return tuple(p)


def _is_spec(x):
    return isinstance(x, P)


def _drop_stack(tree):
    """A JAX spec tree of stacked leaves, each spec without its leading
    (stack) entry."""
    return jax.tree.map(lambda p: _spec(p)[1:] if len(p) else (), tree,
                        is_leaf=_is_spec)


def _plain(tree):
    return jax.tree.map(_spec, tree, is_leaf=_is_spec)


def _port_layout(jspecs, cfg):
    """The JAX spec tree rearranged as ``convert.py`` rearranges the
    parameters: layers listed in the order the JAX scan applies them."""
    if cfg.is_encoder_decoder:
        out = {k: _plain(jspecs[k]) for k in ("embed", "final_norm",
                                              "lm_head") if k in jspecs}
        for part, n in (("encoder", cfg.num_encoder_layers),
                        ("decoder", cfg.num_layers)):
            blocks = _drop_stack(jspecs[part]["blocks"])
            out[part] = {"blocks": [blocks] * n,
                         "norm": _plain(jspecs[part]["norm"])}
        return out
    out = {k: _plain(jspecs[k]) for k in ("embed", "final_norm", "lm_head",
                                          "mtp") if k in jspecs}
    layers = []
    for (repeats, types), seg in zip(PT.build_plan(cfg), jspecs["segments"]):
        for _ in range(repeats):
            layers.extend(_drop_stack(seg["blocks"][pos])
                          for pos in range(len(types)))
    out["layers"] = layers
    return out


def _flat(tree, path=""):
    """{path: spec} of a spec tree (dicts and lists; a spec is a tuple)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: tree}


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(JAX params and moments as ShapeDtypeStructs, the port's on the
    meta device), at full width."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    jparams = jax_params_specs(jcfg)
    jmoments = jax.eval_shape(JO.adamw(1e-3).init, jparams)
    init = PE.init_encdec if cfg.is_encoder_decoder else PT.init_lm
    params = init(None, cfg, device="meta")
    moments = PO.adamw(1e-3).init(params)
    return cfg, jparams, jmoments, params, moments


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_params_pspecs_match_jax(arch, mesh_name):
    cfg, jparams, jmoments, params, moments = _trees(arch)
    mesh = _mesh(mesh_name)
    for jtree, tree in ((jparams, params), (jmoments["m"], moments["m"]),
                        (jmoments["v"], moments["v"])):
        want = _flat(_port_layout(JSH.params_pspecs(jtree, mesh), cfg))
        got = _flat(SH.params_pspecs(tree, mesh))
        assert got.keys() == want.keys()
        bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        assert not bad, bad
    # the moments' tree, whole: its paths carry an "m/" or "v/" prefix
    want = JSH.params_pspecs(jmoments, mesh)
    got = SH.params_pspecs(moments, mesh)
    for key in ("m", "v"):
        assert _flat(got[key]) == _flat(_port_layout(want[key], cfg))


def test_every_leaf_is_covered_and_some_are_sharded():
    """On a data mesh of 4, qwen2-7b shards its big matrices (FSDP) and
    replicates its norms, as the JAX rules do."""
    _, _, _, params, _ = _trees("qwen2-7b")
    specs = _flat(SH.params_pspecs(params, _mesh("data4")))
    assert specs["/embed/w"] == ("model", "data")
    assert specs["/layers/0/attn/wq/w"] == ("data", "model")
    assert specs["/layers/0/mixer_norm/scale"] == ()
    assert len(specs) == len(leaves(params))


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 4}


def test_rules_shard_ffn_and_embed():
    params = {
        "embed": {"w": torch.empty((512, 64), device="meta")},
        "layers": [{
            "ffn": {"gate": {"w": torch.empty((64, 256), device="meta")},
                    "down": {"w": torch.empty((256, 64), device="meta")}},
            "mixer_norm": {"scale": torch.empty((64,), device="meta")},
        }],
    }
    specs = SH.params_pspecs(params, FakeMesh())
    assert specs["embed"]["w"] == ("model", "data")
    blk = specs["layers"][0]
    assert blk["ffn"]["gate"]["w"] == ("data", "model")
    assert blk["ffn"]["down"]["w"] == ("model", "data")
    assert blk["mixer_norm"]["scale"] == ()


def test_rules_respect_divisibility():
    params = {"ffn": {"gate": {"w": torch.empty((7, 9), device="meta")}}}
    specs = SH.params_pspecs(params, FakeMesh())
    assert specs["ffn"]["gate"]["w"] == (None, None)   # 7, 9 not divisible


def test_moe_expert_sharding():
    """Experts over 'data' (expert parallelism), ff over 'model': the
    expert rules precede the dense (gate|up)$ rule."""
    params = {"moe": {"experts": {
        "gate": torch.empty((8, 64, 128), device="meta"),
        "down": torch.empty((8, 128, 64), device="meta")}}}
    specs = SH.params_pspecs(params, FakeMesh())
    assert specs["moe"]["experts"]["gate"] == ("data", None, "model")
    assert specs["moe"]["experts"]["down"] == ("data", "model", None)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_and_kv_cache_pspecs_match_jax(mesh_name):
    mesh = _mesh(mesh_name)
    assert SH.data_axes(mesh) == JSH.data_axes(mesh)
    for ndim, batch_dim, batch_size in ((2, 0, None), (3, 0, 16), (3, 0, 3),
                                        (4, 1, 8), (2, 1, 6)):
        assert SH.batch_pspec(mesh, ndim, batch_dim, batch_size) == _spec(
            JSH.batch_pspec(mesh, ndim, batch_dim, batch_size))
    for batch, ndim, batch_dim, seq_dim in ((8, 4, 0, 1), (1, 4, 0, 1),
                                            (3, 5, 1, 2), (16, 5, 1, 2)):
        kw = dict(batch=batch, ndim=ndim, batch_dim=batch_dim,
                  seq_dim=seq_dim)
        assert SH.kv_cache_pspec(mesh, **kw) == _spec(
            JSH.kv_cache_pspec(mesh, **kw))


def _tree(rng):
    return {"embed": {"w": torch.from_numpy(
                rng.normal(size=(16, 8)).astype(np.float32))},
            "final_norm": {"scale": torch.ones(8, dtype=torch.bfloat16)},
            "layers": [{"ffn": {"down": {"w": torch.from_numpy(
                rng.normal(size=(12, 8)).astype(np.float32))}}}]}


@pytest.mark.parametrize("shape", [(4, 1, 1), (2, 1, 2), (1, 1, 1)])
def test_shard_params_places_and_gathers(shape):
    """Each leaf is cut along the dimension its spec puts on the data
    axes, chunk d % parts on device d; a replicated leaf is copied to
    every device; gathering gives the tree back, and no shard aliases
    the caller's tensor."""
    data, model, pod = shape
    mesh = make_test_mesh(data, model, pod, device="cpu")
    tree = _tree(np.random.default_rng(0))
    sharded = SH.shard_params(tree, mesh)
    emb = sharded["embed"]["w"]            # ("model", "data"): d_model cut
    assert isinstance(emb, SH.Sharded)
    assert emb.shape == (16, 8) and len(emb.shards) == mesh.size
    norm = sharded["final_norm"]["scale"]
    assert norm.parts == 1 and norm.dim is None
    assert all(torch.equal(s, tree["final_norm"]["scale"])
               for s in norm.shards)
    if mesh.size > 1:
        # on a pod mesh the "data" dim is cut in `data` parts, replicated
        # over pods
        assert emb.dim == 1 and emb.parts == data
        assert emb.shards[0].shape == (16, 8 // data)
        for d, s in enumerate(emb.shards):
            k = d % emb.parts
            assert torch.equal(s, tree["embed"]["w"][:, k * s.shape[1]:
                                                       (k + 1) * s.shape[1]])
    back = SH.gather_params(sharded, "cpu")
    for a, b in zip(leaves(back), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ptrs = {t.data_ptr() for t in leaves(tree)}
    assert not any(s.data_ptr() in ptrs for x in leaves(sharded)
                   for s in x.shards)
    assert emb.place(tree["embed"]["w"] * 2).gather("cpu").equal(
        tree["embed"]["w"] * 2)


def jax_slice(spec, shape, mesh, d):
    """The index of device d's block of a ``shape`` leaf under the JAX
    ``PartitionSpec`` ``spec`` on ``mesh``: a dimension on axes (a name
    or a tuple of names) is cut into their product of chunks, and device
    d takes the chunk at its coordinates on those axes, row-major in the
    tuple's order; the mesh's devices are row-major over its axes."""
    coords = dict(zip(mesh.axis_names, np.unravel_index(d, mesh.sizes)))
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    index = []
    for dim, ax in zip(shape, spec):
        k, n = 0, 1
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            k, n = k * mesh.shape[a] + int(coords[a]), n * mesh.shape[a]
        index.append(slice(k * (dim // n), (k + 1) * (dim // n)))
    return tuple(index)


def test_a_model_axis_raises():
    """A ``model`` axis, once refused, now places the tree: on the (2, 2)
    mesh every device's shard is the block the JAX specs name."""
    mesh = make_test_mesh(2, 2, device="cpu")
    tree = _tree(np.random.default_rng(0))
    sharded = SH.shard_params(tree, mesh)
    specs = _flat(JSH.params_pspecs(
        jax.tree.map(lambda t: np.asarray(t.float()), tree), mesh))
    assert specs["/embed/w"] == P("model", "data")
    assert specs["/layers/0/ffn/down/w"] == P("model", "data")
    wholes = _flat(tree)
    for path, x in _flat(sharded).items():
        whole = wholes[path]
        assert len(x.shards) == 4
        for d, shard in enumerate(x.shards):
            want = whole[jax_slice(specs[path], whole.shape, mesh, d)]
            assert torch.equal(shard, want), (path, d)
    assert sharded["embed"]["w"].shards[1].shape == (8, 4)
    for a, b in zip(leaves(SH.gather_params(sharded, "cpu")), leaves(tree)):
        assert torch.equal(a, b)


def test_make_test_mesh():
    import inspect

    from repro.launch import mesh as JM

    # the JAX signature's defaults: a (data 2, model 2) mesh
    want = {k: v.default for k, v in inspect.signature(
        JM.make_test_mesh).parameters.items()}
    got = {k: v.default for k, v in inspect.signature(
        make_test_mesh).parameters.items() if k in want}
    assert got == want == {"data": 2, "model": 2, "pod": 1}
    default = make_test_mesh(device="cpu")
    assert default.axis_names == ("data", "model")
    assert default.shape == {"data": 2, "model": 2}
    assert default.ranks == 2 and len(default.replicas) == 2
    mesh = make_test_mesh(4, 1, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 4, "model": 1}
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.replicas == tuple((torch.device("cpu"),) for _ in range(4))
    pod = make_test_mesh(2, 1, 2, device="cpu")
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.shape == {"pod": 2, "data": 2, "model": 1} and pod.size == 4
    explicit = make_test_mesh(2, 1, devices=("cpu", "cpu"))
    assert explicit.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_test_mesh(2, 1, devices=("cpu",))
    with pytest.raises(ValueError, match="not both"):
        make_test_mesh(2, 1, device="cpu", devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="needs 3 devices"):
        NamedMesh(("data",), (3,), (torch.device("cpu"),))


def test_batch_rows_order():
    """Microbatch g keeps rows [g·B/G, (g+1)·B/G); device d takes the
    d-th contiguous block of each."""
    x = torch.arange(8)
    assert SH.batch_rows(x, 2, 2, 0).tolist() == [0, 1, 4, 5]
    assert SH.batch_rows(x, 2, 2, 1).tolist() == [2, 3, 6, 7]
    assert SH.batch_rows(x, 4, 1, 3).tolist() == [6, 7]
    assert SH.batch_rows(x, 1, 2, 0).tolist() == list(range(8))
    with pytest.raises(ValueError, match="does not split"):
        SH.batch_rows(x, 3, 1, 0)
    shards = SH.shard_batch({"tokens": x[:, None]},
                            make_test_mesh(2, 1, device="cpu"), 2)
    assert [s["tokens"][:, 0].tolist() for s in shards] == [[0, 1, 4, 5],
                                                           [2, 3, 6, 7]]
