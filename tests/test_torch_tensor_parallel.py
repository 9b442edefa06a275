"""Tensor parallelism in the port: the placement of trees on a data x
model mesh (``models/sharding.py``), the collectives
(``models/parallel.py``) and the layers' tensor-parallel forms.

Placement is held to the JAX rule engine: for every arch's reduced
tree, and AdamW's moments, each device's shard must be the block the
JAX ``PartitionSpec`` names for that device's mesh coordinates (a mesh
here repeats the CPU).  The vocab-parallel embedding and cross-entropy
are held to the port's plain functions (which ``test_torch_train_loss``
holds to JAX), a vocab the ``model`` axis does not divide to the JAX
step, and a step at (1, 2) must hand no rank a whole projection matrix
that the rules cut over ``model``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import steps as JS
from repro.launch.steps import params_specs as jax_params_specs
from repro.models import sharding as JSH
from repro.models import transformer as JT
from repro_torch import optim as PO
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import encdec as PE
from repro_torch.models import layers as L
from repro_torch.models import parallel as PL
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves, tree_map, unflatten
from test_torch_sharding import _flat, _port_layout, jax_slice
from test_torch_train_mesh import one_thread  # noqa: F401

MESHES = {"data1_model2": (1, 2, 1), "data2_model2": (2, 2, 1),
          "data1_model4": (1, 4, 1), "pod2_data1_model2": (1, 2, 2)}
B, S = 8, 16
# projections that the rules cut over ``model``: never whole on a rank
PROJECTIONS = ("/wq/w", "/wk/w", "/wv/w", "/wo/w", "/gate/w", "/up/w",
               "/down/w", "/in_proj/w", "/out_proj/w", "/embed/w",
               "/lm_head/w")


def _mesh(name):
    data, model, pod = MESHES[name]
    return make_test_mesh(data, model, pod, device="cpu")


@pytest.fixture(scope="module")
def trees():
    """By arch: (cfg, the JAX reduced params' and moments' shape trees,
    the port's random params and moments on the CPU)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
            jparams = jax_params_specs(jcfg)
            jmoments = jax.eval_shape(JO.adamw(1e-3).init, jparams)
            init = PE.init_encdec if cfg.is_encoder_decoder else PT.init_lm
            gen = torch.Generator().manual_seed(0)
            params = init(gen, cfg, device="cpu")
            moments = {k: tree_map(lambda t: torch.randn(
                t.shape, generator=gen), params) for k in ("m", "v")}
            cache[arch] = cfg, jparams, jmoments, params, moments
        return cache[arch]
    return get


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_every_shard_is_the_block_the_jax_spec_names(arch, mesh_name,
                                                     trees):
    """Every leaf of the params and both moments, on every device; the
    gathered tree is the tree, bit for bit."""
    cfg, jparams, jmoments, params, moments = trees(arch)
    mesh = _mesh(mesh_name)
    for jtree, tree in ((jparams, params), (jmoments, moments)):
        specs = _flat(_port_layout(JSH.params_pspecs(jtree, mesh), cfg)
                      if jtree is jparams else
                      {k: _port_layout(v, cfg) for k, v in
                       JSH.params_pspecs(jtree, mesh).items()})
        sharded = SH.shard_params(tree, mesh)
        wholes = _flat(tree)
        placed = _flat(sharded)
        assert placed.keys() == specs.keys()
        for path, x in placed.items():
            whole = wholes[path]
            assert x.shape == whole.shape and len(x.shards) == mesh.size
            for d, shard in enumerate(x.shards):
                want = whole[jax_slice(specs[path], whole.shape, mesh, d)]
                assert torch.equal(shard, want), (path, d)
        for a, b in zip(leaves(SH.gather_params(sharded, "cpu")),
                        leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_collectives_sum_in_rank_order_and_differentiate():
    """all_reduce adds in rank order on rank 0's device and copies out;
    redistribute moves spans; both backward passes are the adjoints
    (gradcheck in float64)."""
    group = PL.Group(("cpu",) * 3)
    xs = [torch.tensor([1e8], dtype=torch.float32),
          torch.tensor([1.0]), torch.tensor([-1e8])]
    out = group.all_reduce(xs)
    assert [float(o) for o in out] == [float((xs[0] + xs[1]) + xs[2])] * 3
    assert len({o.data_ptr() for o in out}) == 3

    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float64,
                            requires_grad=True)

    have = [(0, 2), (2, 4), (4, 6)]
    want = [(1, 5), None, (0, 6)]
    ins = [t(2, 2), t(2, 2), t(2, 2)]
    got = group.redistribute(ins, have, want)
    full = torch.cat(ins, -1)
    assert got[1] is None
    assert torch.equal(got[0], full[:, 1:5]) and torch.equal(got[2], full)

    def f(*a):
        ys = group.redistribute(list(a), have, want)
        rs = group.all_reduce([ys[0].sum(-1), None, ys[2].sum(-1)])
        return tuple(ys[0]) + tuple(ys[2]) + tuple(rs)

    assert torch.autograd.gradcheck(f, tuple(ins))
    # a span every rank holds is read locally: a view, no copy
    local = group.redistribute(ins, [(0, 2)] * 3, [(0, 1)] * 3)
    assert all(y._base is x for x, y in zip(ins, local))


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("arch, vocab", [("gemma-2b", None),
                                         ("qwen3-14b", None),
                                         ("qwen3-14b", 515)])
def test_vocab_parallel_ce_and_embedding(arch, vocab, M):
    """The vocab-parallel lookup and cross-entropy (gemma's tied
    weights, qwen3's ``lm_head``, a vocab of 515 that no rank splits)
    against the plain functions with a mask and a padded last chunk:
    the lookup bit for bit, the loss within 1e-6 and its gradients
    within 1e-6 of their norm."""
    cfg = get_config(arch).reduced()
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    params = PT.init_lm(torch.Generator().manual_seed(1), cfg, device="cpu")
    keep = {k: params[k] for k in ("embed", "lm_head") if k in params}
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    mask = torch.from_numpy((rng.random((2, 12)) < 0.7).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(2, 12, cfg.d_model)).astype(
        np.float32))

    def plain(p, h):
        return (L.embed(p["embed"], tokens),
                PT.chunked_ce_loss(p, cfg, h, labels, mask, chunk=5))

    p = tree_map(lambda t: t.clone().requires_grad_(True), keep)
    h1 = h.clone().requires_grad_(True)
    want_emb, want = plain(p, h1)
    want_grads = torch.autograd.grad(want + want_emb.sum() * 1e-3,
                                     [h1, *leaves(p)])

    mesh = make_test_mesh(1, M, device="cpu")
    group = PL.Group(mesh.devices)
    sharded = SH.shard_params(keep, mesh)
    ranks = [tree_map(lambda x: x.local(d).detach().requires_grad_(True),
                      sharded) for d in range(M)]
    hs = [h.clone().requires_grad_(True) for _ in range(M)]
    emb = PT.embed_inputs_tp(group, ranks, cfg, [{"tokens": tokens}] * M)
    got = PT.chunked_ce_loss_tp(group, ranks, cfg, hs, [labels] * M, mask,
                                chunk=5)
    assert all(torch.equal(e, want_emb) for e in emb)
    assert abs(float(got.detach()) - float(want.detach())) <= \
        1e-6 * abs(float(want.detach()))
    grads = torch.autograd.grad(got + emb[0].sum() * 1e-3,
                                [*hs, *[t for r in ranks for t in leaves(r)]],
                                materialize_grads=True)
    # the hidden state's gradient is the sum over the ranks' copies; a
    # leaf's is its ranks' blocks (or, uncut, the sum of the copies)
    assert torch.allclose(sum(grads[:M]), want_grads[0], rtol=0,
                          atol=1e-6 * float(want_grads[0].norm()))
    n = len(leaves(keep))
    for i, (x, w) in enumerate(zip(leaves(sharded), want_grads[1:])):
        per_rank = [grads[M + r * n + i] for r in range(M)]
        if x.model_parts == 1:
            g = sum(per_rank)
        else:
            g = torch.cat(per_rank, x.model_dim)
        assert torch.allclose(g, w, rtol=0, atol=1e-6 * float(w.norm()))
    assert all(x.model_parts == (1 if vocab else M)
               for x in leaves(sharded))


def test_a_vocab_the_model_axis_does_not_divide_matches_jax():
    """Vocab 515 on a (2, 2) mesh: the rules drop ``model`` from the
    embedding and the LM head, rank 0 computes them whole, and three
    AdamW steps hold the JAX single-device step to 1e-4."""
    from test_torch_train_mesh import _rel, make_batches, torch_batch

    jcfg = dataclasses.replace(jax_config("qwen3-14b").reduced(),
                               vocab_size=515)
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(),
                              vocab_size=515)
    batches = make_batches(cfg, 3)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    jopt, opt = JO.adamw(1e-3), PO.adamw(1e-3)
    jstep = jax.jit(JS.make_train_step(
        jcfg, JaxShapeConfig("custom_train", S, B, "train", 1), jopt))
    mesh = make_test_mesh(2, 2, device="cpu")
    specs = _flat(SH.params_pspecs(params, mesh))
    assert specs["/embed/w"] == (None, "data")
    assert specs["/lm_head/w"] == ("data", None)
    params = SH.shard_params(params, mesh)
    step = PS.make_train_step(
        cfg, ShapeConfig("custom_train", S, B, "train", 1), opt, mesh=mesh)
    js, state = jopt.init(jp), opt.init(params)
    for i, batch in enumerate(batches):
        jp, js, want = jstep(jp, js, jnp.int32(i),
                             jax.tree.map(jnp.asarray, batch))
        params, state, got = step(params, state, i, torch_batch(batch))
        for k in ("loss", "grad_norm"):
            _rel(got[k], want[k])


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b", "mamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_no_rank_holds_a_whole_projection(arch, monkeypatch):
    """On a (1, 2) step, each rank's live tree holds half of every
    projection the rules cut over ``model``, and no collective moves a
    projection's weights: only activations and the small Mamba-2
    leaves (``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``)."""
    cfg = get_config(arch).reduced()
    init = PE.init_encdec if cfg.is_encoder_decoder else PT.init_lm
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = make_test_mesh(1, 2, device="cpu")
    specs = _flat(SH.params_pspecs(params, mesh))
    cut = {path for path, spec in specs.items() if "model" in spec
           and path.endswith(PROJECTIONS)}
    assert cut
    wholes = _flat(params)
    seen, moved = [], []
    loss_tp = PE.encdec_train_loss_tp if cfg.is_encoder_decoder \
        else PT.lm_train_loss_tp
    module = PE if cfg.is_encoder_decoder else PT

    def spy_loss(group, ps, *args, **kwargs):
        seen.append([_flat(p) for p in ps])
        return loss_tp(group, ps, *args, **kwargs)

    redistribute = PL.Group.redistribute

    def spy_redistribute(self, xs, *args, **kwargs):
        moved.extend(x.untyped_storage().data_ptr() for x in xs
                     if x is not None and x.numel())
        return redistribute(self, xs, *args, **kwargs)

    name = "encdec_train_loss_tp" if cfg.is_encoder_decoder \
        else "lm_train_loss_tp"
    monkeypatch.setattr(module, name, spy_loss)
    monkeypatch.setattr(PL.Group, "redistribute", spy_redistribute)
    from test_torch_train_mesh import make_batches, torch_batch

    opt = PO.adamw(1e-3)
    sharded = SH.shard_params(params, mesh)
    step = PS.make_train_step(
        cfg, ShapeConfig("custom_train", S, B, "train", 1), opt, mesh=mesh)
    step(sharded, opt.init(sharded), 0,
         torch_batch(make_batches(cfg, 1)[0]))
    assert len(seen) == 1 and len(seen[0]) == 2
    storages = set()
    for rank in seen[0]:
        for path in cut:
            whole = wholes[path]
            assert rank[path].numel() * 2 == whole.numel(), path
            storages.add(rank[path].untyped_storage().data_ptr())
    assert not storages & set(moved)
    if cfg.arch_type == "ssm":
        assert moved


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-2.7b"])
def test_remat_redoes_the_collectives(arch):
    """The tensor-parallel loss with every block recomputed in the
    backward pass gives the loss and gradients of the one without,
    bit for bit."""
    cfg = get_config(arch).reduced()
    params = PT.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = make_test_mesh(1, 2, device="cpu")
    sharded = leaves(SH.shard_params(params, mesh))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    group = PL.Group(mesh.devices)
    out = []
    torch.use_deterministic_algorithms(True)
    try:
        for remat in (True, False):
            flats = [[x.local(d).detach().requires_grad_(True)
                      for x in sharded] for d in range(2)]
            ranks = [unflatten(params, f) for f in flats]
            loss, _ = PT.lm_train_loss_tp(group, ranks, cfg, [batch] * 2,
                                          remat=remat)
            out.append((loss, torch.autograd.grad(
                loss, [t for f in flats for t in f])))
    finally:
        torch.use_deterministic_algorithms(False)
    (a, ga), (b, gb) = out
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_a_tensor_parallel_step_reaches_no_kernel(monkeypatch):
    """With ``use_pallas`` on, a (1, 2) step of gemma-2b, mamba2-2.7b
    and seamless-m4t-medium calls neither kernel wrapper: the
    recomputed blocks run as differentiated calls in the forward pass
    too, as the JAX package's training reaches no Pallas kernel."""
    from repro_torch.kernels import ops, ref
    from test_torch_train_mesh import make_batches, torch_batch

    calls = {"flash": 0, "ssd": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(ref, "flash_attention_ref",
                        spy("flash", ref.flash_attention_ref))
    monkeypatch.setattr(ref, "ssd_chunk_ref", spy("ssd", ref.ssd_chunk_ref))
    mesh = make_test_mesh(1, 2, device="cpu")
    with ops.use_pallas_scoped(True):
        for arch in ("gemma-2b", "mamba2-2.7b", "seamless-m4t-medium"):
            cfg = get_config(arch).reduced()
            init = PE.init_encdec if cfg.is_encoder_decoder else PT.init_lm
            params = SH.shard_params(init(torch.Generator().manual_seed(0),
                                          cfg, device="cpu"), mesh)
            opt = PO.adamw(1e-3)
            step = PS.make_train_step(
                cfg, ShapeConfig("custom_train", S, B, "train", 1), opt,
                mesh=mesh)
            step(params, opt.init(params), 0,
                 torch_batch(make_batches(cfg, 1)[0]))
            assert calls == {"flash": 0, "ssd": 0}, arch


def _ranks_of(tree, mesh):
    """Each device's detached, differentiable aliases of ``tree`` placed
    on ``mesh`` (what the train step hands its loss)."""
    sharded = SH.shard_params(tree, mesh)
    return [tree_map(lambda x: x.local(d).detach().requires_grad_(True),
                     sharded) for d in range(mesh.size)]


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("window", [None, 5])
def test_mla_attention_tp_matches_jax(M, window):
    """``mla_attention_tp`` at (1, M), whole heads a rank (reduced
    deepseek-v3: 4 heads), against the JAX ``mla_attention`` forward on
    the same weights and input, every rank's copy within 1e-5 of the
    largest entry; its input gradient, summed over the ranks' copies,
    is the plain ``mla_attention``'s."""
    from repro.models import mla as JMLA
    from repro_torch.models import mla as PMLA

    jcfg = jax_config("deepseek-v3-671b").reduced()
    cfg = get_config("deepseek-v3-671b").reduced()
    jp = JMLA.mla_init(jax.random.PRNGKey(1), jcfg)
    p = tree_map(lambda a: torch.from_numpy(np.array(a)),
                 jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(4).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    want, _ = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.arange(12), window=window)
    want = np.asarray(want)
    mesh = make_test_mesh(1, M, device="cpu")
    ranks = _ranks_of({"mla": p}, mesh)
    xs = [torch.from_numpy(x).requires_grad_(True) for _ in range(M)]
    outs = PMLA.mla_attention_tp(PL.Group(mesh.devices),
                                 [r["mla"] for r in ranks], xs, cfg,
                                 window=window)
    scale = np.abs(want).max()
    for o in outs:
        assert np.abs(o.detach().numpy() - want).max() <= 1e-5 * scale
    assert all(r["mla"]["wq_b"]["w"].shape[1] * M ==
               p["wq_b"]["w"].shape[1] for r in ranks)
    x1 = torch.from_numpy(x).requires_grad_(True)
    plain, _ = PMLA.mla_attention(p, x1, cfg, positions=torch.arange(12),
                                  window=window)
    w = torch.linspace(-1, 1, plain.numel()).reshape(plain.shape)
    (g_plain,) = torch.autograd.grad((plain * w).sum(), [x1])
    g = torch.autograd.grad((outs[0] * w).sum(), xs,
                            materialize_grads=True)
    assert torch.allclose(sum(g), g_plain, rtol=0,
                          atol=1e-5 * float(g_plain.abs().max()))


@pytest.mark.parametrize("M", [2, 4])
def test_mtp_loss_tp_matches_jax(M):
    """``mtp_loss_tp`` (deepseek-v3's MTP head: per-rank norm, the
    vocab-parallel embedding, ``mtp/proj`` column-parallel and gathered,
    the MLA block tensor-parallel, the vocab-parallel CE) at (1, M)
    against the JAX ``mtp_loss`` on the same weights, hidden state and
    labels: within 1e-6 relative."""
    jcfg = jax_config("deepseek-v3-671b").reduced()
    cfg = get_config("deepseek-v3-671b").reduced()
    jp = JT.init_lm(jax.random.PRNGKey(2), jcfg)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    rng = np.random.default_rng(5)
    h = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    shifted = np.roll(labels, -1, axis=1)
    want = float(JT.mtp_loss(jp, jcfg, jnp.asarray(h), jnp.asarray(labels),
                             jnp.asarray(shifted)))
    mesh = make_test_mesh(1, M, device="cpu")
    ranks = _ranks_of(params, mesh)
    lab = torch.from_numpy(labels.astype(np.int64))
    got = PT.mtp_loss_tp(PL.Group(mesh.devices), ranks, cfg,
                         [torch.from_numpy(h)] * M, [lab] * M,
                         [torch.roll(lab, -1, dims=1)] * M)
    assert abs(float(got.detach()) - want) <= 1e-6 * abs(want)
    assert ranks[0]["mtp"]["proj"]["w"].shape[1] * M == cfg.d_model


@pytest.mark.parametrize("data, model, pod", [
    (1, 2, 1), (1, 4, 1), (2, 2, 1), (4, 1, 1), (8, 1, 1), (4, 1, 2)])
def test_moe_apply_mesh_matches_jax(data, model, pod):
    """``moe_apply_mesh`` (global route, experts over data, expert ff
    over model, shared experts tensor-parallel) against the JAX
    ``moe_apply`` of the whole batch, on reduced moonshot's MoE layer
    at capacity factor 1.0 with one expert favoured, so that the
    capacity binds (and 8 x 512 tokens: per replica the route would be
    lossless from 2 replicas on): outputs within 1e-5 of the largest
    entry, the metrics within 1e-6, the dropped share exactly.  Its 4
    experts over 8 replicas: whole on each (data 8, the cut dropped),
    or over ``data`` alone, each chunk on two replicas (pod 2 x data
    4: the rule's (pod, data) degrades to ``data``)."""
    from repro.models import moe as JMOE
    from repro_torch.models import moe as PMOE

    jcfg = dataclasses.replace(
        jax_config("moonshot-v1-16b-a3b").reduced(), capacity_factor=1.0)
    cfg = dataclasses.replace(
        get_config("moonshot-v1-16b-a3b").reduced(), capacity_factor=1.0)
    jp = JMOE.moe_init(jax.random.PRNGKey(3), jcfg)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 0] += 0.05
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    p = tree_map(lambda a: torch.from_numpy(np.array(a)),
                 jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(6).normal(size=(8, 512, cfg.d_model)).astype(
        np.float32)
    want, wm = JMOE.moe_apply(jp, jnp.asarray(x), jcfg)
    want = np.asarray(want)
    assert float(wm["moe_dropped_frac"]) > 0
    mesh = make_test_mesh(data, model, pod, device="cpu")
    R = len(mesh.replicas)
    ranks = _ranks_of({"moe": p}, mesh)
    xt = torch.from_numpy(x)
    xs = [SH.batch_rows(xt, R, 1, d // model) for d in range(mesh.size)]
    outs, gm = PMOE.moe_apply_mesh([PL.Group(g) for g in mesh.replicas],
                                   [r["moe"] for r in ranks], xs, cfg)
    got = torch.cat([outs[r * model].detach() for r in range(R)])
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    for d in range(mesh.size):
        assert torch.equal(outs[d], outs[(d // model) * model])
    for k in ("moe_aux_loss", "moe_z_loss"):
        assert abs(float(gm[k].detach()) - float(wm[k])) <= \
            1e-6 * float(wm[k])
    assert float(gm["moe_dropped_frac"]) == float(wm["moe_dropped_frac"])
    expert = ranks[-1]["moe"]["experts"]["gate"]
    parts = data if cfg.num_experts % data == 0 else 1
    assert expert.shape == (cfg.num_experts // parts, cfg.d_model,
                            cfg.moe_d_ff // model)
