"""The MoE families trained over a data x model mesh:
``make_train_step(..., mesh=)`` with the global route
(``models/moe.py::moe_apply_mesh``) and expert parallelism.

A mesh here repeats the CPU, ``(cpu,) * n``, as ``(cuda:0,) * n`` does
on one card: every cut, exchange and cross-device sum runs.  The oracle
is the JAX package's single-device step, whose MoE layers route each
microbatch's tokens together.  Reduced f32 configs of the four MoE
families (deepseek-v3 with MLA and the MTP head, jamba-v0.1 with
Mamba-2, llama4-scout with k = 1 and a shared expert, moonshot) at
(2, 1), (1, 2) and (2, 2): the loss and the grad norm within 1e-4
relative at every step, ``aux`` within 1e-5, every gradient leaf within
1e-4 of the global gradient norm.  Then three batches that a per-replica
route would get wrong: 8 x 512 tokens, where the capacity binds over
the whole microbatch but not over one replica's rows (with a mask whose
CE token counts differ by replica, for the MTP head's row weighting), and
16 384 tokens over (4, 1), where a dispatch chunk spans two replicas.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import steps as JS
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch import optim as PO
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe as PMOE
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves
from test_torch_train_mesh import (LR, STEPS, _port_params,  # noqa: F401
                                   _rel, make_batches, one_thread,
                                   torch_batch)

FAMILIES = ("deepseek-v3-671b", "jamba-v0.1-52b", "llama4-scout-17b-a16e",
            "moonshot-v1-16b-a3b")
MESHES = ((2, 1), (1, 2), (2, 2))
AUX_REL = 1e-5
GRAD_REL = 1e-4
B1 = 0.9          # the AdamW first-moment decay of ``JO.adamw``


def _batches(cfg, n, B, S, seed=0, mask=False):
    """``n`` numpy batches of B x S tokens; ``mask``: a 0/1 mask that
    leaves the first rows almost empty and the last ones full."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if mask:
            keep = np.linspace(0.1, 1.0, B)[:, None]
            batch["mask"] = (rng.random((B, S)) < keep).astype(np.float32)
        out.append(batch)
    return out


def _jax_steps(jcfg, batches):
    """The JAX package's jitted single-device step (G = 1) over
    ``batches``: (initial numpy parameters, [metrics of each step], the
    first batch's gradient).  The gradient comes out of the first
    step's AdamW moment, ``m = (1 - b1) · clip(g)``, the clip's scale
    ``min(1, 1 / grad_norm)``."""
    B, S = batches[0]["tokens"].shape
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    p0 = jax.tree.map(np.asarray, jp)
    opt = JO.adamw(LR, b1=B1)
    step = jax.jit(JS.make_train_step(
        jcfg, JaxShapeConfig("custom_train", S, B, "train", 1), opt))
    js, ms, grads = opt.init(jp), [], None
    for i, batch in enumerate(batches):
        jp, js, m = step(jp, js, jnp.int32(i),
                         jax.tree.map(jnp.asarray, batch))
        ms.append({k: float(v) for k, v in m.items()})
        if grads is None:
            scale = min(1.0, 1.0 / ms[0]["grad_norm"])
            grads = jax.tree.map(
                lambda t: np.asarray(t, np.float64) / (1 - B1) / scale,
                js["m"])
    return p0, ms, grads


def _port_steps(cfg, params, batches, mesh, G=1):
    """The port's step on ``mesh`` over ``batches``: (params, [metrics])."""
    B, S = batches[0]["tokens"].shape
    opt = PO.adamw(LR)
    params = SH.shard_params(params, mesh)
    step = PS.make_train_step(
        cfg, ShapeConfig("custom_train", S, B, "train", G), opt, mesh=mesh)
    state, ms = opt.init(params), []
    for i, batch in enumerate(batches):
        params, state, m = step(params, state, i, torch_batch(batch))
        ms.append(m)
    return params, ms


def _check(got, want):
    """Every metric at every step: ``aux`` within AUX_REL, the others
    within 1e-4 relative."""
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert not g[k].requires_grad
            _rel(g[k], w[k], AUX_REL if k == "aux" else 1e-4)


def _spy_mesh_metrics(monkeypatch):
    """The metrics of every ``moe_apply_mesh`` call, as floats."""
    seen = []
    apply = PMOE.moe_apply_mesh

    def spy(*args, **kwargs):
        out, metrics = apply(*args, **kwargs)
        seen.append({k: float(v.detach()) for k, v in metrics.items()})
        return out, metrics

    monkeypatch.setattr(PMOE, "moe_apply_mesh", spy)
    return seen


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX single-device step's runs at G = 1, by arch: (batches,
    initial numpy parameters, [metrics], the first batch's gradient)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_config(arch).reduced()
            batches = make_batches(jcfg, STEPS)
            cache[arch] = (batches, *_jax_steps(jcfg, batches))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", FAMILIES)
def test_moe_mesh_step_matches_jax_single_device(arch, jax_runs):
    """(2, 1), (1, 2) and (2, 2) against the JAX single-device step; a
    chunk held by several devices stays identical to its owner's, and
    no expert leaf is held whole where the data axis cuts it."""
    batches, p0, want, _ = jax_runs(arch)
    for data, model in MESHES:
        cfg, params = _port_params(arch, p0)
        mesh = make_test_mesh(data, model, device="cpu")
        params, got = _port_steps(cfg, params, batches, mesh)
        _check(got, want)
        for x in leaves(params):
            for d, s in enumerate(x.shards):
                assert torch.equal(s, x.shards[x.owner(d)])
        experts = [x for x in leaves(params) if x.expert]
        assert experts and all(
            x.parts == data and x.shards[0].shape[0] * data == x.shape[0]
            for x in experts)


@pytest.mark.parametrize("arch, data, model", [
    ("deepseek-v3-671b", 2, 2), ("jamba-v0.1-52b", 2, 1),
    ("llama4-scout-17b-a16e", 1, 2), ("moonshot-v1-16b-a3b", 2, 2)])
def test_gradients_match_jax_and_experts_stay_with_their_owners(
        arch, data, model, monkeypatch, jax_runs):
    """The step's gradient (before the clip) against the JAX step's
    gradient of the whole batch's loss, leaf by leaf, within 1e-4 of
    the global norm.  Device d computes with its own shard of each
    expert leaf (the loss's alias shares its storage: no gather over
    data), and that leaf's gradient is its own accumulator shard."""
    batches, p0, _, jgrads = jax_runs(arch)
    batch = batches[0]
    cfg, params = _port_params(arch, p0)
    _, want = _port_params(arch, jax.tree.map(
        lambda t: t.astype(np.float32), jgrads))
    mesh = make_test_mesh(data, model, device="cpu")
    placed = SH.shard_params(params, mesh)
    seen, lives = [], []
    clip, loss_mesh = PS.clip_by_global_norm, PT.lm_train_loss_mesh

    def spy_clip(grads, max_norm):
        seen.append(leaves(grads))
        seen.append([x.gather("cpu").clone() for x in leaves(grads)])
        return clip(grads, max_norm)

    def spy_loss(groups, ps, *args, **kwargs):
        lives.append([leaves(p) for p in ps])
        return loss_mesh(groups, ps, *args, **kwargs)

    monkeypatch.setattr(PS, "clip_by_global_norm", spy_clip)
    monkeypatch.setattr(PT, "lm_train_loss_mesh", spy_loss)
    opt = PO.adamw(LR)
    step = PS.make_train_step(
        cfg, ShapeConfig("custom_train", batch["tokens"].shape[1],
                         batch["tokens"].shape[0], "train", 1), opt,
        mesh=mesh)
    step(placed, opt.init(placed), 0, torch_batch(batch))
    grads, got = seen
    want = leaves(want)
    norm = float(np.sqrt(sum(float(torch.sum(w * w)) for w in want)))
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert worst <= GRAD_REL * norm, (worst, norm)
    experts = [i for i, x in enumerate(leaves(placed)) if x.expert]
    assert len(experts) == 3 * sum(f == "moe" for _, f in
                                   PT.layer_types(cfg))
    for i in experts:
        x, g = leaves(placed)[i], grads[i]
        assert g.expert and (g.dim, g.parts) == (x.dim, x.parts)
        for d in range(mesh.size):
            alias = lives[0][d][i]
            assert alias.shape == x.shards[d].shape
            assert alias.untyped_storage().data_ptr() == \
                x.shards[d].untyped_storage().data_ptr()
            assert g.shards[d].shape == x.shards[d].shape
        assert x.parts == data and x.model_parts == model


def test_capacity_binds_over_the_microbatch_not_the_replica(monkeypatch):
    """deepseek-v3 (k = 2) at (2, 1) on 8 x 512 tokens with a mask: the
    microbatch's 8192 expanded rows make the capacity bind, C = 2560,
    and the JAX reference's first MoE layer drops rows; one replica's
    4096 rows alone would be lossless.  The mesh route drops the JAX
    rows: its dropped share equals the JAX layer's, and the loss, ``ce``,
    ``mtp`` (weighted by rows: its cross-entropy takes no mask, while
    the CE token counts differ by replica), ``aux`` and the grad norm
    match the JAX step."""
    arch, (data, model) = "deepseek-v3-671b", (2, 1)
    jcfg = jax_config(arch).reduced()
    batches = _batches(jcfg, 2, 8, 512, seed=5, mask=True)
    p0, want, _ = _jax_steps(jcfg, batches)
    cfg, params = _port_params(arch, p0)
    T, k = 8 * 512, cfg.experts_per_token
    assert PMOE._capacity(T // data, cfg) == T // data * k
    assert PMOE._capacity(T, cfg) == 2560

    # the JAX layer's drops on the first MoE layer's input
    layer = next(i for i, (_, f) in enumerate(PT.layer_types(cfg))
                 if f == "moe")
    captured = []
    apply = PMOE.moe_apply

    def spy(p, x, c):
        captured.append(x.detach().clone())
        return apply(p, x, c)

    monkeypatch.setattr(PMOE, "moe_apply", spy)
    with torch.no_grad():
        PT.lm_train_loss(params, cfg, torch_batch(batches[0]), remat=False)
    monkeypatch.setattr(PMOE, "moe_apply", apply)
    jmoe = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        params["layers"][layer]["moe"])
    _, jm = JMOE.moe_apply(jmoe, jnp.asarray(captured[0].numpy()), jcfg)
    dropped = float(jm["moe_dropped_frac"])
    assert dropped > 0

    seen = _spy_mesh_metrics(monkeypatch)
    mesh = make_test_mesh(data, model, device="cpu")
    _, got = _port_steps(cfg, params, batches, mesh)
    _check(got, want)
    assert abs(seen[0]["moe_dropped_frac"] - dropped) <= 1e-6
    masks = [SH.batch_rows(torch.from_numpy(batches[0]["mask"]), data, 1, r)
             .sum() for r in range(data)]
    assert abs(float(masks[0]) - float(masks[1])) > 0.2 * float(sum(masks))


def test_a_dispatch_chunk_spans_two_replicas(monkeypatch):
    """16 384 tokens over (4, 1): the route splits them into two
    dispatch chunks of 8192 tokens, each the rows of two replicas with a
    capacity of its own, as the JAX package's chunked dispatch does; the
    step matches the JAX step, ``aux`` (the chunks' mean) included.  A
    small config of the moonshot family keeps the JAX step quick."""
    small = dict(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                 d_ff=64, moe_d_ff=32, vocab_size=64)
    jcfg = dataclasses.replace(
        jax_config("moonshot-v1-16b-a3b").reduced(), **small)
    cfg = dataclasses.replace(
        get_config("moonshot-v1-16b-a3b").reduced(), **small)
    B, S, R = 64, 256, 4
    assert PMOE._chunks([B * S // R] * R) == [
        [(0, 0, 4096), (1, 0, 4096)], [(2, 0, 4096), (3, 0, 4096)]]
    batches = _batches(jcfg, 2, B, S, seed=7)
    p0, want, _ = _jax_steps(jcfg, batches)
    params = lm_params_from_jax(p0, cfg)
    seen = _spy_mesh_metrics(monkeypatch)
    _, got = _port_steps(cfg, params, batches,
                         make_test_mesh(R, 1, device="cpu"))
    _check(got, want)
    assert len(seen) == 2 * len(batches)


def test_chunks_split_a_replica_where_the_chunk_ends():
    """A replica whose rows straddle a chunk boundary gives a segment to
    each chunk; a microbatch the chunk does not divide is one chunk."""
    assert PMOE._chunks([6144] * 4) == [
        [(0, 0, 6144), (1, 0, 2048)], [(1, 2048, 6144), (2, 0, 4096)],
        [(2, 4096, 6144), (3, 0, 6144)]]
    assert PMOE._chunks([5000] * 2) == [[(0, 0, 5000), (1, 0, 5000)]]
    assert PMOE._chunks([8192]) == [[(0, 0, 8192)]]
