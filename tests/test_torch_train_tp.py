"""LM training over a data x model mesh: ``make_train_step(..., mesh=)``
with tensor parallelism over the ``model`` ranks of each replica, on
trees placed by ``models/sharding.py::shard_params``.

A mesh here repeats the CPU, ``(cpu,) * n``, as ``(cuda:0,) * n`` does
on one card: every cut, gather and cross-rank sum runs.  The oracle is
the JAX package's single-device step (its own sharded test, whose case
the first test here takes, fails under this jax; ROADMAP §C).  Reduced
f32 configs of the six non-MoE families, global batch 8 of 16 tokens,
AdamW, at ``test_torch_train_mesh.py``'s limits: the loss and the grad
norm within 1e-4 relative at every step; every gradient leaf within
1e-4 of the global gradient norm, and a leaf copied to every rank
within 1e-4 of its own.
The JAX step at G = 1 is the reference for both G: accumulating over
microbatches changes only the order of the gradient sums, ~1e-7 of the
loss at these sizes, and one jitted reference a family keeps this file
within its time.
"""

import filecmp

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
from repro_torch import optim as PO
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves
from test_torch_train_mesh import (LR, STEPS, B, S, _jax_run,  # noqa: F401
                                   _port_params, _rel, make_batches,
                                   one_thread, torch_batch)

FAMILIES = ("gemma-2b", "qwen2-7b", "qwen3-14b", "mamba2-2.7b",
            "internvl2-26b", "seamless-m4t-medium")
MESHES = ((1, 2), (2, 2))
GRAD_REL = 1e-4


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX single-device step's runs at G = 1, by arch: (batches,
    initial numpy parameters, [metrics of each step])."""
    cache = {}

    def get(arch):
        if arch not in cache:
            batches = make_batches(jax_config(arch).reduced(), STEPS)
            cache[arch] = (batches, *_jax_run(arch, 1, batches))
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's gradient of one batch's loss, by arch: (batch, numpy
    parameters, numpy gradients)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_config(arch).reduced()
            batch = make_batches(jcfg, 1)[0]
            init = JE.init_encdec if jcfg.is_encoder_decoder else JT.init_lm
            jloss = (JE.encdec_train_loss if jcfg.is_encoder_decoder
                     else JT.lm_train_loss)
            jp = init(jax.random.PRNGKey(0), jcfg)
            _, grads = jax.jit(jax.value_and_grad(
                lambda p: jloss(p, jcfg, jax.tree.map(jnp.asarray, batch)),
                has_aux=True))(jp)
            cache[arch] = (batch, jax.tree.map(np.asarray, jp),
                           jax.tree.map(np.asarray, grads))
        return cache[arch]
    return get


def _run(cfg, params, G, batches, mesh, opt=None):
    opt = opt or PO.adamw(LR)
    if mesh is not None:
        params = SH.shard_params(params, mesh)
    step = PS.make_train_step(
        cfg, ShapeConfig("custom_train", S, B, "train", G), opt, mesh=mesh)
    state, ms = opt.init(params), []
    for i, batch in enumerate(batches):
        params, state, m = step(params, state, i, torch_batch(batch))
        ms.append(m)
    return params, state, ms


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tp_step_matches_jax_single_device(arch, G, jax_runs):
    """(1, 2) and (2, 2) against the JAX single-device step; a leaf
    copied to several devices stays bit-identical on each."""
    batches, p0, want = jax_runs(arch)
    for data, model in MESHES:
        cfg, params = _port_params(arch, p0)
        mesh = make_test_mesh(data, model, device="cpu")
        params, state, got = _run(cfg, params, G, batches, mesh)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in ("loss", "grad_norm"):
                assert not g[k].requires_grad
                _rel(g[k], w[k])
        for x in leaves((params, state)):
            for d, s in enumerate(x.shards):
                assert torch.equal(s, x.shards[x.owner(d)])
        assert any(x.model_parts == model for x in leaves(params))


def test_the_jax_sharded_tests_case():
    """``tests/test_sharding.py``'s case: reduced qwen2-7b, ShapeConfig
    ("t", 16, 8, "train", 2), the launcher's optimizer, on a (4, 2) mesh
    of eight devices, against the JAX single-device step: the loss, the
    grad norm and every parameter after the step."""
    jcfg = jax_config("qwen2-7b").reduced()
    shape = JaxShapeConfig("t", 16, 8, "train", 2)
    opt = JS.make_optimizer(jcfg, 10, state_dtype="float32")
    key = jax.random.PRNGKey(0)
    jp = JT.init_lm(key, jcfg)
    batch = {"tokens": jax.random.randint(key, (8, 16), 0, jcfg.vocab_size),
             "labels": jax.random.randint(key, (8, 16), 0, jcfg.vocab_size)}
    p0 = jax.tree.map(np.asarray, jp)
    jp, _, jm = jax.jit(JS.make_train_step(jcfg, shape, opt))(
        jp, opt.init(jp), jnp.int32(0), batch)
    cfg = get_config("qwen2-7b").reduced()
    popt = PS.make_optimizer(cfg, 10, state_dtype="float32")
    mesh = make_test_mesh(4, 2, device="cpu")
    assert len(mesh.devices) == 8
    params = SH.shard_params(lm_params_from_jax(p0, cfg), mesh)
    step = PS.make_train_step(cfg, ShapeConfig("t", 16, 8, "train", 2),
                              popt, mesh=mesh)
    params, _, m = step(params, popt.init(params), 0,
                        {k: torch.from_numpy(np.asarray(v).astype(np.int64))
                         for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        _rel(m[k], jm[k])
    want = leaves(lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    got = leaves(SH.gather_params(params, "cpu"))
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert worst < 1e-5, worst


@pytest.mark.parametrize("arch, data, model", [
    ("qwen3-14b", 1, 2), ("qwen3-14b", 2, 2), ("gemma-2b", 1, 4),
    ("mamba2-2.7b", 1, 4)])
def test_gradients_match_jax(arch, data, model, monkeypatch, jax_grads):
    """The step's gradient (gathered before the clip) against JAX's
    ``value_and_grad`` of the whole batch's loss, leaf by leaf; the
    leaves copied to every rank (norm scales, qwen3's ``q_norm`` and
    ``k_norm``, mamba's ``gated_norm``), whose gradient is the sum of
    the ranks' branches, each within 1e-4 of its own norm."""
    batch, p0, jgrads = jax_grads(arch)
    cfg, params = _port_params(arch, p0)
    _, want = _port_params(arch, jgrads)
    seen = []
    clip = PS.clip_by_global_norm

    def spy(grads, max_norm):
        # copies: the clip scales the accumulator in place
        seen.append([x.gather("cpu").clone() for x in leaves(grads)])
        return clip(grads, max_norm)

    monkeypatch.setattr(PS, "clip_by_global_norm", spy)
    mesh = make_test_mesh(data, model, device="cpu")
    placed = SH.shard_params(params, mesh)
    _run(cfg, params, 1, [batch], mesh)
    got, want = seen[0], leaves(want)
    norm = float(np.sqrt(sum(float(torch.sum(w * w)) for w in want)))
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert worst <= GRAD_REL * norm, (worst, norm)
    copied = [(g, w) for g, w, x in zip(got, want, leaves(placed))
              if x.model_parts == 1]
    names = [k for k in ("q_norm", "gated_norm") if k in str(params)]
    assert copied and (names or arch != "qwen3-14b")
    for g, w in copied:
        assert float((g - w).norm()) <= GRAD_REL * max(float(w.norm()),
                                                       1e-6)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-2.7b"])
def test_one_by_one_mesh_is_the_step_without_a_mesh(arch):
    """A (1, 1) mesh gives the step without a mesh bit for bit: every
    metric, parameter and moment."""
    torch.use_deterministic_algorithms(True)
    try:
        cfg = get_config(arch).reduced()
        batches = make_batches(cfg, 2, seed=1)

        def fresh():
            return PT.init_lm(torch.Generator().manual_seed(0), cfg,
                              device="cpu")

        p1, s1, m1 = _run(cfg, fresh(), 2, batches, None)
        p2, s2, m2 = _run(cfg, fresh(), 2, batches,
                          make_test_mesh(1, 1, device="cpu"))
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(m1, m2):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for t1, t2 in ((p1, p2), (s1, s2)):
        for x, y in zip(leaves(t1), leaves(t2)):
            assert len(y.shards) == 1 and torch.equal(x, y.shards[0])


def test_checkpoint_across_meshes(tmp_path):
    """A tree trained at (2, 2) and saved writes the file of its
    unsharded tree, byte for byte, and restores at (2, 2), (4, 1),
    (1, 1) and unsharded; a restored (4, 1) tree saves the same file."""
    cfg = get_config("qwen3-14b").reduced()
    batches = make_batches(cfg, 2, seed=2)

    def fresh():
        return PT.init_lm(torch.Generator().manual_seed(0), cfg,
                          device="cpu")

    params, state, _ = _run(cfg, fresh(), 2, batches,
                            make_test_mesh(2, 2, device="cpu"))
    tree = {"params": params, "opt_state": state}
    whole = SH.gather_params(tree, "cpu")
    save_pytree(str(tmp_path / "tp.npz"), tree)
    save_pytree(str(tmp_path / "whole.npz"), whole)
    assert filecmp.cmp(tmp_path / "tp.npz", tmp_path / "whole.npz",
                       shallow=False)
    for data, model in ((2, 2), (4, 1), (1, 1)):
        mesh = make_test_mesh(data, model, device="cpu")
        template = {"params": SH.shard_params(fresh(), mesh)}
        template["opt_state"] = PO.adamw(LR).init(template["params"])
        back = load_pytree(str(tmp_path / "tp.npz"), template)
        for got, want, tmpl in zip(leaves(back), leaves(whole),
                                   leaves(template)):
            assert got.model_parts == tmpl.model_parts
            assert (got.dim, got.parts) == (tmpl.dim, tmpl.parts)
            assert torch.equal(got.gather("cpu"), want)
        if (data, model) == (4, 1):
            save_pytree(str(tmp_path / "again.npz"), back)
            assert filecmp.cmp(tmp_path / "tp.npz", tmp_path / "again.npz",
                               shallow=False)
    plain = load_pytree(str(tmp_path / "tp.npz"))
    assert all(torch.equal(a, b) for a, b in zip(leaves(plain),
                                                 leaves(whole)))
