"""The port's ``make_train_step`` against the JAX package's, and its
training launcher's LM mode.

On the six reduced families of ``test_torch_train_loss.py`` (B 2, S 16,
f32 JAX parameters carried across by ``convert``), one jitted JAX step
and the port's step run 3 AdamW steps on the same batches at G = 1 and
G = 2 microbatches: ``grad_norm`` must agree to 1e-4 relative at every
step, and so must the loss trajectory (the parameters themselves are
not compared: Adam's ``m / (sqrt(v) + eps)`` turns 1-ulp differences of
a near-zero gradient into a different sign).  The encoder-decoder also
stands in for the JAX package's slow
``test_encdec.py::test_train_loss_finite_and_decreases``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import steps as JS
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro_torch import optim as PO
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import encdec_params_from_jax, lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import steps as PS
from repro_torch.models import encdec as PE
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves, unflatten

B, S = 2, 16
STEPS = 3
LR = 1e-3
REL = 1e-4


def make_batches(cfg, n, seed=0):
    """``n`` numpy batches (B, S): next-token streams, plus the
    encoder-decoder's frames or the VLM's prefix embeddings."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_encoder_decoder:
            batch["src_embeds"] = rng.normal(
                size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(
                    np.float32)
        elif cfg.num_prefix_embeds:
            batch["prefix_embeds"] = rng.normal(
                size=(B, cfg.num_prefix_embeds, cfg.d_model)).astype(
                    np.float32)
        out.append(batch)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _rel(got, want, rel=REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-2.7b",
                                  "moonshot-v1-16b-a3b", "deepseek-v3-671b",
                                  "internvl2-26b", "seamless-m4t-medium"])
def test_train_step_matches_jax(arch, G):
    jcfg, pcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    init = JE.init_encdec if jcfg.is_encoder_decoder else JT.init_lm
    jp = init(jax.random.PRNGKey(0), jcfg)
    convert = encdec_params_from_jax if pcfg.is_encoder_decoder \
        else lm_params_from_jax
    pp = convert(jax.tree.map(np.asarray, jp), pcfg)
    jshape = JaxShapeConfig("custom_train", S, B, "train", G)
    pshape = ShapeConfig("custom_train", S, B, "train", G)
    assert PS.num_microbatches(pcfg, pshape) == G
    jopt, popt = JO.adamw(LR), PO.adamw(LR)
    jstep = jax.jit(JS.make_train_step(jcfg, jshape, jopt))
    pstep = PS.make_train_step(pcfg, pshape, popt)
    js, ps = jopt.init(jp), popt.init(pp)
    # with use_pallas on: the step reaches no kernel (the plain path)
    with ops.use_pallas_scoped(True):
        for step, batch in enumerate(make_batches(jcfg, STEPS)):
            jp, js, wm = jstep(jp, js, jnp.int32(step),
                               jax.tree.map(jnp.asarray, batch))
            pp, ps, gm = pstep(pp, ps, step, torch_batch(batch))
            assert set(gm) == set(wm)
            for k in ("loss", "grad_norm"):
                assert gm[k].dtype == torch.float32
                assert not gm[k].requires_grad
                _rel(gm[k], wm[k])


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-2.7b"])
def test_train_step_leaves_the_parameters_without_grad(arch):
    """A step updates the caller's tensors in place and leaves none of
    them requiring grad, so serving them afterwards builds no graph (on
    the card such a call would take the plain path, not B9/B10)."""
    cfg = get_config(arch).reduced()
    params = PT.init_lm(torch.Generator().manual_seed(0), cfg,
                        device="cpu")
    before = [p.clone() for p in leaves(params)]
    opt = PO.adamw(LR)
    step_fn = PS.make_train_step(
        cfg, ShapeConfig("custom_train", S, B, "train", 1), opt)
    batch = torch_batch(make_batches(cfg, 1)[0])
    new, _, _ = step_fn(params, opt.init(params), 0, batch)
    assert all(a is b for a, b in zip(leaves(new), leaves(params)))
    assert not any(p.requires_grad for p in leaves(params))
    assert any(not torch.equal(a, b) for a, b in zip(leaves(params),
                                                      before))
    with ops.use_pallas_scoped(True):
        logits, caches = PS.make_prefill_step(
            cfg, ShapeConfig("prefill", 32, B, "prefill"))(
                params, {"tokens": batch["tokens"]})
    assert not logits.requires_grad
    assert not any(c.requires_grad for c in leaves(caches))


def test_encdec_train_loss_finite_and_decreases():
    """The JAX package's slow encoder-decoder case on the port: a finite
    loss equal to JAX's, lower after one gradient step of 0.5; and 10
    AdamW steps on one batch lower it too."""
    arch = "seamless-m4t-medium"
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JE.init_encdec(jax.random.PRNGKey(1), jcfg)
    params = encdec_params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    batch_np = make_batches(cfg, 1, seed=1)[0]
    batch = torch_batch(batch_np)
    want, _ = JE.encdec_train_loss(jp, jcfg,
                                   jax.tree.map(jnp.asarray, batch_np),
                                   remat=False)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = PE.encdec_train_loss(params, cfg, batch, remat=False)
    assert torch.isfinite(loss)
    _rel(loss.detach(), want, 1e-5)
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    with torch.no_grad():
        stepped = [p - 0.5 * g for p, g in zip(flat, grads)]
    loss2, _ = PE.encdec_train_loss(unflatten(params, stepped), cfg, batch,
                                    remat=False)
    assert float(loss2.detach()) < float(loss.detach())

    opt = PO.adamw(1e-2, weight_decay=0.0)
    step_fn = PS.make_train_step(
        cfg, ShapeConfig("custom_train", S, B, "train", 1), opt)
    state = opt.init(params)
    losses = []
    for step in range(10):
        params, state, m = step_fn(params, state, step, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_make_optimizer_matches_jax():
    """AdamW with the JAX package's warm-up-cosine schedule, f32 moments
    below 5e10 parameters and bf16 above."""
    for arch, dtype in (("gemma-2b", torch.float32),
                        ("deepseek-v3-671b", torch.bfloat16)):
        opt = PS.make_optimizer(get_config(arch), total_steps=1000)
        state = opt.init({"w": torch.zeros(3)})
        assert state["m"]["w"].dtype == dtype
    rng = np.random.default_rng(0)
    p_np = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    g_np = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    jopt = JS.make_optimizer(jax_config("gemma-2b"), 1000)
    popt = PS.make_optimizer(get_config("gemma-2b"), 1000)
    jp, _ = jopt.update(jax.tree.map(jnp.asarray, g_np),
                        jopt.init(jax.tree.map(jnp.asarray, p_np)),
                        jax.tree.map(jnp.asarray, p_np), jnp.int32(250))
    pp = {"w": torch.from_numpy(p_np["w"].copy())}
    pp, _ = popt.update({"w": torch.from_numpy(g_np["w"])}, popt.init(pp),
                        pp, 250)
    np.testing.assert_allclose(pp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)
