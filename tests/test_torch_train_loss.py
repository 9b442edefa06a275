"""The port's training losses and their gradients against the JAX
package's, on six reduced families: gemma-2b (dense, GeGLU, tied),
mamba2-2.7b (SSM), moonshot-v1-16b-a3b (MoE: the aux loss),
deepseek-v3-671b (MLA and the MTP loss), internvl2-26b (prefix
embeddings) and seamless-m4t-medium (the encoder-decoder).

The JAX f32 parameters are carried across by ``repro_torch.convert``;
the batch (B 2, S 16) comes from numpy.  The loss and its metrics must
agree to 1e-5 relative, every gradient leaf to 1e-4 of the global
gradient norm (the JAX gradient tree goes through the same ``convert``
function as the parameters).  The loss's attention and SSD take the
plain path even with ``use_pallas`` on: no kernel has a backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import steps as JS
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.convert import encdec_params_from_jax, lm_params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as PS
from repro_torch.models import encdec as PE
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves

ARCHS = ("gemma-2b", "mamba2-2.7b", "moonshot-v1-16b-a3b",
         "deepseek-v3-671b", "internvl2-26b", "seamless-m4t-medium")
B, S = 2, 16
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def make_batch(cfg, seed=0):
    """numpy batch: tokens/labels (B, S) int32 (a next-token stream), plus
    the encoder-decoder's frames or the VLM's prefix embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    elif cfg.num_prefix_embeds:
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def convert(arch, tree_np):
    cfg = get_config(arch).reduced()
    fn = encdec_params_from_jax if cfg.is_encoder_decoder \
        else lm_params_from_jax
    return fn(tree_np, cfg)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    jcfg, pcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    init = JE.init_encdec if jcfg.is_encoder_decoder else JT.init_lm
    jp = init(jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, pcfg, jp


def _losses(jcfg, pcfg):
    if jcfg.is_encoder_decoder:
        return JE.encdec_train_loss, PE.encdec_train_loss
    return JT.lm_train_loss, PT.lm_train_loss


def _rel(got, want, rel):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


def _port_grads(ploss, pp, pcfg, batch, remat=True):
    flat = leaves(pp)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = ploss(pp, pcfg, torch_batch(batch), remat=remat)
    return loss, metrics, torch.autograd.grad(loss, flat,
                                              materialize_grads=True)


def test_loss_and_grads_match_jax(family):
    arch, jcfg, pcfg, jp = family
    jloss, ploss = _losses(jcfg, pcfg)
    batch = make_batch(jcfg)
    (want, wm), jgrads = jax.value_and_grad(
        lambda p: jloss(p, jcfg, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jp)
    pp = convert(arch, jax.tree.map(np.asarray, jp))
    got, gm, grads = _port_grads(ploss, pp, pcfg, batch)
    assert set(gm) == set(wm)
    if arch == "deepseek-v3-671b":
        assert "mtp" in gm and float(gm["mtp"].detach()) > 0
    if arch == "moonshot-v1-16b-a3b":
        assert float(gm["aux"].detach()) > 0
    for k in wm:
        _rel(gm[k].detach(), wm[k], LOSS_REL)
    want_grads = leaves(convert(arch, jax.tree.map(np.asarray, jgrads)))
    assert len(want_grads) == len(grads)
    norm = float(np.sqrt(sum(np.sum(np.square(g.numpy()))
                             for g in want_grads)))
    worst = max(float((g - w).abs().max()) for g, w in zip(grads, want_grads))
    assert worst <= GRAD_REL * norm, (worst, norm)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "seamless-m4t-medium"])
def test_remat_changes_nothing(arch):
    """Recomputing each block's activations in the backward pass gives
    the loss and the gradients of the plain backward."""
    cfg = get_config(arch).reduced()
    init = PE.init_encdec if cfg.is_encoder_decoder else PT.init_lm
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ploss = PE.encdec_train_loss if cfg.is_encoder_decoder \
        else PT.lm_train_loss
    batch = make_batch(cfg)
    a, _, ga = _port_grads(ploss, params, cfg, batch, remat=True)
    b, _, gb = _port_grads(ploss, params, cfg, batch, remat=False)
    assert torch.equal(a, b)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-7)


def test_mtp_loss_matches_jax():
    """``mtp_loss`` alone, on a hidden state and labels from numpy, with
    the reference's rolled targets (the last position wraps round)."""
    arch = "deepseek-v3-671b"
    jcfg, pcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    pp = convert(arch, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    h = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    shifted = np.roll(labels, -1, axis=1)
    want = JT.mtp_loss(jp, jcfg, jnp.asarray(h), jnp.asarray(labels),
                       jnp.asarray(shifted))
    got = PT.mtp_loss(pp, pcfg, torch.from_numpy(h),
                      torch.from_numpy(labels.astype(np.int64)),
                      torch.from_numpy(shifted.astype(np.int64)))
    _rel(got, want, LOSS_REL)
    # no MTP head: zero, as in the JAX package
    no_mtp = {k: v for k, v in pp.items() if k != "mtp"}
    assert float(PT.mtp_loss(no_mtp, pcfg, torch.from_numpy(h),
                             torch.from_numpy(labels), None)) == 0.0


@pytest.mark.parametrize("S_,chunk,masked", [(16, 512, False),
                                             (13, 4, True), (16, 8, True)])
def test_chunked_ce_loss_matches_jax(S_, chunk, masked):
    """Chunks that do and do not divide S, with and without a mask."""
    arch = "gemma-2b"
    jcfg, pcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_lm(jax.random.PRNGKey(3), jcfg)
    pp = convert(arch, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(4)
    h = rng.normal(size=(B, S_, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S_)).astype(np.int32)
    mask = (rng.random((B, S_)) < 0.7).astype(np.float32) if masked \
        else None
    want = JT.chunked_ce_loss(jp, jcfg, jnp.asarray(h), jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask),
                              chunk=chunk)
    got = PT.chunked_ce_loss(pp, pcfg, torch.from_numpy(h),
                             torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask),
                             chunk=chunk)
    _rel(got, want, LOSS_REL)


def test_train_loss_reaches_no_kernel(monkeypatch):
    """With ``use_pallas`` on, a differentiated loss calls neither kernel
    wrapper; a serving prefill under no_grad does (B9 and B10)."""
    calls = {"flash": 0, "ssd": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(ref, "flash_attention_ref",
                        spy("flash", ref.flash_attention_ref))
    monkeypatch.setattr(ref, "ssd_chunk_ref", spy("ssd", ref.ssd_chunk_ref))
    gen = torch.Generator().manual_seed(0)
    with ops.use_pallas_scoped(True):
        for arch in ("gemma-2b", "mamba2-2.7b", "deepseek-v3-671b"):
            cfg = get_config(arch).reduced()
            params = PT.init_lm(gen, cfg, device="cpu")
            batch = torch_batch(make_batch(cfg))
            for p in leaves(params):
                p.requires_grad_(True)
            loss, _ = PT.lm_train_loss(params, cfg, batch)
            torch.autograd.grad(loss, leaves(params))
            assert calls == {"flash": 0, "ssd": 0}, arch
            with torch.no_grad():
                caches = PT.init_lm_cache(cfg, B, S, device="cpu")
                PT.lm_prefill(params, cfg, {"tokens": batch["tokens"]},
                              caches)
            assert calls["flash" if arch != "mamba2-2.7b" else "ssd"] > 0
            calls.update(flash=0, ssd=0)


def test_lm_hidden_returns_the_moe_metrics():
    """``lm_hidden``'s third value lists each MoE layer's metrics, and
    ``moe_aux_loss`` weighs them into the JAX package's aux scalar."""
    arch = "moonshot-v1-16b-a3b"
    jcfg, pcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_lm(jax.random.PRNGKey(5), jcfg)
    pp = convert(arch, jax.tree.map(np.asarray, jp))
    toks = make_batch(jcfg)["tokens"]
    jh = JT.embed_inputs(jp, jcfg, jnp.asarray(toks))
    _, _, want = JT.lm_hidden(jp, jcfg, jh, positions=jnp.arange(S))
    ph = PT.embed_inputs(pp, pcfg, torch.from_numpy(toks))
    _, caches, aux = PT.lm_hidden(pp, pcfg, ph,
                                  positions=torch.arange(S))
    assert caches is None
    n_moe = sum(pcfg.is_moe_layer(i) for i in range(pcfg.num_layers))
    assert len(aux) == n_moe > 0
    assert {"moe_aux_loss", "moe_z_loss"} <= set(aux[0])
    _rel(PT.moe_aux_loss(pcfg, aux), want, LOSS_REL)
    dense = get_config("gemma-2b").reduced()
    assert float(PT.moe_aux_loss(dense, [])) == 0.0


@pytest.mark.parametrize("arch", sorted({a for a, _ in JS._MICROBATCHES}))
def test_num_microbatches_matches_jax(arch):
    assert PS._MICROBATCHES == JS._MICROBATCHES
    jcfg, pcfg = jax_config(arch), get_config(arch)
    shapes = [(SHAPES[n], JAX_SHAPES[n]) for n in SHAPES]
    shapes += [(ShapeConfig("custom_train", 16, b, "train", g),
                JaxShapeConfig("custom_train", 16, b, "train", g))
               for b, g in ((8, 2), (6, 4), (2, 1), (1, 3))]
    for ps, js in shapes:
        for dp in (1, 2, 16, 32):
            if ps.global_batch % dp:
                continue           # the reference's loop never ends there
            got = PS.num_microbatches(pcfg, ps, dp)
            assert got == JS.num_microbatches(jcfg, js, dp)
            if ps.kind == "train":
                assert ps.global_batch % (got * dp) == 0
