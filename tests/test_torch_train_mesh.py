"""Data-parallel LM training over a mesh of devices:
``make_train_step(..., mesh=)`` on trees placed by
``models/sharding.py::shard_params``.

A mesh here repeats the CPU, ``(cpu,) * D``, as ``(cuda:0,) * D`` does on
one card: every cut, gather, reduce-scatter and cross-device sum runs.
The oracle is the JAX package's single-device step (its own sharded
step's contract is to equal it).  Reduced f32 configs, global batch 8 of
16 tokens, 3 AdamW steps at G = 1 and 2: the loss and the grad norm
within 1e-4 relative at every step, as in ``test_torch_train_step.py``.
"""

import filecmp

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
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import encdec_params_from_jax, lm_params_from_jax
from repro_torch.data import TokenDataConfig, make_batch_iterator
from repro_torch.data import synthetic_token_batches
from repro_torch.launch import steps as PS
from repro_torch.launch import train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import encdec as PE
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves

B, S = 8, 16
STEPS = 3
LR = 1e-3
REL = 1e-4


def make_batches(cfg, n, seed=0, mask=False):
    """``n`` numpy batches (B, S), with the encoder-decoder's frames or
    the VLM's prefix embeddings; ``mask``: a 0/1 mask that leaves rows
    0-1 almost empty and rows 6-7 full, so the devices' token counts
    differ."""
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
        if mask:
            keep = np.linspace(0.1, 1.0, B)[:, None]
            batch["mask"] = (rng.random((B, S)) < keep).astype(np.float32)
        out.append(batch)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: its tensors are tiny, and
    pytest-xdist's workers, each with a thread a core, would otherwise
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    """Deterministic kernels (the CPU's embedding backward accumulates
    in thread order otherwise): two runs of one step are then bit for
    bit equal."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _rel(got, want, rel=REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


def _jax_run(arch, G, batches):
    """The JAX package's jitted single-device step over ``batches``:
    (initial numpy parameters, [metrics of each step])."""
    jcfg = jax_config(arch).reduced()
    init = JE.init_encdec if jcfg.is_encoder_decoder else JT.init_lm
    jp = init(jax.random.PRNGKey(0), jcfg)
    p0 = jax.tree.map(np.asarray, jp)
    opt = JO.adamw(LR)
    step = jax.jit(JS.make_train_step(
        jcfg, JaxShapeConfig("custom_train", S, B, "train", G), opt))
    js, ms = opt.init(jp), []
    for i, batch in enumerate(batches):
        jp, js, m = step(jp, js, jnp.int32(i),
                         jax.tree.map(jnp.asarray, batch))
        ms.append({k: float(v) for k, v in m.items()})
    return p0, ms


def _port_params(arch, p0):
    cfg = get_config(arch).reduced()
    convert = encdec_params_from_jax if cfg.is_encoder_decoder \
        else lm_params_from_jax
    return cfg, convert(p0, cfg)


def _port_run(cfg, params, G, batches, mesh=None):
    """The port's step over ``batches`` (on ``mesh``, placed by
    ``shard_params``): (params, opt_state, [metrics])."""
    opt = PO.adamw(LR)
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
@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-2.7b", "internvl2-26b",
                                  "seamless-m4t-medium"])
def test_mesh_step_matches_jax_single_device(arch, G):
    """D = 2 and 4 against the JAX single-device step; every replicated
    leaf (and moment) stays bit-identical across its D copies."""
    batches = make_batches(jax_config(arch).reduced(), STEPS)
    p0, want = _jax_run(arch, G, batches)
    for D in (2, 4):
        cfg, params = _port_params(arch, p0)
        mesh = make_test_mesh(D, 1, device="cpu")
        assert PS.num_microbatches(cfg, ShapeConfig(
            "custom_train", S, B, "train", G), D) == G
        params, state, got = _port_run(cfg, params, G, batches, mesh)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in ("loss", "grad_norm"):
                assert g[k].dtype == torch.float32
                assert not g[k].requires_grad
                _rel(g[k], w[k])
        replicated = [x for tree in (params, state["m"], state["v"])
                      for x in leaves(tree) if x.parts < D]
        assert replicated
        for x in replicated:
            for d, s in enumerate(x.shards):
                assert torch.equal(s, x.shards[d % x.parts])
        sharded = [x for x in leaves(params) if x.parts == D]
        assert sharded and all(x.shards[0].shape != x.shape
                               for x in sharded)


@pytest.mark.parametrize("arch", ["gemma-2b", "seamless-m4t-medium"])
@pytest.mark.parametrize("G", [1, 2])
def test_one_device_mesh_is_the_single_device_step(arch, G, deterministic):
    """A one-device mesh gives ``make_train_step``'s step bit for bit:
    every metric, every parameter and every moment."""
    cfg = get_config(arch).reduced()
    batches = make_batches(cfg, STEPS, seed=1)
    init = PE.init_encdec if cfg.is_encoder_decoder else PT.init_lm

    def fresh():
        return init(torch.Generator().manual_seed(0), cfg, device="cpu")

    p1, s1, m1 = _port_run(cfg, fresh(), G, batches)
    p2, s2, m2 = _port_run(cfg, fresh(), G, batches,
                           make_test_mesh(1, 1, device="cpu"))
    for a, b in zip(m1, m2):
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    for t1, t2 in ((p1, p2), (s1, s2)):
        for x, y in zip(leaves(t1), leaves(t2)):
            assert len(y.shards) == 1 and torch.equal(x, y.shards[0])


@pytest.mark.parametrize("D", [2, 4])
def test_a_masked_batch_gives_the_global_token_mean(D):
    """With a mask whose token counts differ by device, the loss and the
    gradients are the global batch's token mean (JAX's single-device
    step), not the mean of the devices' means."""
    arch = "gemma-2b"
    batches = make_batches(jax_config(arch).reduced(), STEPS, mask=True)
    p0, want = _jax_run(arch, 1, batches)
    cfg, params = _port_params(arch, p0)
    _, _, got = _port_run(cfg, params, 1, batches,
                          make_test_mesh(D, 1, device="cpu"))
    for g, w in zip(got, want):
        _rel(g["loss"], w["loss"])
        _rel(g["grad_norm"], w["grad_norm"])
    # the mean of the devices' own token means is another number: a 1/D
    # weighting would miss the limit by far
    cfg, params = _port_params(arch, p0)
    tb = torch_batch(batches[0])
    means = [float(PT.lm_train_loss(params, cfg, {
        k: SH.batch_rows(v, D, 1, d) for k, v in tb.items()})[0])
        for d in range(D)]
    assert abs(np.mean(means) - want[0]["loss"]) > 10 * REL * want[0]["loss"]


def test_sharded_checkpoint_is_the_unsharded_file(tmp_path, deterministic):
    """A tree saved sharded over 4 devices writes the file its gathered
    tree writes, byte for byte; a one-device mesh's run writes the file
    of the run without a mesh; the file restores at D = 1, 2 and 4 and
    unsharded."""
    arch = "gemma-2b"
    cfg = get_config(arch).reduced()
    batches = make_batches(cfg, 2, seed=2)

    def fresh():
        return PT.init_lm(torch.Generator().manual_seed(0), cfg,
                          device="cpu")

    p4, s4, _ = _port_run(cfg, fresh(), 2, batches,
                          make_test_mesh(4, 1, device="cpu"))
    save_pytree(str(tmp_path / "d4.npz"), {"params": p4, "opt_state": s4})
    save_pytree(str(tmp_path / "d4_gathered.npz"),
                {"params": SH.gather_params(p4, "cpu"),
                 "opt_state": SH.gather_params(s4, "cpu")})
    assert filecmp.cmp(tmp_path / "d4.npz", tmp_path / "d4_gathered.npz",
                       shallow=False)
    p0, s0, _ = _port_run(cfg, fresh(), 2, batches)
    p1, s1, _ = _port_run(cfg, fresh(), 2, batches,
                          make_test_mesh(1, 1, device="cpu"))
    save_pytree(str(tmp_path / "plain.npz"), {"params": p0, "opt_state": s0})
    save_pytree(str(tmp_path / "d1.npz"), {"params": p1, "opt_state": s1})
    assert filecmp.cmp(tmp_path / "plain.npz", tmp_path / "d1.npz",
                       shallow=False)
    whole = {"params": SH.gather_params(p4, "cpu"),
             "opt_state": SH.gather_params(s4, "cpu")}
    for D in (1, 2, 4):
        mesh = make_test_mesh(D, 1, device="cpu")
        template = {"params": SH.shard_params(fresh(), mesh)}
        template["opt_state"] = PO.adamw(LR).init(template["params"])
        tree = load_pytree(str(tmp_path / "d4.npz"), template)
        for got, want, tmpl in zip(leaves(tree), leaves(whole),
                                   leaves(template)):
            assert isinstance(got, SH.Sharded)
            assert (got.dim, got.parts) == (tmpl.dim, tmpl.parts)
            assert torch.equal(got.gather("cpu"), want)
    plain = load_pytree(str(tmp_path / "d4.npz"))
    assert all(torch.equal(a, b) for a, b in zip(leaves(plain),
                                                 leaves(whole)))


def test_moe_over_devices_and_a_model_axis_raise():
    """An MoE family no longer raises over data or model devices: its
    step builds and runs one step at (2, 1) and (1, 2) (global route,
    finite metrics, the same loss as one device); one device trains as
    without a mesh; a batch that does not split over the replicas
    raises."""
    shape = ShapeConfig("custom_train", S, B, "train", 1)
    moe = get_config("moonshot-v1-16b-a3b").reduced()
    batch = torch_batch(make_batches(moe, 1)[0])

    def fresh():
        return PT.init_lm(torch.Generator().manual_seed(0), moe,
                          device="cpu")

    _, _, (want,) = _port_run(moe, fresh(), 1, [make_batches(moe, 1)[0]])
    for mesh in (make_test_mesh(2, 1, device="cpu"),
                 make_test_mesh(1, 2, device="cpu")):
        opt = PO.adamw(LR)
        params = SH.shard_params(fresh(), mesh)
        step = PS.make_train_step(moe, shape, opt, mesh=mesh)
        _, _, m = step(params, opt.init(params), 0, batch)
        assert set(m) == set(want)
        assert all(torch.isfinite(v) for v in m.values())
        _rel(m["loss"], want["loss"])
    # one device: the MoE family trains as without a mesh
    PS.make_train_step(moe, shape, PO.adamw(LR),
                       mesh=make_test_mesh(1, 1, device="cpu"))
    with pytest.raises(ValueError, match="does not split"):
        PS.make_train_step(get_config("gemma-2b").reduced(),
                           ShapeConfig("custom_train", S, 6, "train", 1),
                           PO.adamw(LR),
                           mesh=make_test_mesh(4, 1, device="cpu"))


def test_batch_iterator_yields_row_shards():
    """With a mesh the pipeline yields, for each batch, one dict per
    device holding that device's rows of the single-device batch."""
    cfg = TokenDataConfig(97, S, B, seed=3)
    mesh = make_test_mesh(2, 1, device="cpu")
    want = list(synthetic_token_batches(cfg, 2))
    got = list(make_batch_iterator(cfg, num_batches=2, mesh=mesh,
                                   microbatches=2))
    assert len(got) == 2
    for shards, batch in zip(got, want):
        assert len(shards) == 2
        for d, shard in enumerate(shards):
            for k, v in batch.items():
                assert shard[k].dtype == torch.int64
                assert shard[k].tolist() == SH.batch_rows(v, 2, 2,
                                                          d).tolist()
    with pytest.raises(ValueError, match="not both"):
        next(iter(make_batch_iterator(cfg, device="cpu", mesh=mesh)))


def test_lm_cli_trains_on_a_one_cpu_mesh(capsys):
    train.main(["--arch", "seamless-m4t-medium", "--reduced", "--device",
                "cpu", "--steps", "2", "--global-batch", "4", "--seq-len",
                "16", "--log-every", "1", "--microbatches", "2"])
    out = capsys.readouterr().out
    assert "devices=1 device=cpu" in out
    assert [line.split()[:2] for line in out.splitlines()
            if line.startswith("step ")] == [["step", "0"], ["step", "1"]]
    assert "final loss" in out
