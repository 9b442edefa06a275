"""The port's checkpointer: the three cases of ``tests/test_checkpoint.py``
on the port, bf16 leaves bit for bit, and a checkpoint written by the
JAX package's ``Checkpointer`` read by the port."""

import jax
import numpy as np
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.checkpoint import Checkpointer, load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.tree import leaves


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"layer": [torch.arange(4.0), torch.ones((2, 3))],
                       "scale": torch.tensor(2.0),
                       "bf16": torch.randn((5, 7), generator=g).to(
                           torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": {"t": (torch.zeros(2), torch.ones(1))},
            "maybe": None}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def test_roundtrip_preserves_structure_and_values(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, tree)
    back = load_pytree(path, template=tree)
    assert isinstance(back["nested"]["t"], tuple)
    assert back["maybe"] is None
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(leaves(back), leaves(tree)):
        _same(a, b)
    # without a template: lists for tuples, the same leaves
    plain = load_pytree(path)
    assert isinstance(plain["nested"]["t"], list) and plain["maybe"] is None
    for a, b in zip(leaves(plain), leaves(tree)):
        _same(a, b)
    # plain numpy reads the bf16 leaf's bits
    with np.load(path) as z:
        bits = z["params::bf16::__bfloat16__"]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(
        bits, tree["params"]["bf16"].view(torch.int16).numpy().view(
            np.uint16))


def test_checkpointer_retention_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 5, 9):
        ck.save(step, {"w": torch.full((2,), float(step))},
                {"note": f"s{step}"})
    assert ck.steps() == [5, 9]                     # keep=2 retention
    assert ck.latest_step() == 9
    tree, step, meta = ck.restore(template={"w": torch.zeros(2)})
    assert step == 9 and meta["note"] == "s9"
    np.testing.assert_allclose(tree["w"].numpy(), 9.0)


def test_restore_specific_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(1, {"w": torch.ones(1)})
    ck.save(2, {"w": torch.ones(1) * 2})
    tree, step, meta = ck.restore(step=1)
    assert step == 1 and meta is None
    np.testing.assert_allclose(tree["w"].numpy(), 1.0)


def test_reads_a_jax_checkpoint(tmp_path):
    """A reduced gemma-2b (f32) saved by the JAX package's Checkpointer,
    read by the port's load_pytree and converted, equals the converted
    in-memory tree."""
    jcfg = jax_config("gemma-2b").reduced()
    pcfg = get_config("gemma-2b").reduced()
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    path = JaxCheckpointer(str(tmp_path)).save(3, {"params": jp})
    loaded = load_pytree(path)["params"]
    got = lm_params_from_jax(loaded, pcfg)
    want = lm_params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(leaves(got), leaves(want)):
        _same(a, b)


def test_jax_reads_an_f32_checkpoint_of_the_port(tmp_path):
    """The other direction: a reduced gemma-2b (f32) saved by the port's
    Checkpointer and read by the JAX package's load_pytree holds the
    port's leaves bit for bit (a bf16 leaf would not come back: the
    ``__bfloat16__`` tag is the port's own)."""
    from repro.checkpoint import load_pytree as jax_load_pytree
    from repro_torch.models import transformer as PT

    cfg = get_config("gemma-2b").reduced()
    params = PT.init_lm(torch.Generator().manual_seed(0), cfg,
                        device="cpu")
    path = Checkpointer(str(tmp_path)).save(3, {"params": params})
    back = jax_load_pytree(path, template={"params": params})["params"]
    got, want = jax.tree.leaves(back), leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a)
        assert a.dtype == np.float32 and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())
