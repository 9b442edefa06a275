"""The dry run's training row, arch by arch: every arch's reduced config
at ``train_4k``'s sequence (4096 tokens) on a fake (2, 2) mesh, its
layers, blocked attention and SSD scan replaying their op-by-op counts
(``roofline/counting.py::counted_call``), finishes with the argument
bytes the JAX package's own specs give on ``AbstractMesh``.
"""

import dataclasses
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import steps as JS
from repro.models import sharding as JSH
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as PS

# train_4k's sequence; two rows split over two replicas, one a microbatch
TRAIN_SEQ, TRAIN_ROWS = 4096, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module (its tensors are fake; under
    pytest-xdist a thread a core per worker oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jax_train_argument_bytes(arch, shape, sizes) -> int:
    """One device's bytes of the JAX package's training arguments (its
    params, AdamW state and batch, ``jax.eval_shape``'d) cut by its own
    specs on an abstract mesh."""
    cfg = jax_config(arch).reduced()
    jshape = JaxShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                            shape.kind)
    amesh = AbstractMesh(sizes, ("data", "model"))

    def cut(tree, specs):
        xs = jax.tree.leaves(tree)
        ss = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
            s, (PartitionSpec, NamedSharding)))
        assert len(xs) == len(ss)
        total = 0
        for x, s in zip(xs, ss):
            sh = s if isinstance(s, NamedSharding) else NamedSharding(amesh,
                                                                      s)
            total += math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
        return total

    params = JS.params_specs(cfg)
    state = jax.eval_shape(JS.make_optimizer(cfg).init, params)
    return (cut(params, JSH.params_pspecs(params, amesh))
            + cut(state, JSH.params_pspecs(state, amesh))
            + cut(JS.batch_specs(cfg, jshape),
                  JS.batch_shardings(cfg, jshape, amesh)))


def _reduced(arch):
    """The reduced config, its SSD chunk the full config's: train_4k's
    4096 tokens in 16 chunks, as the arch runs them, not in the reduced
    config's 512 (the chunk sets no parameter's shape)."""
    cfg = get_config(arch).reduced()
    if cfg.ssm is None:
        return cfg
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk_size=get_config(arch).ssm.chunk_size))


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_trains_at_train_4k_on_a_fake_mesh(arch):
    cfg = _reduced(arch)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_ROWS, "train")
    mesh = M.make_test_mesh(2, 2, device="meta")
    count = PS.lower_step(PS.build_step(cfg, shape, mesh), mesh).run()
    want = _jax_train_argument_bytes(arch, shape, (2, 2))
    assert count.argument_bytes == [want] * mesh.size
    assert all(p > a for p, a in zip(count.peak_bytes, count.argument_bytes))
    assert all(f > 0 for f in count.flops)
    # every layer replayed its count, forward and backward: over each
    # replica's ranks, or over the whole mesh where an MoE layer routes
    # every replica's tokens
    layers = cfg.num_layers + cfg.num_encoder_layers
    moe = any(map(cfg.is_moe_layer, range(cfg.num_layers)))
    assert count.routes["block"] == 2 * layers * (1 if moe else 2)
