"""The dry run's training row on a fake mesh: each layer of a reduced
training step over a (data, model) mesh (``models/transformer.py::
checkpoint_tp``: tensor-parallel, the MoE routed over the whole mesh,
rematerialized) replaying its op-by-op count (``roofline/counting.py::
counted_call``) against the same step op by op; what each device holds
at its peak, by the op that made it; and a mesh laid over one device.
"""

import contextlib

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as PS
from repro_torch.roofline.analysis import memory_of
from repro_torch.roofline.counting import op_by_op

LIMIT_REL = 0.01          # bytes accessed and each device's peak


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


def _rel(a, b):
    return abs(a - b) / b if b else abs(a - b)


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-v0.1-52b",
                                  "deepseek-v3-671b", "seamless-m4t-medium"])
def test_block_route_matches_the_op_by_op_count(arch):
    """A reduced training step on a fake (2, 2) mesh, its layers
    (``transformer.checkpoint_tp``: tensor-parallel, the MoE routed over
    the whole mesh, rematerialized) replayed, against the same step op by
    op: FLOPs and the bytes copied between devices, by (source,
    destination, kind), equal; bytes accessed and peaks by device within
    ``LIMIT_REL``."""
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("train_small", 64, 4, "train")

    def run(route):
        mesh = M.make_test_mesh(2, 2, device="meta")
        lowered = PS.lower_step(PS.build_step(cfg, shape, mesh), mesh)
        with contextlib.nullcontext() if route else op_by_op():
            return lowered.run()

    route, plain = run(True), run(False)
    assert route.flops == plain.flops
    assert route.copies == plain.copies
    for a, b in zip(route.bytes_accessed, plain.bytes_accessed):
        assert _rel(a, b) <= LIMIT_REL, (a, b)
    for a, b in zip(route.peak_bytes, plain.peak_bytes):
        assert _rel(a, b) <= LIMIT_REL, (a, b)
    assert route.routes["block"] and not plain.routes


def _lowered(cfg, sizes, devices=None):
    """A reduced training step (4 rows of 64 tokens) placed on a fake
    mesh of ``sizes``, on ``devices`` or on distinct fake devices."""
    shape = ShapeConfig("train_small", 64, 4, "train")
    mesh = M.make_test_mesh(*sizes, devices=devices) if devices else \
        M.make_test_mesh(*sizes, device="meta")
    return PS.lower_step(PS.build_step(cfg, shape, mesh), mesh)


@pytest.mark.parametrize("route", [True, False])
def test_peak_by_op_sums_to_the_peak(route):
    """What each device held at its peak, grouped by the op that made it,
    sums to its peak, with the layers replayed or op by op; ``memory_of``
    lists the busiest device's groups, the step's arguments whole under
    ``arguments`` and a replayed layer's bytes under its name."""
    lowered = _lowered(get_config("qwen2-7b").reduced(), (1, 2))
    with contextlib.nullcontext() if route else op_by_op():
        count = lowered.run()
    assert len(count.peak_by_op) == 2
    for groups, peak in zip(count.peak_by_op, count.peak_bytes):
        assert sum(groups.values()) == peak
    mem = memory_of(count)
    assert sum(mem["peak_by_op"].values()) == mem["peak_bytes"]
    assert mem["peak_by_op"]["arguments"] == mem["argument_bytes"]
    assert any(op.startswith("block ") for op in mem["peak_by_op"]) == route
    assert sum(g["bytes"] for g in mem["peak_by_tensor"]) <= mem["peak_bytes"]


def test_a_mesh_over_one_device_counts_it_once():
    """A (1, 2) mesh laid over one fake device, as phase 16d lays one over
    one card, is counted as that device: its arguments and FLOPs are the
    two devices' of a mesh over two, and the layers take their route."""
    cfg = get_config("gemma-2b").reduced()
    one = _lowered(cfg, (1, 2), devices=("meta:0",) * 2).run()
    two = _lowered(cfg, (1, 2)).run()
    assert one.devices == ("meta:0",)
    assert one.argument_bytes == [sum(two.argument_bytes)]
    assert one.flops == [sum(two.flops)]
    assert one.routes["block"] == two.routes["block"] > 0
    assert max(two.peak_bytes) < one.peak_bytes[0] <= sum(two.peak_bytes)
