"""The port's analytic roofline (``repro_torch/roofline/``) against the
JAX package's calculator.

Every count (forward and step FLOPs, cache and step bytes, collective
bytes) equals the JAX package's to 1e-12 relative for every arch, the
four workload shapes and five mesh shapes; ``roofline_terms``' seconds
are the JAX counts over the port's H100 table, which keeps the JAX
table's field names.
"""

import pytest

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.roofline import analysis as JA
from repro.roofline import calculator as JC
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.roofline import analysis as PA
from repro_torch.roofline import calculator as PC

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESH_SHAPES = ((1, 1), (4, 1), (1, 4), (2, 2), (16, 16))
REL = 1e-12


def _close(got, want):
    """Equal dicts of numbers (and of dicts of numbers) to REL."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
        return
    if isinstance(want, str) or want is None:
        assert got == want
        return
    assert abs(got - want) <= REL * max(abs(want), 1e-300), (got, want)


def test_h100_table():
    hw = PA.HW
    assert (hw.peak_flops, hw.peak_flops_f32, hw.hbm_bw, hw.ici_bw,
            hw.hbm_bytes) == (989e12, 67e12, 3.35e12, 450e9, 80e9)
    # the JAX table's fields, every one of them
    assert set(vars(JA.HW)) <= set(vars(hw))


@pytest.mark.parametrize("mesh", MESH_SHAPES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", list_archs())
def test_calculator_matches_jax(arch, shape_name, mesh):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jshape, shape = JAX_SHAPES[shape_name], SHAPES[shape_name]
    jm, pm = JC.MeshShape(*mesh), PC.MeshShape(*mesh)
    assert pm.chips == jm.chips
    G = 1 if shape.kind != "train" else 4
    for ea in ("full", "causal"):
        _close(PC.forward_flops(cfg, shape, executed_attention=ea),
               JC.forward_flops(jcfg, jshape, executed_attention=ea))
        _close(PC.step_flops(cfg, shape, executed_attention=ea),
               JC.step_flops(jcfg, jshape, executed_attention=ea))
    _close(PC.cache_bytes(cfg, shape), JC.cache_bytes(jcfg, jshape))
    _close(PC.step_bytes(cfg, shape, pm, G), JC.step_bytes(jcfg, jshape, jm, G))
    _close(PC.step_collective_bytes(cfg, shape, pm, G),
           JC.step_collective_bytes(jcfg, jshape, jm, G))
    _close(PA.model_flops(cfg, shape), JA.model_flops(jcfg, jshape))

    got = PC.roofline_terms(cfg, shape, pm, G)
    want = JC.roofline_terms(jcfg, jshape, jm, G)
    chips, hw = jm.chips, PA.HW
    seconds = {
        "compute": want["executed_flops"] / (chips * hw.peak_flops),
        "memory": want["bytes_breakdown"]["total"] / (chips * hw.hbm_bw),
        "collective": (want["collective_breakdown"]["total"]
                       / (chips * hw.ici_bw))}
    for term, s in seconds.items():
        _close(got[f"{term}_s"], s)
    assert got["bottleneck"] == max(seconds, key=seconds.get)
    _close(got["step_s_bound"], max(seconds.values()))
    for key in ("model_flops", "executed_flops", "useful_flop_ratio",
                "flops_breakdown", "bytes_breakdown",
                "collective_breakdown", "chips"):
        _close(got[key], want[key])


@pytest.mark.parametrize("data, model, pod", [(2, 2, 1), (4, 1, 1),
                                              (1, 4, 1), (2, 2, 2)])
def test_mesh_shape_of_a_named_mesh(data, model, pod):
    mesh = make_test_mesh(data, model, pod, device="cpu")
    ms = PC.mesh_shape_of(mesh)
    assert (ms.dp, ms.tp) == (data * pod, model)
    assert JC.mesh_shape_of(mesh) == JC.MeshShape(ms.dp, ms.tp)
    cfg = get_config("qwen2-7b")
    assert PC.roofline_terms(cfg, SHAPES["decode_32k"], mesh)["chips"] == \
        data * model * pod
