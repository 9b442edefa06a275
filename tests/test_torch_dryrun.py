"""The dry run: ``launch/steps.py::lower_step`` on fake devices,
``roofline/counting.py``'s counts, ``roofline/analysis.py``'s records
and ``launch/dryrun.py``'s command line.

Reduced configs of one arch per family (qwen2-7b: attention; jamba:
SSM and MoE; deepseek-v3: MLA, MoE and the MTP head;
seamless-m4t-medium: the encoder-decoder) on fake meshes.  The argument
bytes a device holds after placement are held, exactly, to the JAX
package's own specs cutting its global shapes; the FLOPs of a fake
mesh to ``FlopCounterMode`` over the same step run on a CPU mesh.
"""

import importlib.util
import json
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import steps as JS
from repro.models import sharding as JSH
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_work, live_entries
from repro_torch.kernels.ssd import ssd_work
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as PS
from repro_torch.models import parallel as PL
from repro_torch.models import sharding as SH
from repro_torch.roofline.analysis import (HW, collective_bytes,
                                           extract_cost, memory_of,
                                           model_flops, roofline_report)
from repro_torch.roofline.counting import StepCounter
from repro_torch.tree import tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("qwen2-7b", "jamba-v0.1-52b", "deepseek-v3-671b",
            "seamless-m4t-medium")
MESHES = ((1, 1), (2, 2), (1, 4), (2, 2, 2))
KINDS = ("train", "prefill", "decode", "long")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module (its tensors are tiny; under
    pytest-xdist a thread a core per worker oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def shape_of(kind, cfg):
    """Small shapes of each kind; ``long`` is the batch-1 windowed
    decode (the name ``long_500k`` selects its layout and window)."""
    if kind == "train":
        return ShapeConfig("train_small", 16, 8, "train")
    if kind == "prefill":
        # the encoder-decoder's source frames are its prompt length
        return ShapeConfig("prefill_small", cfg.encoder_seq_len, 4, "prefill")
    if kind == "decode":
        return ShapeConfig("decode_small", 32, 4, "decode")
    return ShapeConfig("long_500k", 64, 1, "decode")


def fake_mesh(sizes):
    if len(sizes) == 2:
        return M.make_test_mesh(*sizes, device="meta")
    pod, data, model = sizes
    return M.make_test_mesh(data, model, pod, device="meta")


def cpu_mesh(sizes):
    n = math.prod(sizes)
    if len(sizes) == 2:
        return M.make_test_mesh(*sizes, devices=("cpu",) * n)
    pod, data, model = sizes
    return M.make_test_mesh(data, model, pod, devices=("cpu",) * n)


# -- (a) argument bytes against the JAX specs ---------------------------------

def _jax_names(sizes):
    return ("data", "model") if len(sizes) == 2 else ("pod", "data", "model")


def _cut_bytes(tree, specs, amesh) -> int:
    """A device's bytes of ``tree`` (ShapeDtypeStructs) cut by ``specs``
    (PartitionSpecs or NamedShardings)."""
    total = 0
    xs = jax.tree.leaves(tree)
    ss = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
        s, (PartitionSpec, NamedSharding)))
    assert len(xs) == len(ss)
    for x, s in zip(xs, ss):
        sh = s if isinstance(s, NamedSharding) else NamedSharding(amesh, s)
        total += math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
    return total


_JAX_PARAMS = {}


def jax_argument_bytes(arch, kind, sizes) -> int:
    """The bytes one device holds of the JAX package's arguments: its
    params (and optimizer state), cache and batch as ``jax.eval_shape``
    gives them, cut by its own specs on an abstract mesh.  Scalars (the
    train step, a lockstep decode position) are left out: the port
    passes them as Python ints."""
    cfg = jax_config(arch).reduced()
    shape = shape_of(kind, cfg)
    jshape = JaxShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                            shape.kind)
    amesh = AbstractMesh(sizes, _jax_names(sizes))
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = JS.params_specs(cfg)
    params = _JAX_PARAMS[arch]
    total = _cut_bytes(params, JSH.params_pspecs(params, amesh), amesh)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt = JS.make_optimizer(cfg)
        state = jax.eval_shape(opt.init, params)
        total += _cut_bytes(state, JSH.params_pspecs(state, amesh), amesh)
    if shape.kind in ("train", "prefill"):
        batch = JS.batch_specs(cfg, jshape)
        shard = JS.batch_shardings(cfg, jshape, amesh)
        if shape.kind == "prefill":
            batch.pop("labels")
            shard.pop("labels")
        return total + _cut_bytes(batch, shard, amesh)
    cache = JS.cache_specs(cfg, B, S)
    total += _cut_bytes(cache, JS.cache_pspecs(cache, amesh, B), amesh)
    rows = [jax.ShapeDtypeStruct((B, 1), jnp.int32)]
    if not (cfg.is_encoder_decoder or JS.decode_window(cfg, jshape)):
        rows.append(jax.ShapeDtypeStruct((B,), jnp.int32))
    for r in rows:
        spec = JSH.batch_pspec(amesh, r.ndim, 0, B)
        total += _cut_bytes([r], [spec], amesh)
    return total


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_equal_the_jax_specs(arch, kind, sizes):
    cfg = get_config(arch).reduced()
    mesh = fake_mesh(sizes)
    lowered = PS.lower_step(PS.build_step(cfg, shape_of(kind, cfg), mesh),
                            mesh)
    counter = StepCounter(mesh.devices)
    counter.track_arguments(lowered.args)
    want = jax_argument_bytes(arch, kind, sizes)
    assert counter.argument_bytes == [want] * mesh.size


# -- (b) FLOPs against FlopCounterMode on a CPU mesh --------------------------

def _real_args(bundle, cfg, shape):
    """The bundle's args drawn for a real run from a seed: token ids in
    the vocabulary, decode positions 3."""
    g = torch.Generator().manual_seed(0)

    def draw(t):
        if t.dtype.is_floating_point:
            return (torch.randn(tuple(t.shape), generator=g) * 0.02).to(
                t.dtype)
        return torch.randint(0, cfg.vocab_size, tuple(t.shape), generator=g,
                             dtype=t.dtype)

    args = [tree_map(draw, a) for a in bundle.args]
    if shape.kind == "decode":
        args[3] = torch.full(tuple(args[3].shape), 3, dtype=args[3].dtype)
    return tuple(args)


@pytest.mark.parametrize("arch, kind, sizes", [
    ("qwen2-7b", "train", (2, 2)),
    ("jamba-v0.1-52b", "prefill", (1, 2)),
    ("deepseek-v3-671b", "decode", (2, 2)),
    ("seamless-m4t-medium", "train", (1, 2)),
    ("qwen2-7b", "long", (2, 2)),
])
def test_fake_mesh_flops_equal_an_eager_cpu_run(arch, kind, sizes):
    cfg = get_config(arch).reduced()
    shape = shape_of(kind, cfg)
    fake = fake_mesh(sizes)
    count = PS.lower_step(PS.build_step(cfg, shape, fake), fake).run()

    cpu = cpu_mesh(sizes)
    bundle = PS.build_step(cfg, shape, cpu)
    args = bundle.place(_real_args(bundle, cfg, shape))
    with FlopCounterMode(display=False) as fc:
        bundle.fn(*args)
    assert fc.get_total_flops() > 0
    assert sum(count.flops) == fc.get_total_flops()


# -- (c) the kernels' shape-only routes ---------------------------------------

def _mask_count(S, T, causal, window):
    s = np.arange(S)[:, None]
    t = np.arange(T)[None, :]
    live = np.ones((S, T), bool)
    if causal:
        live &= t <= s
    if window is not None:
        live &= t > s - window
    return int(live.sum())


@pytest.mark.parametrize("window", [None, 1, 3, 8, 40])
@pytest.mark.parametrize("causal", [True, False])
def test_live_entries_equal_the_mask_count(causal, window):
    for S in (1, 2, 5, 16, 33):
        for T in (1, 3, 16, 33, 70):
            assert live_entries(S, T, causal, window) == \
                _mask_count(S, T, causal, window), (S, T)


def _counted(fn, device="meta:0"):
    counter = StepCounter([device])
    with FakeTensorMode(), counter:
        out = fn()
    return counter, out


@pytest.mark.parametrize("causal, window", [(True, None), (True, 5),
                                            (False, None)])
def test_flash_shape_route_counts_its_work(monkeypatch, causal, window):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(ops._flash_attention.ref, "flash_attention_ref",
                        refuse)
    B, S, T, H, K, dh, dv = 2, 24, 40, 8, 2, 192, 128

    def call():
        q = torch.empty(B, S, H, dh, dtype=torch.bfloat16, device="meta:0")
        k = torch.empty(B, T, K, dh, dtype=torch.bfloat16, device="meta:0")
        v = torch.empty(B, T, K, dv, dtype=torch.bfloat16, device="meta:0")
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    counter, out = _counted(call)
    ops_, nbytes = flash_work(B, S, T, H, K, dh, dv, causal=causal,
                              window=window, itemsize=2)
    assert ops_ == B * H * _mask_count(S, T, causal, window) * (
        2 * dh + 2 * dv + 5)
    assert counter.flops == [ops_]
    assert counter.bytes_accessed == [nbytes]
    assert counter.kernels == {"flash_attention": 1}
    assert tuple(out.shape) == (B, S, H, dv) and out.dtype == torch.bfloat16
    assert str(out.device) == "meta:0"
    assert ops.LAUNCH_COUNTS["flash_attention"] == 0


def test_ssd_shape_route_counts_its_work(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(ops._ssd.ref, "ssd_chunk_ref", refuse)
    B, c, Q, H, P, G, N = 2, 3, 16, 8, 64, 1, 16

    def call():
        xdt = torch.empty(B, c, Q, H, P, device="meta:1")
        cs = torch.empty(B, c, Q, H, device="meta:1")
        Bm = torch.empty(B, c, Q, G, N, dtype=torch.bfloat16,
                         device="meta:1")
        return ops.ssd_chunk(xdt, cs, Bm, torch.empty_like(Bm))
    counter, (y, st) = _counted(call, "meta:1")
    ops_bc, ops_f32, nbytes = ssd_work(B, c, Q, H, P, G, N, bc_itemsize=2)
    tri = Q * (Q + 1) // 2
    assert ops_bc == B * c * G * tri * 2 * N
    assert counter.flops == [ops_bc + ops_f32]
    assert counter.bytes_accessed == [nbytes]
    assert counter.kernels == {"ssd_chunk": 1}
    assert tuple(y.shape) == (B, c, Q, H, P) and y.dtype == torch.float32
    assert tuple(st.shape) == (B, c, H, P, N)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_bounds_count_the_same_work():
    cs = _chip_smoke()
    ops_, nbytes = flash_work(1, 64, 80, 4, 2, 128, 128, causal=True,
                              window=None, itemsize=2)
    t_ops = ops_ / cs.PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / cs.PEAK_BYTES_S * 1e3
    assert cs._flash_bound(1, 64, 80, 4, 2, 128, True, None, "bf16")[:2] == \
        ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"))
    ops_bc, ops_f32, nbytes = ssd_work(1, 2, 16, 8, 64, 1, 128)
    t_ops = (ops_bc / cs.PEAK_F32_FLOPS + ops_f32 / cs.PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / cs.PEAK_BYTES_S * 1e3
    assert cs._ssd_bound(1, 2, 16, 8, 64, 1, 128, "f32")[0] == \
        max(t_ops, t_bytes)


@pytest.mark.parametrize("arch, kind", [("qwen2-7b", "prefill"),
                                        ("jamba-v0.1-52b", "prefill")])
def test_serving_step_takes_the_shape_routes(arch, kind):
    cfg = get_config(arch).reduced()
    mesh = fake_mesh((1, 2))
    lowered = PS.lower_step(PS.build_step(cfg, shape_of(kind, cfg), mesh),
                            mesh)
    with ops.use_pallas_scoped(True):
        count = lowered.run()
    assert count.kernels["flash_attention"] > 0
    if arch.startswith("jamba"):
        assert count.kernels["ssd_chunk"] > 0
    assert ops.LAUNCH_COUNTS["flash_attention"] == 0


# -- (d) collectives ----------------------------------------------------------

def test_one_device_step_copies_nothing():
    cfg = get_config("qwen2-7b").reduced()
    mesh = fake_mesh((1, 1))
    count = PS.lower_step(PS.build_step(cfg, shape_of("decode", cfg), mesh),
                          mesh).run()
    assert count.copies == {}
    assert collective_bytes(count)["total_bytes"] == 0


@pytest.mark.parametrize("D", [2, 4, 8])
def test_broadcast_and_reduce_move_d_minus_one_copies(D):
    devs = [torch.device("meta", i) for i in range(D)]
    counter = StepCounter(devs)
    with FakeTensorMode(), counter:
        x = torch.empty(5, 7, device=devs[0])
        PL.broadcast_to(x, devs)
        PL.reduce_to([torch.empty(5, 7, device=d) for d in devs], devs[0])
    coll = collective_bytes(counter.result())
    assert coll["broadcast"] == (D - 1) * 5 * 7 * 4
    assert coll["reduce"] == (D - 1) * 5 * 7 * 4
    assert coll["counts"] == {"broadcast": D - 1, "reduce": D - 1}
    assert coll["per_device"]["sent"][0] == (D - 1) * 140
    assert coll["per_device"]["received"][0] == (D - 1) * 140


def test_sharded_local_gathers_over_data():
    mesh = fake_mesh((2, 1))
    with FakeTensorMode():
        leaf = SH.shard_params({"wq": torch.empty(8, 4, device="meta:0")},
                               mesh)["wq"]
        counter = StepCounter(mesh.devices)
        with counter:
            leaf.local(0)
    coll = collective_bytes(counter.result())
    assert coll["gather"] == 4 * 4 * 4 and coll["counts"] == {"gather": 1}
    assert coll["pairs"] == {"meta:1->meta:0": 64.0}


# -- (e) memory on a hand-sized case ------------------------------------------

def test_peak_and_temp_bytes_by_hand():
    n = 1024
    counter = StepCounter(["meta:0"])
    with FakeTensorMode() as mode:
        x = torch.empty(n, device="meta:0")
        with counter:
            counter.track_arguments((x,))
            a = x * 2          # + 4n live: 8n
            b = a + 1          # + 4n live: 12n, the peak
            del a              # 8n
            c = b.sum()        # + 4
            counter.track_outputs((b, c))
    count = counter.result()
    assert count.argument_bytes == [4 * n]
    assert count.peak_bytes == [12 * n]
    assert count.temp_bytes == [8 * n]
    assert count.output_bytes == [4 * n + 4]
    # x*2, a+1 and the sum: inputs and outputs
    assert count.bytes_accessed == [4 * n * 2 + 4 * n * 2 + 4 * n + 4]
    mem = memory_of(count)
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    del mode


def test_memory_record_reads_the_busiest_device():
    mesh = fake_mesh((1, 2))
    cfg = get_config("qwen2-7b").reduced()
    count = PS.lower_step(PS.build_step(cfg, shape_of("decode", cfg), mesh),
                          mesh).run()
    mem = memory_of(count)
    top = count.peak_bytes.index(max(count.peak_bytes))
    assert mem["device"] == count.devices[top]
    assert mem["peak_bytes"] == max(count.peak_bytes)
    assert mem["per_device"]["argument_bytes"] == count.argument_bytes
    assert all(p >= a for p, a in zip(count.peak_bytes,
                                      count.argument_bytes))
    cost = extract_cost(count)
    assert cost["flops"] == max(count.flops) > 0


# -- (f) the roofline report --------------------------------------------------

def test_roofline_report_against_hand_values():
    cfg = get_config("qwen2-7b")                   # bf16
    shape = ShapeConfig("decode_32k", 32768, 128, "decode")
    mesh = M.make_production_mesh(device="meta")
    rec = {"cost": {"flops": 989e9, "bytes_accessed": 6.7e9,
                    "per_device": {"flops": [989e9] * 8}},
           "collectives": {"per_device": {"sent": [450e6, 9e8],
                                          "received": [0.0, 2.25e8]}}}
    r = roofline_report(cfg, shape, mesh, rec)
    assert r["compute_s"] == pytest.approx(989e9 / HW.peak_flops)
    assert r["compute_s"] == pytest.approx(1e-3)
    assert r["memory_s"] == pytest.approx(2e-3)
    assert r["collective_s"] == pytest.approx(2e-3)
    assert r["bottleneck"] == "memory"
    assert r["model_flops"] == model_flops(cfg, shape) == \
        2.0 * cfg.active_param_count() * 128
    assert r["counted_flops_global"] == pytest.approx(8 * 989e9)
    assert r["useful_flop_ratio"] == pytest.approx(
        r["model_flops"] / (8 * 989e9))
    assert "HBM" in r["suggestion"]
    f32 = roofline_report(get_config("qwen2-7b").reduced(), shape, mesh, rec)
    assert f32["compute_s"] == pytest.approx(989e9 / HW.peak_flops_f32)
    assert f32["bottleneck"] == "compute"
    assert "tensor cores" in f32["suggestion"]


# -- (g) the command line end to end ------------------------------------------

@pytest.fixture
def reduced_configs(monkeypatch):
    """The command line's configs reduced (a full-width step takes
    minutes)."""
    from repro_torch import configs
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda arch: full(arch).reduced())


def test_cli_writes_a_record(tmp_path, capsys, reduced_configs):
    rc = dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k",
                      "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "qwen2-7b__decode_32k__2x4.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["num_devices"] == 8
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes", "per_device"}
    assert len(rec["memory"]["per_device"]["peak_bytes"]) == 8
    assert set(rec["cost"]) >= {"flops", "bytes_accessed"}
    assert {"total_bytes", "counts"} <= set(rec["collectives"])
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["fits"] is True
    assert rec["roofline"]["chips"] == 8
    assert rec["roofline_counted"]["bottleneck"] in ("compute", "memory",
                                                     "collective")
    assert "run_seconds" in rec and "lower_seconds" not in rec
    assert "[ok] qwen2-7b x decode_32k x 2x4" in capsys.readouterr().out
    rc = dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k",
                      "--out", str(tmp_path), "--skip-existing"])
    assert rc == 0 and "[skip]" in capsys.readouterr().out


def test_cli_records_a_failure(tmp_path, reduced_configs):
    rc = dryrun.main(["--arch", "qwen2-7b", "--shape", "no_such_shape",
                      "--mesh", "multi", "--out", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "qwen2-7b__no_such_shape__2x2x4.json")
                     .read_text())
    assert rec["status"] == "error" and "no_such_shape" in rec["error"]


# -- (h) no leaks -------------------------------------------------------------

def test_the_port_imports_neither_jax_nor_repro():
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert [str(f) for f in files if bad.search(f.read_text())] == []


@pytest.mark.parametrize("call", [
    lambda x: ops.pairwise_sq_dists(x, x),
    lambda x: ops.rbf_affinity(x, 0.5),
    lambda x: ops.rbf_cross_affinity(x, x, 0.5),
    lambda x: ops.panel_matmul(x, x),
    lambda x: ops.quantized_cross_affinity(x, x, 0.5),
    lambda x: ops.nystrom_colsum(x, x, 0.5),
], ids=["B7", "B8", "B6", "B5", "B1", "B2"])
@pytest.mark.parametrize("device", ["cpu", "meta:0"])
def test_other_wrappers_refuse_a_fake_tensor(call, device):
    with FakeTensorMode():
        x = torch.empty(8, 4, device=device)
        with pytest.raises(ValueError, match="fake"):
            call(x)


def test_production_and_fake_meshes():
    single = M.make_production_mesh(device="meta")
    assert single.shape == {"data": 2, "model": 4}
    assert single.devices == tuple(torch.device("meta", i) for i in range(8))
    multi = M.make_production_mesh(multi_pod=True, device="meta")
    assert multi.shape == {"pod": 2, "data": 2, "model": 4}
    assert M.mesh_name(single) == "2x4" and M.mesh_name(multi) == "2x2x4"
    assert M.as_mesh(["meta:3", "meta:0"]) == (torch.device("meta", 3),
                                               torch.device("meta", 0))
    for bad, match in ((["meta"], "fake devices"),
                       (["meta:0", "cpu"], "mix"),
                       ([torch.device("meta", 127), "meta:128"],
                        "fake devices")):
        with pytest.raises(ValueError, match=match):
            M.as_mesh(bad)


def test_lower_step_refuses_a_real_mesh():
    cfg = get_config("qwen2-7b").reduced()
    mesh = cpu_mesh((1, 2))
    with pytest.raises(ValueError, match="fake devices"):
        PS.lower_step(PS.build_step(cfg, shape_of("decode", cfg), mesh), mesh)


def test_two_host_production_mesh_places_as_the_jax_specs():
    """The 16-device (pod 2, data 2, model 4) mesh: every device holds
    what the JAX specs cut for it."""
    cfg = get_config("qwen2-7b").reduced()
    mesh = M.make_production_mesh(multi_pod=True, device="meta")
    lowered = PS.lower_step(PS.build_step(cfg, shape_of("decode", cfg),
                                          mesh), mesh)
    counter = StepCounter(mesh.devices)
    counter.track_arguments(lowered.args)
    assert counter.argument_bytes == [
        jax_argument_bytes("qwen2-7b", "decode", (2, 2, 4))] * 16
