"""CPU tests of the harness: traffic, the end-to-end arithmetic, the
import rule, the refusal without a card, and the frozen kernel counts."""

import ast
import json
import math
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from perfbench.harness import cli, registry, stats
from perfbench.harness.traffic import TableLog, TenantTraffic

ROOT = registry.ROOT
PERFBENCH = registry.PERFBENCH


def _mix(name):
    return registry.load_json(PERFBENCH / "traffic" / f"{name}.json")


def _config(name):
    return registry.load_json(PERFBENCH / "configs" / f"{name}.json")


def _small(config):
    return dict(config, num_clients=5000)


def test_traffic_gives_the_same_rounds_for_the_same_seed():
    cfg, traffic = _small(_config("cohort-stackoverflow-342k")), \
        _mix("rounds-closed")
    a, b = (TenantTraffic(cfg, traffic, 2 ** 31 + 7, 1) for _ in range(2))
    c = TenantTraffic(cfg, traffic, 2 ** 31 + 8, 1)
    assert np.array_equal(a.initial, b.initial)
    assert not np.array_equal(a.initial, c.initial)
    ids = np.arange(0, 5000, 97)
    for _ in range(11):
        ua, ub = a.updates(ids), b.updates(ids)
        assert len(ua) == len(ub) == 1
        for (ia, ra), (ib, rb) in zip(ua, ub):
            assert np.array_equal(ia, ib) and np.array_equal(ra, rb)
    assert a.rounds == 11
    assert np.array_equal(a.table, b.table)
    assert a.accuracy(ids) == b.accuracy(ids)


def test_a_round_moves_only_its_cohort():
    cfg, traffic = _small(_config("cohort-stackoverflow-342k")), \
        _mix("rounds-closed")
    t = TenantTraffic(cfg, traffic, 3, 0)
    ids = np.arange(0, 5000, 7)
    (moved, rows), = t.updates(ids)
    assert np.array_equal(moved, ids)
    assert np.array_equal(t.table[ids], rows)
    still = np.setdiff1d(np.arange(5000), ids)
    assert np.array_equal(t.table[still], t.initial[still])
    step = rows - t.initial[ids]
    assert 0.005 < float(step.std()) < 0.02


def test_a_list_and_an_array_shuffle_alike():
    """The server shuffles each cluster's pool as a list; the reference
    follows it with arrays, so both must draw the same permutation and
    leave the generator in the same place."""
    for n in (1, 2, 7, 1000, 42813):
        pool, arr = list(np.arange(n)), np.arange(n)
        ra, rb = np.random.default_rng(5), np.random.default_rng(5)
        ra.shuffle(pool)
        rb.shuffle(arr)
        assert [int(x) for x in pool] == arr.tolist()
        assert ra.random() == rb.random()


def test_table_log_replays_versions():
    init = np.zeros((4, 2), np.float32)
    log = TableLog(init)
    log.append(np.array([1]), np.ones((1, 2), np.float32))
    log.append(np.array([2]), 2 * np.ones((1, 2), np.float32))
    assert log.versions == 3
    assert log.table(3)[1, 0] == 1 and log.table(3)[2, 0] == 2
    assert log.table(2)[2, 0] == 0 and log.table(1).sum() == 0


def _rec(start, end, ok=True):
    return types.SimpleNamespace(start=start, end=end, ok=ok,
                                 latency_s=end - start)


def test_selects_per_s_counts_whole_selects_only():
    recs = [_rec(0.0, 1.0), _rec(1.0, 2.5), _rec(2.5, 3.2),
            _rec(3.2, 3.9, ok=False)]
    # the window closes at 3.0: the select ending at 3.2 neither counts
    # nor adds time, and a failed one never counts
    assert stats.selects_per_s(recs, 0.0, 3.0) == pytest.approx(2 / 2.5)
    assert stats.selects_per_s(recs, 0.0, 4.0) == pytest.approx(3 / 3.2)
    assert stats.selects_per_s([_rec(0, 5)], 0.0, 1.0) is None


def test_select_p95_is_over_every_select_with_missing_ones_worst():
    recs = [_rec(0, 0.01 * i) for i in range(1, 21)]
    assert stats.select_p95_ms(recs) == pytest.approx(190.0)
    failed = recs[:18] + [_rec(0, 0.001, ok=False),
                          _rec(0, 0.001, ok=False)]
    assert math.isinf(stats.select_p95_ms(failed))
    one_failed = recs[:19] + [_rec(0, 0.001, ok=False)]
    assert stats.select_p95_ms(one_failed) == pytest.approx(190.0)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PERFBENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in cli.FORBIDDEN, f"{path} imports {name}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PERFBENCH / "reference").rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in ("repro_torch", "repro"), \
                f"{path} imports {name}"


def test_forbidden_modules_compares_whole_top_level_names():
    assert cli.forbidden_modules(["repro_torch.cohort", "numpy"]) == []
    assert cli.forbidden_modules(["repro.cohort", "jax.numpy",
                                  "jaxlib", "jaxtyping", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def _run_cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "so342k-inline",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=600)


def _no_result(out):
    for line in out.strip().splitlines()[-1:]:
        with pytest.raises(ValueError):
            json.loads(line)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_cli(ROOT, env)
    assert proc.returncode != 0
    _no_result(proc.stdout)
    assert "CUDA device" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0
    _no_result(proc.stdout)


def test_every_name_of_the_benchmark_has_its_files():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        assert cell["config"]["name"] == w["config"]
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        reported = {m["name"] for m in cell["end_to_end"]}
        for m in cell["per_layer"]:
            assert m["moves"] in reported
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.module("metrics", m["name"]).read)


# -- the frozen counts against chip_smoke.py's -----------------------------

@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_counts", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPES = [dict(n=100_000, m=512, d=8, k=8), dict(n=100_000, m=4096, d=8, k=8),
          dict(n=342_477, m=2048, d=8, k=8),
          dict(n=1_660_820, m=4096, d=8, k=8)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s['n']}m{s['m']}")
@pytest.mark.parametrize("kernel", ["quantized_cross_affinity",
                                    "nystrom_colsum", "nystrom_gram",
                                    "nystrom_extension"])
def test_frozen_counts_equal_the_smoke_scripts_bound(smoke, kernel, shape):
    from perfbench.harness import peaks
    ops, nbytes = registry.module("kernels", kernel).count(shape)
    want_ms, _ = smoke._bound(kernel, shape["n"], shape["m"], shape["d"],
                              shape["k"])
    assert peaks.bound_s(ops, nbytes) * 1e3 == pytest.approx(want_ms,
                                                             rel=1e-12)


@pytest.mark.parametrize("r", [8, 64])
def test_frozen_panel_count_equals_the_smoke_scripts_bound(smoke, r):
    from perfbench.harness import peaks
    ops, nbytes = registry.module("kernels", "panel_matmul").count(
        dict(m=4096, r=r))
    want_ms, _ = smoke._bound_slice2("panel_matmul", (4096, 4096, r))
    assert peaks.bound_s(ops, nbytes) * 1e3 == pytest.approx(want_ms,
                                                             rel=1e-12)


def test_frozen_peaks_equal_the_ports_table(smoke):
    from perfbench.harness import peaks
    assert (peaks.PEAK_F32_FLOPS, peaks.PEAK_BF16_FLOPS,
            peaks.PEAK_BYTES_S) == (smoke.PEAK_F32_FLOPS,
                                    smoke.PEAK_BF16_FLOPS,
                                    smoke.PEAK_BYTES_S)
