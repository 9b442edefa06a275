"""Find the files that belong to one name: a configuration, a traffic
mix, a metric's reader, a kernel's counts.  A later cell, metric or
kernel is a new file beside these; no file here names them."""

from __future__ import annotations

import importlib.util
import json
import pathlib

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return load_json(ROOT / "BENCHMARK.json")


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` loaded as a module (a name may hold
    dots, so it is loaded by path)."""
    path = PERFBENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, bench: dict | None = None) -> dict:
    """The cell's entry, its configuration and its traffic mix:
    {"cell", "config", "traffic", "end_to_end", "per_layer"}."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; "
                       f"BENCHMARK.json has {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(PERFBENCH / "traffic" / f"{entry['traffic']}.json")

    def reported(metric):
        return workload in metric.get("workloads", [workload])

    return {"cell": entry, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
            "per_layer": [m for m in bench["per_layer"] if reported(m)]}
