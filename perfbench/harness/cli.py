"""``perfbench/run.py``: run one cell, check it, print its result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` a ``breakdown``, and last ``checks``: each number compared with its
limit, which are also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

from perfbench.harness import check, driver, registry
from perfbench.harness.trace import Profiler

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".")[0] for name in names}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _metrics(names: list, run) -> dict:
    out = {}
    for metric in names:
        value = registry.module("metrics", metric["name"]).read(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def _label(run, start: float, end: float) -> str:
    """What the host was doing over a gap on the device: the benchmark's
    spans it overlaps, by tenant."""
    parts = sorted({f"t{s.tenant}:{s.name}" for s in run.spans
                    if s.start < end and s.end > start})
    return "+".join(parts) if parts else "no span (harness)"


def breakdown(run) -> dict:
    tr = run.trace
    by_name: dict = {}
    for op in tr.named(("",), run.t0, run.close):
        by_name[op.name] = by_name.get(op.name, 0.0) + op.end - op.start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.gaps(run.t0, run.close), key=lambda g: g[0] - g[1])
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[_label(run, s, e), e - s] for s, e in gaps[:10]]}


def execute(workload: str, seed: int, seconds: float, *, trace: bool,
            control: bool, device: str, process_start: float,
            cell: dict | None = None) -> dict:
    """Run one cell end to end; returns the result object."""
    import torch
    cell = cell or registry.cell(workload)
    config = cell["config"]
    run = driver.Run(workload, config, cell["traffic"], int(seed),
                     float(seconds), device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fe, sampler = driver.build(run, device=device)
    prof = Profiler() if trace else None
    try:
        driver.drive(run, fe, on_warmed=prof.start if prof else None,
                     on_start=prof.mark if prof else None)
    finally:
        if prof is not None:
            run.trace = prof.stop(run.t0, run.t0_ns, run.close) \
                if run.t0 else None
    run.setup_s = run.t0 - process_start
    if on_card:
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    metrics = _metrics(cell["per_layer"] if trace else cell["end_to_end"],
                       run)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    if trace:
        busy = 0.0 if run.trace is None else run.trace.busy_s(run.t0,
                                                              run.close)
        dev.update(busy_s=busy, window_s=run.seconds)

    # the program's state goes before the reference runs
    fe.close()
    run.tenants = []
    del fe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings, low, compared = check.check_solves(
        run, sampler.kept, device=device, control=control)
    policy, policy_low, state_gap = check.check_policy(run, control=control)
    readings.update(policy)
    readings["stale_faults"] = check.stale_faults(run)
    limits = config["limits"]
    correct, rows = check.verdict(readings, limits)
    if compared < 1:
        correct = False
    window = run.window_selects()
    result = {"correct": correct, "attempted": len(window),
              "failed": sum(1 for r in window if not r.ok),
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        result["breakdown"] = breakdown(run)
    result["info"] = {
        "card": card_line() if on_card else "cpu",
        "solves_compared": compared,
        "partition_mismatch": readings.get("partition_mismatch"),
        "state_gap": state_gap,
        "setup_s": run.setup_s,
        "check_s": time.perf_counter() - t_check,
        "selects": len(window),
        "publishes_in_window": len(run.window_publishes())}
    if control:
        low.update(policy_low)
        for name in check.EXACT:
            low[name] = readings[name]
        ok_low, rows_low = check.verdict(low, limits)
        result["control"] = {"correct": ok_low, "checks": {
            n: {"value": v, "limit": lim} for n, v, lim in rows_low}}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result


def main(argv=None, *, process_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the lower-precision control's numbers "
                         "(the control test; not part of a measured run)")
    args = ap.parse_args(argv)
    cell = registry.cell(args.workload)
    import torch
    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()} (cuda available: "
              f"{torch.cuda.is_available()}); no result", file=sys.stderr)
        return 3
    result = execute(args.workload, args.seed, args.seconds,
                     trace=bool(args.trace), control=args.control,
                     device="cuda", process_start=process_start, cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
