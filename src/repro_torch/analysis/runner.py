"""repro-torch-lint driver: walk the tree, run every rule family, report.

The port's counterpart of the JAX package's ``repro.analysis.runner``,
line for line: the families are ``purity``, ``kernel_rules`` (for
``pallas_rules``) and ``locks``; the default paths are the port's
(``src/repro_torch`` and ``chip_smoke.py``); the default baseline is
``.repro-torch-lint-baseline.json``, never the JAX package's.

Usage (all equivalent):

    PYTHONPATH=src python -m repro_torch.analysis [paths...] [flags]
    repro-torch-lint [paths...] [flags]        (installed entry point)

Flags:
    --check             exit 1 on findings not in the baseline (CI mode)
    --json              machine-readable output (findings + summary)
    --baseline FILE     baseline path (default
                        .repro-torch-lint-baseline.json)
    --update-baseline   rewrite the baseline from the current findings
    --no-baseline       ignore the baseline entirely
    --list-rules        print the rule catalog and exit

Default paths are ``src/repro_torch`` and ``chip_smoke.py`` — the
analyzer runs on the port and its smoke run, not the tests (fixtures
under tests/analysis_fixtures/torch are deliberately non-compliant and
exercised by tests/test_torch_analysis.py directly).  The tree lints
clean with no baseline file: a deliberate deviation carries an inline
``# repro-lint: ignore[<rule>]`` with its rationale.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Iterable, List, Tuple

from repro_torch.analysis import kernel_rules, locks, purity
from repro_torch.analysis.callgraph import TreeIndex
from repro_torch.analysis.findings import (Finding, RULES, apply_baseline,
                                           filter_suppressed, load_baseline,
                                           save_baseline)

DEFAULT_BASELINE = ".repro-torch-lint-baseline.json"
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


def _collect_files(paths: Iterable[str],
                   root: pathlib.Path) -> List[Tuple[pathlib.Path, str]]:
    files: List[Tuple[pathlib.Path, str]] = []
    for raw in paths:
        p = pathlib.Path(raw)
        if not p.is_absolute():
            p = root / p
        if p.is_file() and p.suffix == ".py":
            candidates = [p]
        elif p.is_dir():
            candidates = sorted(p.rglob("*.py"))
        else:
            raise FileNotFoundError(f"no such path: {raw}")
        for f in candidates:
            try:
                rel = f.resolve().relative_to(root.resolve()).as_posix()
            except ValueError:
                rel = f.as_posix()
            files.append((f, rel))
    return files


def analyze_paths(paths: Iterable[str],
                  root: pathlib.Path | None = None) -> List[Finding]:
    """Run every rule family over ``paths``; suppressions applied,
    baseline NOT applied (that's the caller's policy decision)."""
    root = root or pathlib.Path.cwd()
    tree = TreeIndex(_collect_files(paths, root))
    findings: List[Finding] = []
    findings += purity.check(tree)
    findings += kernel_rules.check(tree)
    findings += locks.check(tree)
    findings = filter_suppressed(findings, tree.sources())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="The port's static analysis: host syncs and RNG, "
                    "kernel-wrapper discipline and the ctypes ABI, lock "
                    "discipline.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to analyze (default: "
                         "src/repro_torch chip_smoke.py)")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: exit 1 on findings not in the baseline")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            print(f"{rule:20s} {RULES[rule]}")
        return 0

    root = pathlib.Path.cwd()
    paths = args.paths or list(DEFAULT_PATHS)
    try:
        findings = analyze_paths(paths, root)
    except FileNotFoundError as e:
        print(f"repro-torch-lint: {e}", file=sys.stderr)
        return 2

    baseline_path = pathlib.Path(args.baseline)
    if not baseline_path.is_absolute():
        baseline_path = root / baseline_path

    if args.update_baseline:
        save_baseline(baseline_path, findings)
        print(f"baseline updated: {len(findings)} finding(s) -> "
              f"{baseline_path}")
        return 0

    baseline = [] if args.no_baseline else load_baseline(baseline_path)
    new, stale = apply_baseline(findings, baseline)

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baselined": len(findings) - len(new),
            "stale_baseline_entries": stale,
            "total": len(findings),
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        grandfathered = len(findings) - len(new)
        bits = [f"{len(new)} finding(s)"]
        if grandfathered:
            bits.append(f"{grandfathered} baselined")
        if stale:
            bits.append(f"{len(stale)} stale baseline entrie(s) — "
                        f"run --update-baseline to expire")
        print("repro-torch-lint: " + ", ".join(bits))

    if args.check:
        return 1 if new else 0
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
