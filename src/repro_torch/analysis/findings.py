"""Finding model, suppression comments, and the baseline.

The port's copy of the JAX package's ``repro.analysis.findings``:
:class:`Finding`, :class:`Suppressions`, :func:`filter_suppressed` and
the baseline functions behave as there, byte for byte where a
fingerprint is concerned.  What changed: :data:`RULES` holds the port's
catalog (the ``torch-*`` and ``kernel-*`` rules and the two lock rules)
and no JAX rule id, and the default baseline is
``.repro-torch-lint-baseline.json``, so the port's lint can never
overwrite the JAX package's ``.repro-lint-baseline.json``.

A :class:`Finding` is one rule violation at one source location.  Two
escape hatches keep the analyzer deployable on a living tree:

* **Inline suppressions** — a ``# repro-lint: ignore[rule-id]`` comment
  on the flagged line (or alone on the line directly above it) silences
  that rule there; ``# repro-lint: ignore`` with no bracket silences
  every rule on the line.  The syntax is the JAX package's.
  Suppressions are for *intentional* deviations (e.g. a deliberately
  fixed seed) and should carry a rationale in the same comment.

* **The baseline** — ``.repro-torch-lint-baseline.json`` grandfathers
  findings.  ``--check`` fails only on findings NOT in the baseline;
  ``--update-baseline`` rewrites it from the current tree.  Entries are
  fingerprinted on (rule, path, symbol, stripped source line) rather
  than line numbers, so unrelated edits don't churn it.  Baseline
  entries whose finding has disappeared are *stale* and reported so
  they can be expired with ``--update-baseline``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Tuple

#: rule-id -> one-line description; the single registry every rule
#: family registers into (the port's catalog: README, "The port's lint").
RULES: Dict[str, str] = {
    "torch-host-sync": (
        ".item() / .tolist() / .cpu() / .numpy() / float() / int() / "
        "bool() / np.asarray() inside a function handed to torch.func, "
        "torch.vmap or torch.compile (or an autograd.Function's forward/"
        "backward) — raises under vmap, cuts the graph under grad"),
    "torch-global-rng": (
        "a draw from torch's, numpy's or the stdlib's global generator "
        "(or a reseed of it) — every draw comes from an explicit "
        "torch.Generator (generator=) or numpy Generator"),
    "torch-constant-seed": (
        "torch.Generator().manual_seed(<literal>) / np.random."
        "default_rng(<literal>) inside a function body — every call "
        "replays one stream; seeds enter as parameters"),
    "torch-seed-reuse": (
        "one seed expression seeds two generators in one function with "
        "no derivation between — identical streams"),
    "torch-blocking-sync": (
        "a host read (float()/.item()/.cpu()/...) of a value just "
        "returned by the port's device code — blocks the host on the "
        "card in a hot path; defer materialization"),
    "kernel-ref-oracle": (
        "kernel wrapper <name> has no <name>_ref in the sibling ref.py — "
        "the kernel is untestable against its plain version"),
    "kernel-cpu-route": (
        "kernel wrapper does not call ref.<name>_ref — the kernel must "
        "stay runnable off the card (a CPU tensor runs the plain "
        "version)"),
    "kernel-no-fallback": (
        "kernel wrapper falls back quietly (a try whose handler returns "
        "or calls a *_ref), launches unchecked (lib.rt_* result not "
        "passed to _build.check before launched(<name>)), counts under a "
        "name missing from LAUNCH_COUNTS, or lets a fake tensor reach "
        "lib"),
    "kernel-abi": (
        "ctypes _SIGNATURES entry and the extern \"C\" prototype in csrc/ "
        "disagree in count or kind, one lacks the other, or a wrapper "
        "passes another number of arguments — ctypes converts by the "
        "table and the kernel reads garbage"),
    "lock-guarded-by": (
        "attribute annotated '# guarded-by: <lock>' mutated outside a "
        "'with self.<lock>:' block"),
    "lock-order-cycle": (
        "cycle in the static lock-acquisition graph — a potential "
        "deadlock under concurrent callers"),
}

_SUPPRESS = re.compile(r"#\s*repro-lint:\s*ignore(?:\[([a-z0-9_,\- ]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str                  # repo-relative, forward slashes
    line: int                  # 1-indexed
    message: str
    symbol: str = ""           # enclosing function/class qualname
    source: str = ""           # stripped source line (baseline anchor)

    def fingerprint(self) -> str:
        basis = f"{self.rule}|{self.path}|{self.symbol}|{self.source}"
        return hashlib.sha1(basis.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d

    def render(self) -> str:
        sym = f" ({self.symbol})" if self.symbol else ""
        return f"{self.path}:{self.line}: [{self.rule}]{sym} {self.message}"


class Suppressions:
    """Per-file ``# repro-lint: ignore[...]`` comment index."""

    def __init__(self, source: str):
        # line number (1-indexed) -> set of suppressed rule ids
        # (empty set == suppress everything on that line)
        self._by_line: Dict[int, Optional[set]] = {}
        for i, text in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS.search(text)
            if not m:
                continue
            rules = (set(r.strip() for r in m.group(1).split(","))
                     if m.group(1) else None)      # None == all rules
            self._by_line[i] = rules
            # a comment alone on its line also covers the line below
            if text.split("#", 1)[0].strip() == "":
                self._by_line[i + 1] = rules

    def covers(self, line: int, rule: str) -> bool:
        if line not in self._by_line:
            return False
        rules = self._by_line[line]
        return rules is None or rule in rules


def filter_suppressed(findings: Iterable[Finding],
                      sources: Dict[str, str]) -> List[Finding]:
    """Drop findings silenced by an inline comment in their file."""
    cache: Dict[str, Suppressions] = {}
    kept = []
    for f in findings:
        if f.path not in cache:
            cache[f.path] = Suppressions(sources.get(f.path, ""))
        if not cache[f.path].covers(f.line, f.rule):
            kept.append(f)
    return kept


# -- baseline --------------------------------------------------------------

def load_baseline(path: pathlib.Path) -> List[dict]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    return list(data.get("findings", []))


def save_baseline(path: pathlib.Path, findings: Iterable[Finding]) -> None:
    entries = sorted((f.to_dict() for f in findings),
                     key=lambda d: (d["path"], d["rule"], d["line"]))
    path.write_text(json.dumps(
        {"comment": "repro-torch-lint grandfathered findings; regenerate "
                    "with python -m repro_torch.analysis --update-baseline",
         "findings": entries}, indent=2) + "\n")


def apply_baseline(findings: List[Finding], baseline: List[dict],
                   ) -> Tuple[List[Finding], List[dict]]:
    """Split into (new findings, stale baseline entries)."""
    current = {f.fingerprint() for f in findings}
    known = {e["fingerprint"] for e in baseline}
    new = [f for f in findings if f.fingerprint() not in known]
    stale = [e for e in baseline if e["fingerprint"] not in current]
    return new, stale
