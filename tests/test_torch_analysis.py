"""repro-torch-lint: the port's analyzer and watchdog, against the JAX one.

The cases of ``tests/test_analysis.py`` mirrored on
``repro_torch.analysis`` (fixtures under ``tests/analysis_fixtures/
torch``; the lock fixtures are the JAX package's own), then: the port's
tree lints clean with no baseline file, ``kernel-abi`` catches edits of
a copy of ``kernels/`` that would make ctypes read garbage, and the
shared pieces (fingerprints, suppressions, baselines, the lock family,
``OrderedLock``) behave as the JAX package's on the same inputs.  The
analyzer is stdlib-only, so this file takes seconds.
"""

import ast
import json
import pathlib
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro.analysis import OrderedLock as JaxOrderedLock
from repro.analysis import LockOrderError as JaxLockOrderError
from repro.analysis import findings as jax_findings
from repro.analysis import locks as jax_locks
from repro.analysis.callgraph import TreeIndex as JaxTreeIndex
from repro.analysis.runner import _collect_files as jax_collect_files
from repro_torch.analysis import (LockOrderError, OrderedLock, RULES,
                                  SERVING_LOCK_ORDER, analyze_paths,
                                  instrument)
from repro_torch.analysis import kernel_rules, locks, purity, watchdog
from repro_torch.analysis.callgraph import TreeIndex
from repro_torch.analysis.findings import (Finding, Suppressions,
                                           apply_baseline, load_baseline,
                                           save_baseline)
from repro_torch.analysis.runner import (DEFAULT_BASELINE, _collect_files,
                                         main as lint_main)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures"
TORCH_FIXTURES = FIXTURES / "torch"
PORT = REPO / "src" / "repro_torch"
KERNELS = PORT / "kernels"
PORT_RULES = {"torch-host-sync", "torch-global-rng", "torch-constant-seed",
              "torch-seed-reuse", "torch-blocking-sync", "kernel-ref-oracle",
              "kernel-cpu-route", "kernel-no-fallback", "kernel-abi",
              "lock-guarded-by", "lock-order-cycle"}
_EXPECT = re.compile(r"(?:#|//)\s*expect: ([a-z\-, ]+)")


def run_lint(*relpaths, base=TORCH_FIXTURES):
    return analyze_paths([str(base / p) for p in relpaths], root=REPO)


def rules_of(findings):
    return {f.rule for f in findings}


def sites(findings):
    return {(f.rule, f.path, f.line) for f in findings}


def expected_sites(*relpaths):
    """(rule, path, line) of every ``expect: <rule>`` marker in the
    fixture files (Python or CUDA) under ``relpaths``."""
    out = set()
    for rel in relpaths:
        p = TORCH_FIXTURES / rel
        files = sorted(p.rglob("*")) if p.is_dir() else [p]
        for f in files:
            if f.suffix not in (".py", ".cu", ".cuh"):
                continue
            path = f.relative_to(REPO).as_posix()
            for i, text in enumerate(f.read_text().splitlines(), start=1):
                m = _EXPECT.search(text)
                if m:
                    for rule in m.group(1).split(","):
                        if rule.strip() in RULES:
                            out.add((rule.strip(), path, i))
    return out


def line_of(path, text):
    """1-indexed line of the only line of ``path`` containing ``text``."""
    lines = [i for i, t in enumerate(path.read_text().splitlines(), start=1)
             if text in t]
    assert len(lines) == 1, (path, text, lines)
    return lines[0]


# -- rule catalog ----------------------------------------------------------

def test_every_rule_documented():
    assert set(RULES) == PORT_RULES
    for rule, desc in RULES.items():
        assert rule == rule.lower() and " " not in rule
        assert len(desc) > 20
    # no JAX rule id leaks into the port's catalog
    assert not set(RULES) & (set(jax_findings.RULES) - {
        "lock-guarded-by", "lock-order-cycle"})


def test_list_rules_prints_the_catalog(capsys):
    assert lint_main(["--list-rules"]) == 0
    listed = {line.split()[0] for line in
              capsys.readouterr().out.splitlines() if line.strip()}
    assert listed == PORT_RULES


# -- purity / RNG family ---------------------------------------------------

def test_purity_bad_flags_every_rule():
    fs = run_lint("purity_bad.py")
    assert rules_of(fs) == {"torch-host-sync", "torch-global-rng",
                            "torch-constant-seed", "torch-seed-reuse",
                            "torch-blocking-sync"}


def test_purity_bad_specific_sites():
    fs = run_lint("purity_bad.py")
    assert sites(fs) == expected_sites("purity_bad.py")
    by_rule = {}
    for f in fs:
        by_rule.setdefault(f.rule, []).append(f)
    # four sync shapes: float(), .item(), np.asarray(), bool()
    assert len(by_rule["torch-host-sync"]) == 4
    # reachability: _helper is flagged although only a lambda calls it;
    # an autograd.Function's forward is a root of its own
    syms = {f.symbol for f in by_rule["torch-host-sync"]}
    assert {"_helper", "_Square.forward", "<transform-lambda-1>"} <= syms
    # the blocking read names the device call it waits for, two calls
    # above the functional_call, and a transform's result
    block = sorted(by_rule["torch-blocking-sync"], key=lambda f: f.line)
    assert [f.symbol for f in block] == ["round_boundary"] * 2
    assert "'loss'" in block[0].message and "'out'" in block[1].message


def test_purity_good_is_clean():
    assert run_lint("purity_good.py") == []


# -- kernel family ---------------------------------------------------------

def test_kernels_bad_flags_all_four_rules():
    fs = run_lint("kernels_bad")
    assert rules_of(fs) == {"kernel-ref-oracle", "kernel-cpu-route",
                            "kernel-no-fallback", "kernel-abi"}
    assert sites(fs) == expected_sites("kernels_bad")
    oracle = next(f for f in fs if f.rule == "kernel-ref-oracle")
    assert "no_oracle_ref" in oracle.message


def test_kernels_good_is_clean():
    assert run_lint("kernels_good") == []


def test_prototypes_ignore_comments_strings_and_bodies():
    got = kernel_rules.prototypes(
        (TORCH_FIXTURES / "kernels_good" / "csrc" / "scale.cu").read_text())
    assert list(got) == ["rt_scale"]
    line, ret, kinds = got["rt_scale"]
    assert (line, ret) == (11, "int")
    assert kinds == ["ptr:float", "ptr:float", "float", "int", "ptr:void"]
    shaped = kernel_rules.prototypes(
        (TORCH_FIXTURES / "kernels_good" / "csrc" / "shaped.cu").read_text())
    assert shaped["rt_shaped"][2][3] == "ptr:long long"


# -- lock family -----------------------------------------------------------

def test_locks_bad_flags_guard_and_cycle():
    fs = run_lint("locks_bad.py", base=FIXTURES)
    assert rules_of(fs) == {"lock-guarded-by", "lock-order-cycle"}
    guards = [f for f in fs if f.rule == "lock-guarded-by"]
    assert sorted(g.symbol for g in guards) == [
        "BadServer.unguarded_mutation", "BadServer.unguarded_mutator_call"]
    cycle = next(f for f in fs if f.rule == "lock-order-cycle")
    assert "_a_lock" in cycle.message and "_b_lock" in cycle.message


def test_locks_good_is_clean():
    assert run_lint("locks_good.py", base=FIXTURES) == []


# -- suppressions ----------------------------------------------------------

def test_suppressions_silence_listed_rules_only():
    fs = run_lint("suppressed.py")
    assert [(f.rule, f.symbol) for f in fs] == [
        ("torch-global-rng", "wrong_rule_listed")]


def test_suppression_comment_only_line_covers_next_line():
    s = Suppressions("# repro-lint: ignore[some-rule]\nx = 1\n")
    assert s.covers(1, "some-rule") and s.covers(2, "some-rule")
    assert not s.covers(2, "other-rule")


# -- baseline --------------------------------------------------------------

def test_baseline_add_and_expire_roundtrip(tmp_path):
    findings = run_lint("purity_bad.py")
    assert findings
    path = tmp_path / "baseline.json"
    save_baseline(path, findings)
    baseline = load_baseline(path)
    assert len(baseline) == len(findings)
    new, stale = apply_baseline(findings, baseline)
    assert new == [] and stale == []
    extra = Finding(rule="torch-global-rng", path="x.py", line=1,
                    message="m", symbol="f", source="t = torch.rand(3)")
    new, stale = apply_baseline(findings[1:] + [extra], baseline)
    assert new == [extra]
    assert [e["fingerprint"] for e in stale] == [
        findings[0].fingerprint()]


def test_baseline_fingerprint_survives_line_churn():
    a = Finding(rule="r", path="p.py", line=10, message="m",
                symbol="f", source="x = 1")
    b = Finding(rule="r", path="p.py", line=99, message="m (moved)",
                symbol="f", source="x = 1")
    assert a.fingerprint() == b.fingerprint()


def test_runner_check_mode_end_to_end(tmp_path, capsys):
    bad = str(TORCH_FIXTURES / "purity_bad.py")
    base = str(tmp_path / "b.json")
    assert lint_main([bad, "--check", "--baseline", base]) == 1
    assert lint_main([bad, "--update-baseline", "--baseline", base]) == 0
    assert lint_main([bad, "--check", "--baseline", base]) == 0
    capsys.readouterr()
    assert lint_main([bad, "--json", "--baseline", base]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == []
    assert payload["baselined"] == payload["total"] > 0
    assert lint_main([bad, "--no-baseline", "--baseline", base]) == 1


# -- the port's own tree ---------------------------------------------------

def test_port_tree_is_clean():
    """The default paths lint clean, and no baseline file is needed."""
    assert DEFAULT_BASELINE == ".repro-torch-lint-baseline.json"
    assert not (REPO / DEFAULT_BASELINE).exists()
    findings = analyze_paths(["src/repro_torch", "chip_smoke.py"],
                             root=REPO)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_module_check_exits_zero_on_the_default_paths():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout


def _raw_findings(paths):
    tree = TreeIndex(_collect_files(paths, REPO))
    return purity.check(tree) + kernel_rules.check(tree) + locks.check(tree)


def test_pre_suppression_findings_sit_at_the_counterpart_sites():
    """Before suppressions, the port's package is flagged exactly where
    the JAX package carries its suppressions (spectral, eigensolver,
    the round boundary), and at the one further site the purity
    docstring justifies (the run's closing metrics)."""
    rounds = PORT / "fed" / "rounds.py"
    want = {
        ("torch-constant-seed", "src/repro_torch/core/spectral.py",
         line_of(PORT / "core" / "spectral.py",
                 "gen = torch.Generator().manual_seed(0)")),
        ("torch-constant-seed", "src/repro_torch/cohort/eigensolver.py",
         line_of(PORT / "cohort" / "eigensolver.py",
                 "generator = torch.Generator().manual_seed(0)")),
        ("torch-blocking-sync", "src/repro_torch/fed/rounds.py",
         line_of(rounds, "acc, loss = float(acc), float(loss)")),
        ("torch-blocking-sync", "src/repro_torch/fed/rounds.py",
         line_of(rounds, "logits.cpu().numpy())")),
    }
    assert sites(_raw_findings(["src/repro_torch"])) == want


def test_transformed_roots_on_the_port_tree():
    tree = TreeIndex(_collect_files(["src/repro_torch"], REPO))
    got = {(rel, line) for rel, mi in tree.modules.items()
           for line, _ in mi.root_sites}
    want = {("src/repro_torch/fed/client.py",
             line_of(PORT / "fed" / "client.py",
                     "step_fn = torch.func.grad_and_value(")),
            ("src/repro_torch/fed/client.py",
             line_of(PORT / "fed" / "client.py",
                     "step_fn = torch.func.vmap(")),
            ("src/repro_torch/core/embedding.py",
             line_of(PORT / "core" / "embedding.py", "torch.func.vmap(")),
            ("src/repro_torch/models/cnn.py",
             line_of(PORT / "models" / "cnn.py", "functional_call(")),
            ("src/repro_torch/models/parallel.py",
             line_of(PORT / "models" / "parallel.py",
                     "class _Broadcast(")),
            ("src/repro_torch/models/parallel.py",
             line_of(PORT / "models" / "parallel.py",
                     "class _Redistribute(")),
            ("src/repro_torch/models/transformer.py",
             line_of(PORT / "models" / "transformer.py",
                     "class _Remat(")),
            ("src/repro_torch/roofline/counting.py",
             line_of(PORT / "roofline" / "counting.py",
                     "class _Replay("))}
    assert got == want
    wrappers = {fi.qualname for fi in tree.kernel_wrappers()}
    assert wrappers == {
        "quantized_cross_affinity", "nystrom_colsum", "nystrom_gram",
        "nystrom_extension", "panel_matmul", "pairwise_sq_dists",
        "rbf_affinity", "rbf_cross_affinity", "flash_attention",
        "ssd_chunk"}


def test_analysis_imports_only_the_standard_library():
    for path in sorted((PORT / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in sys.stdlib_module_names or \
                    name.startswith("repro_torch.analysis") or \
                    top == "__future__", (path.name, name)


def test_the_port_imports_neither_jax_nor_the_reference():
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert examples
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + examples
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path, name)


# -- kernel-abi on a copy of kernels/ --------------------------------------

def _mutate(path, old, new):
    text = path.read_text()
    assert text.count(old) == 1, (path, old)
    path.write_text(text.replace(old, new))


MUTATIONS = {
    # a parameter of rt_panel_matmul dropped in C, not in the table
    "panel_matmul_drops_r": (
        "csrc/nystrom.cu", "int m, int p,\n                    int r, "
        "void* stream) {", "int m, int p,\n                    void* "
        "stream) {", ("_build.py", "rt_panel_matmul")),
    # float gamma turned int in C
    "rbf_affinity_int_gamma": (
        "csrc/affinity.cu", "int rt_rbf_affinity(const float* x, float "
        "gamma,", "int rt_rbf_affinity(const float* x, int gamma,",
        ("_build.py", "rt_rbf_affinity")),
    # a new entry point the table does not list
    "new_entry_point": (
        "csrc/affinity.cu", "}  // extern \"C\"",
        "int rt_new_kernel(const float* x, void* stream) { return 0; }\n\n"
        "}  // extern \"C\"", ("csrc/affinity.cu", "rt_new_kernel")),
    # a wrapper call with one argument too many
    "wrapper_extra_argument": (
        "affinity.py", "err = lib.rt_pairwise_sq_dists(x.data_ptr(), "
        "y.data_ptr(),", "err = lib.rt_pairwise_sq_dists(x.data_ptr(), "
        "y.data_ptr(), 0,", ("affinity.py", "pairwise_sq_dists")),
    # the strides array passed as an untyped pointer
    "strides_as_void_pointer": (
        "_build.py", "_F, _I, _I, _STRIDES, _P],", "_F, _I, _I, _P, _P],",
        ("_build.py", "rt_flash_attention")),
    # an entry of the table dropped
    "ssd_entry_dropped": (
        "_build.py", "\"rt_ssd_chunk\": [_P, _P, _P, _P, _P, _P, _I, _I, "
        "_I, _I, _I, _I,\n                         _I, _I, _P],",
        "\"rt_ssd_other\": [_P],", ("csrc/ssd.cu", "rt_ssd_chunk")),
}


@pytest.fixture
def kernels_copy(tmp_path):
    dest = tmp_path / "kernels"
    shutil.copytree(KERNELS, dest,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def _lint_copy(dest):
    return analyze_paths([str(dest)], root=dest.parent)


def test_kernel_abi_holds_all_ten_entries(kernels_copy):
    assert _lint_copy(kernels_copy) == []
    tree = TreeIndex(_collect_files([str(kernels_copy)], kernels_copy.parent))
    sigs = kernel_rules.Signatures(tree.modules["kernels/_build.py"])
    assert len(sigs.entries) == 10
    for name, (source, _, kinds) in sigs.entries.items():
        _, (_, ret, ckinds) = sigs.prototype(source, name)
        assert ret == "int" and len(ckinds) == len(kinds), name


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_kernel_abi_flags_the_mutation(kernels_copy, case):
    rel, old, new, (where, symbol) = MUTATIONS[case]
    _mutate(kernels_copy / rel, old, new)
    fs = _lint_copy(kernels_copy)
    assert fs, case
    assert rules_of(fs) == {"kernel-abi"}, [f.render() for f in fs]
    assert (f"kernels/{where}", symbol) in {(f.path, f.symbol) for f in fs}


# -- parity with the JAX analyzer ------------------------------------------

def test_findings_model_matches_the_jax_package():
    rng = np.random.default_rng(0)
    for _ in range(50):
        fields = dict(rule=f"r{rng.integers(3)}",
                      path=f"p{rng.integers(3)}.py",
                      line=int(rng.integers(1, 40)), message="m",
                      symbol=f"s{rng.integers(3)}",
                      source=f"x = {rng.integers(3)}")
        a, b = Finding(**fields), jax_findings.Finding(**fields)
        assert a.fingerprint() == b.fingerprint()
        assert a.to_dict() == b.to_dict() and a.render() == b.render()
    source = (FIXTURES / "suppressed.py").read_text() + \
        (TORCH_FIXTURES / "suppressed.py").read_text()
    ours, theirs = Suppressions(source), jax_findings.Suppressions(source)
    for line in range(1, source.count("\n") + 3):
        for rule in ("jax-host-time", "torch-constant-seed",
                     "torch-global-rng", "other"):
            assert ours.covers(line, rule) == theirs.covers(line, rule)
    made = [Finding(rule="r", path="p.py", line=i, message="m",
                    symbol=f"s{i % 3}", source=f"x = {i % 4}")
            for i in range(12)]
    jax_made = [jax_findings.Finding(**{k: getattr(f, k) for k in (
        "rule", "path", "line", "message", "symbol", "source")})
        for f in made]
    baseline = [f.to_dict() for f in made[::3]]
    new, stale = apply_baseline(made[1:], baseline)
    jnew, jstale = jax_findings.apply_baseline(jax_made[1:], baseline)
    assert [f.to_dict() for f in new] == [f.to_dict() for f in jnew]
    assert stale == jstale


@pytest.mark.parametrize("paths", [
    ["tests/analysis_fixtures/locks_bad.py"],
    ["tests/analysis_fixtures/locks_good.py"],
    ["src/repro_torch"]], ids=["locks_bad", "locks_good", "port"])
def test_lock_family_matches_the_jax_checker(paths):
    ours = locks.check(TreeIndex(_collect_files(paths, REPO)))
    theirs = jax_locks.check(JaxTreeIndex(jax_collect_files(paths, REPO)))

    def key(fs):
        return {(f.rule, f.line, f.symbol) for f in fs}

    assert key(ours) == key(theirs)
    assert len(ours) == len(theirs)


@pytest.mark.parametrize("seed", range(4))
def test_ordered_lock_accepts_and_refuses_as_the_jax_one(seed):
    rng = np.random.default_rng(seed)
    ranks = [int(r) for r in rng.choice([5, 10, 20, 20, 30, 40], 6)]
    ours = [OrderedLock(f"l{i}", r) for i, r in enumerate(ranks)]
    theirs = [JaxOrderedLock(f"l{i}", r) for i, r in enumerate(ranks)]
    held = []
    try:
        for _ in range(400):
            i = int(rng.integers(len(ranks)))
            if i in held and rng.random() < 0.7:
                ours[i].release()
                theirs[i].release()
                held.remove(i)
                continue
            outcome = []
            for lk, err in ((ours[i], LockOrderError),
                            (theirs[i], JaxLockOrderError)):
                try:
                    outcome.append(lk.acquire(blocking=False))
                except err:
                    outcome.append("raised")
            assert outcome[0] == outcome[1], (seed, i, held)
            if outcome[0] is True:
                held.append(i)
            assert watchdog.held_names() == [f"l{j}" for j in held]
    finally:
        for i in reversed(held):
            ours[i].release()
            theirs[i].release()
    assert watchdog.held_names() == []


# -- runtime watchdog ------------------------------------------------------

def test_ordered_lock_allows_declared_order():
    a = OrderedLock("a", 10)
    b = OrderedLock("b", 20)
    with a:
        with b:
            assert watchdog.held_names() == ["a", "b"]
    assert watchdog.held_names() == []
    assert (a.acquisitions, b.acquisitions) == (1, 1)


def test_ordered_lock_rejects_inversion_and_reentry():
    a = OrderedLock("a", 10)
    b = OrderedLock("b", 20)
    with b:
        with pytest.raises(LockOrderError):
            a.acquire()
    with a:
        with pytest.raises(LockOrderError):   # equal rank == reentry
            a.acquire()
    assert watchdog.held_names() == []


def test_reentrant_ordered_lock_skips_the_check_for_its_holder():
    r = OrderedLock("r", 48, reentrant=True)
    s = OrderedLock("s", 40)
    with s:
        with r:
            with r:
                assert watchdog.held_names() == ["s", "r", "r"]
            assert watchdog.held_names() == ["s", "r"]
    with r:
        with pytest.raises(LockOrderError):
            s.acquire()
    assert watchdog.held_names() == []


def test_ordered_lock_is_per_thread():
    b = OrderedLock("b", 20)
    a2, b2 = OrderedLock("a2", 10), OrderedLock("b2", 20)
    errors = []

    def other():
        try:
            with a2:
                with b2:
                    pass
        except Exception as e:          # pragma: no cover
            errors.append(e)

    with b:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert errors == []


def test_instrument_swaps_lock_attributes():
    class Obj:
        def __init__(self):
            self._write_lock = threading.Lock()
            self._select_lock = threading.Lock()
            self.not_a_lock = 3

    o = Obj()
    done = instrument(o, prefix="t0:")
    assert sorted(done) == ["_select_lock", "_write_lock"]
    assert isinstance(o._write_lock, OrderedLock)
    assert o._write_lock.rank == SERVING_LOCK_ORDER["_write_lock"]
    assert o.not_a_lock == 3
    with o._select_lock:
        with o._write_lock:
            pass
    with pytest.raises(LockOrderError):
        with o._write_lock:
            with o._select_lock:
                pass


def test_rank_table_extends_the_jax_one():
    from repro.analysis import SERVING_LOCK_ORDER as JAX_ORDER
    assert {k: SERVING_LOCK_ORDER[k] for k in JAX_ORDER} == JAX_ORDER
    kernel = {k: v for k, v in SERVING_LOCK_ORDER.items()
              if k not in JAX_ORDER}
    assert list(kernel) == ["_PallasToggle._lock", "_Library._lock",
                            "_common._COUNT_LOCK", "StepCounter._lock"]
    assert min(kernel.values()) > max(JAX_ORDER.values())


def test_instrument_names_the_port_kernel_locks():
    """The ambiguous ``_lock`` resolves by class; a module's lock by the
    module's name; an RLock becomes a reentrant OrderedLock."""
    from repro_torch.kernels import _build, _common, ops
    from repro_torch.roofline.counting import StepCounter

    toggle, lib = ops._PallasToggle(), _build._Library()
    counter = StepCounter(("cpu",))
    assert instrument(toggle) == ["_lock"]
    assert instrument(lib) == ["_lock"]
    assert instrument(counter) == ["_lock"]
    assert (toggle._lock.rank, lib._lock.rank, counter._lock.rank) == (
        42, 44, 48)
    assert counter._lock.reentrant and not toggle._lock.reentrant

    class Other:
        def __init__(self):
            self._lock = threading.Lock()

    assert instrument(Other()) == []
    saved = _common._COUNT_LOCK
    counts = dict(_common.LAUNCH_COUNTS)
    try:
        assert instrument(_common) == ["_COUNT_LOCK"]
        stats = OrderedLock("stats", SERVING_LOCK_ORDER["_stats_lock"])
        with stats:                     # a launch under the serving locks
            assert toggle.swap(True) is False
            _common.launched("panel_matmul")
            counter.kernel_work("flash_attention", "cpu", 1.0, 2.0)
        assert _common._COUNT_LOCK.acquisitions == 1
        with counter._lock:             # the innermost: nothing inside it
            with pytest.raises(LockOrderError):
                _common.launched("panel_matmul")
    finally:
        _common._COUNT_LOCK = saved
        _common.LAUNCH_COUNTS.update(counts)
    assert watchdog.held_names() == []
