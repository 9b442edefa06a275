"""Rule family 3: lock discipline for the threaded serving stack.

A copy of the JAX package's ``repro.analysis.locks``, rule for rule: it
reads no framework call, so nothing in it changes for PyTorch.  Its
findings on any input are the JAX checker's (``tests/
test_torch_analysis.py`` holds the two to the same ``(rule, line,
symbol)`` set).  It keeps the JAX checker's known limit: the cross-method
graph joins methods by call *name*, so under a lock, a call whose last
name segment matches another class's locking method adds that method's
locks as an edge, and two unrelated classes can make a false cycle
(keep such calls out of locked regions; ``roofline/counting.py``'s
``StepCounter`` works its counts out before it takes its lock).

Two rules over any analyzed file that uses ``threading`` locks (in this
tree: ``launch/serve.py``, ``launch/frontend.py``, ``streaming/``,
``kernels/`` and ``roofline/counting.py``):

* ``lock-guarded-by`` — an attribute whose declaration carries a
  ``# guarded-by: <lock>`` comment may only be **mutated** inside a
  ``with <obj>.<lock>:`` block on the *same* object.  Mutation means
  attribute assignment, augmented assignment, subscript stores, or
  calls to known mutating container methods (``append``/``update``/
  ``pop``/...).  ``__init__`` is exempt (single-threaded
  construction); *reads* are deliberately out of scope — several fields
  here are read lock-free by design (immutable snapshot swaps).

* ``lock-order-cycle`` — a static lock-acquisition graph is built
  across methods: an edge A -> B is recorded when a ``with`` on B nests
  (lexically, or through a resolvable method call) inside a ``with`` on
  A.  A cycle means two threads can acquire the locks in opposite
  orders — a potential deadlock.  Lock identity is ``Class.attr``
  (locks are discovered from ``self.X = threading.Lock()``-shaped
  assignments).

The static order is the ground truth the runtime watchdog
(:mod:`repro_torch.analysis.watchdog`) asserts in threaded tests and in
``chip_smoke.py``'s phase 17.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.callgraph import ModuleIndex, TreeIndex, dotted
from repro_torch.analysis.findings import Finding

_GUARDED_BY = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")
_MUTATORS = {"append", "update", "pop", "clear", "extend", "add",
             "remove", "discard", "insert", "setdefault", "popitem",
             "appendleft", "popleft"}


def _src_line(mi: ModuleIndex, line: int) -> str:
    lines = mi.source.splitlines()
    return lines[line - 1].strip() if 0 < line <= len(lines) else ""


def _is_lock_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    head = dotted(value.func)
    return bool(head) and head.split(".")[-1] in (
        "Lock", "RLock", "OrderedLock")


@dataclasses.dataclass
class ClassLocks:
    """Lock attrs + guarded-by annotations declared by one class."""
    module: ModuleIndex
    cls: str
    locks: Set[str] = dataclasses.field(default_factory=set)
    guarded: Dict[str, str] = dataclasses.field(default_factory=dict)


def _scan_class(mi: ModuleIndex, cls: ast.ClassDef) -> ClassLocks:
    info = ClassLocks(mi, cls.name)
    lines = mi.source.splitlines()
    for node in ast.walk(cls):
        targets: List[ast.AST] = []
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.target is not None:
            targets, value = [node.target], node.value
        for tgt in targets:
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            if value is not None and _is_lock_ctor(value):
                info.locks.add(tgt.attr)
            text = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
            m = _GUARDED_BY.search(text)
            if m:
                info.guarded[tgt.attr] = m.group(1)
    return info


@dataclasses.dataclass
class _MethodSummary:
    """Per-method lock behavior, for the cross-method graph."""
    qualname: str                                # "module.rel:Cls.m"
    acquires: Set[str] = dataclasses.field(default_factory=set)
    # (held locks at call site, callee method name, line)
    calls: List[Tuple[Tuple[str, ...], str, int]] = \
        dataclasses.field(default_factory=list)


class _LockVisitor(ast.NodeVisitor):
    """Walks one method tracking the stack of held ``with`` locks."""

    def __init__(self, checker: "LockChecker", mi: ModuleIndex,
                 cls: str, method: str):
        self.checker = checker
        self.mi = mi
        self.cls = cls
        self.method = method
        self.summary = _MethodSummary(f"{mi.rel}:{cls}.{method}")
        # parallel stacks: lock node ids / raw "base.attr" strings
        self.held_ids: List[str] = []
        self.held_raw: List[str] = []

    # -- with blocks ------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        entered = 0
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Attribute) \
                    and isinstance(expr.value, (ast.Name, ast.Attribute)):
                lock_id = self.checker.lock_node_id(
                    self.mi, self.cls, expr)
                if lock_id is not None:
                    raw = ast.unparse(expr)
                    for held in self.held_ids:
                        self.checker.add_edge(held, lock_id,
                                              self.mi.rel, expr.lineno)
                    self.summary.acquires.add(lock_id)
                    self.held_ids.append(lock_id)
                    self.held_raw.append(raw)
                    entered += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(entered):
            self.held_ids.pop()
            self.held_raw.pop()

    # -- mutations --------------------------------------------------------
    def _check_mutation(self, target: ast.AST, line: int) -> None:
        attr_node: Optional[ast.Attribute] = None
        if isinstance(target, ast.Attribute):
            attr_node = target
        elif isinstance(target, ast.Subscript) \
                and isinstance(target.value, ast.Attribute):
            attr_node = target.value
        if attr_node is None or not isinstance(
                attr_node.value, (ast.Name, ast.Attribute)):
            return
        lock = self.checker.guard_for(self.mi, self.cls, attr_node)
        if lock is None or self.method == "__init__":
            return
        base = ast.unparse(attr_node.value)
        want = f"{base}.{lock}"
        if want not in self.held_raw:
            self.checker.findings.append(Finding(
                rule="lock-guarded-by", path=self.mi.rel, line=line,
                symbol=f"{self.cls}.{self.method}",
                source=_src_line(self.mi, line),
                message=(f"'{base}.{attr_node.attr}' is annotated "
                         f"guarded-by: {lock} but is mutated outside "
                         f"'with {want}:'")))

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            # top-level target shapes only (incl. tuple unpacking); a
            # blind ast.walk would visit both a Subscript and its inner
            # Attribute and report the same mutation twice
            elts = (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                    else [tgt])
            for t in elts:
                self._check_mutation(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_mutation(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_mutation(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # container mutators: self._counters.update(...), pools[c].pop()
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS \
                and isinstance(node.func.value, ast.Attribute):
            self._check_mutation(node.func.value, node.lineno)
        head = dotted(node.func)
        if head:
            self.summary.calls.append(
                (tuple(self.held_ids), head.split(".")[-1], node.lineno))
        self.generic_visit(node)

    # methods' nested defs run in the same thread context; keep walking
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef


class LockChecker:
    def __init__(self, tree: TreeIndex):
        self.tree = tree
        self.findings: List[Finding] = []
        #: (module rel, class) -> ClassLocks
        self.class_locks: Dict[Tuple[str, str], ClassLocks] = {}
        #: lock attr name -> {class names defining it}
        self.lock_owners: Dict[str, Set[str]] = {}
        #: guarded attr name -> (lock, class) for cross-object checks
        self.guard_by_attr: Dict[str, Tuple[str, str]] = {}
        #: edges: (A, B) -> (path, line) first site
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.summaries: Dict[str, List[_MethodSummary]] = {}

        for rel, mi in tree.modules.items():
            for cls in mi.classes.values():
                info = _scan_class(mi, cls)
                if info.locks or info.guarded:
                    self.class_locks[(rel, cls.name)] = info
                    for lock in info.locks:
                        self.lock_owners.setdefault(lock, set()).add(
                            cls.name)
                    for attr, lock in info.guarded.items():
                        self.guard_by_attr.setdefault(
                            attr, (lock, cls.name))

    # -- resolution helpers ----------------------------------------------
    def lock_node_id(self, mi: ModuleIndex, cls: str,
                     expr: ast.Attribute) -> Optional[str]:
        """'self._select_lock' / 't.lock' -> 'Class.lockattr' or None."""
        attr = expr.attr
        if attr not in self.lock_owners:
            return None
        if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and cls in self.lock_owners[attr]:
            return f"{cls}.{attr}"
        owners = self.lock_owners[attr]
        if len(owners) == 1:
            return f"{next(iter(owners))}.{attr}"
        return None

    def guard_for(self, mi: ModuleIndex, cls: str,
                  attr_node: ast.Attribute) -> Optional[str]:
        attr = attr_node.attr
        is_self = (isinstance(attr_node.value, ast.Name)
                   and attr_node.value.id == "self")
        if is_self:
            info = self.class_locks.get((mi.rel, cls))
            return info.guarded.get(attr) if info else None
        got = self.guard_by_attr.get(attr)
        return got[0] if got else None

    def add_edge(self, a: str, b: str, path: str, line: int) -> None:
        if a != b:
            self.edges.setdefault((a, b), (path, line))

    # -- cross-method propagation -----------------------------------------
    def _transitive_acquires(self) -> Dict[str, Set[str]]:
        """Method name -> locks acquired directly or via known calls."""
        by_name: Dict[str, List[_MethodSummary]] = {}
        for summaries in self.summaries.values():
            for s in summaries:
                by_name.setdefault(s.qualname.split(".")[-1],
                                   []).append(s)
        acq = {name: set().union(*(s.acquires for s in ss))
               for name, ss in by_name.items()}
        changed = True
        while changed:
            changed = False
            for name, ss in by_name.items():
                for s in ss:
                    for _, callee, _ in s.calls:
                        extra = acq.get(callee, set()) - acq[name]
                        if extra:
                            acq[name] |= extra
                            changed = True
        return acq

    def propagate_call_edges(self) -> None:
        acq = self._transitive_acquires()
        for rel, summaries in self.summaries.items():
            for s in summaries:
                for held, callee, line in s.calls:
                    if not held or callee not in acq:
                        continue
                    for b in acq[callee]:
                        for a in held:
                            self.add_edge(a, b, rel, line)

    # -- cycle detection --------------------------------------------------
    def find_cycles(self) -> List[List[str]]:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        cycles: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()

        def dfs(node: str, path: List[str], on_path: Set[str],
                done: Set[str]) -> None:
            on_path.add(node)
            path.append(node)
            for nxt in graph.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = tuple(sorted(set(cyc)))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(cyc)
                elif nxt not in done:
                    dfs(nxt, path, on_path, done)
            on_path.discard(node)
            path.pop()
            done.add(node)

        done: Set[str] = set()
        for node in sorted(graph):
            if node not in done:
                dfs(node, [], set(), done)
        return cycles

    # -- entry point ------------------------------------------------------
    def run(self) -> List[Finding]:
        for rel, mi in sorted(self.tree.modules.items()):
            summaries: List[_MethodSummary] = []
            for qual, fi in sorted(mi.functions.items()):
                if not isinstance(fi.node, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                    continue
                cls = fi.cls or ""
                visitor = _LockVisitor(self, mi, cls,
                                       fi.node.name)
                for stmt in fi.node.body:
                    visitor.visit(stmt)
                summaries.append(visitor.summary)
            self.summaries[rel] = summaries
        self.propagate_call_edges()
        for cyc in self.find_cycles():
            first_edge = (cyc[0], cyc[1]) if len(cyc) > 1 else None
            path, line = self.edges.get(first_edge, ("", 1))
            self.findings.append(Finding(
                rule="lock-order-cycle", path=path or "<graph>",
                line=line, symbol="",
                source="",
                message=("lock-acquisition cycle "
                         + " -> ".join(cyc)
                         + " — threads taking these locks in opposite "
                           "orders can deadlock")))
        return self.findings


def check(tree: TreeIndex) -> List[Finding]:
    return LockChecker(tree).run()
