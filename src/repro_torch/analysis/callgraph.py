"""AST index of the tree: functions, imports, call edges, transform roots.

The port's counterpart of the JAX package's ``repro.analysis.callgraph``.
:class:`ModuleIndex`, :class:`TreeIndex`, :class:`FunctionInfo` and
:func:`dotted` are its copies; only the roots change.  Eager PyTorch
traces nothing, so the question the purity rules ask becomes *which
functions run under a function transform*.  A function is a
**transformed root** when it is

* handed to ``torch.func.{vmap, grad, grad_and_value, jacrev, jacfwd,
  vjp, jvp, functional_call}``, ``torch.vmap`` or ``torch.compile``:
  as a decorator (bare, called, or through ``functools.partial``),
  referenced anywhere inside such a call's arguments
  (``vmap(grad_and_value(_step_loss(model)))`` marks ``_step_loss``),
  or as a lambda passed to one (the lambda gets its own synthetic
  :class:`FunctionInfo`);
* the ``forward`` or ``backward`` of a ``torch.autograd.Function``
  subclass.

Call heads are matched after import resolution (:func:`canonical`), so
``from torch.func import vmap`` and ``import torch.func as tf`` count,
and ``re.compile`` does not.  Reachability then follows call edges as in
the JAX index: bare names against the module's functions and
``from``-imports, ``alias.attr`` against import aliases, ``self.method``
/ ``Class.method`` against the class table; unresolvable calls are
skipped (an under-approximation that favours precision).

The index also marks **kernel wrappers**: functions that call an
attribute of ``_build.library()``'s result (``lib = _build.library();
lib.rt_x(...)``, or ``_build.library().rt_x(...)``).  The kernel rules
(:mod:`repro_torch.analysis.kernel_rules`) check each of them.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: canonical heads of the function transforms whose function-valued
#: arguments become transformed roots
TRANSFORMS = frozenset(
    [f"torch.func.{name}" for name in (
        "vmap", "grad", "grad_and_value", "jacrev", "jacfwd", "vjp", "jvp",
        "functional_call")]
    + ["torch.vmap", "torch.compile"])
#: base classes whose ``forward`` / ``backward`` autograd runs as a node
AUTOGRAD_FUNCTIONS = frozenset(["torch.autograd.Function",
                                "torch.autograd.function.Function"])
#: the methods of such a subclass that are roots
AUTOGRAD_METHODS = ("forward", "backward")


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def canonical(mi: "ModuleIndex", head: Optional[str]) -> Optional[str]:
    """``head`` with its first segment replaced by what the module's
    imports bind it to: ``np.random.rand`` -> ``numpy.random.rand``,
    ``vmap`` (``from torch.func import vmap``) -> ``torch.func.vmap``.
    ``import a.b`` binds ``a`` to the package ``a``, so such a head is
    left as it is.  None for None."""
    if head is None:
        return None
    first, _, rest = head.partition(".")
    tail = f".{rest}" if rest else ""
    if first in mi.import_modules:
        mod = mi.import_modules[first]
        if mod.split(".")[0] == first:
            return head
        return mod + tail
    if first in mi.import_names:
        modpath, orig = mi.import_names[first]
        return f"{modpath}.{orig}{tail}"
    return head


def _is_library_call(mi: "ModuleIndex", node: ast.AST) -> bool:
    """``_build.library()`` (or ``library()`` imported from ``_build``)."""
    if not isinstance(node, ast.Call):
        return False
    head = canonical(mi, dotted(node.func))
    return bool(head) and head.split(".")[-2:] == ["_build", "library"]


@dataclasses.dataclass(eq=False)      # identity hash: usable in sets
class FunctionInfo:
    qualname: str                       # "fn", "Cls.fn", "<transform-lambda-1>"
    node: ast.AST                       # FunctionDef / Lambda
    module: "ModuleIndex"
    cls: Optional[str] = None           # enclosing class name
    is_root: bool = False
    calls: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    call_nodes: List[ast.Call] = dataclasses.field(default_factory=list)
    #: the ``lib.rt_*`` calls of a kernel wrapper (empty: not a wrapper)
    kernel_calls: List[ast.Call] = dataclasses.field(default_factory=list)

    @property
    def is_kernel_wrapper(self) -> bool:
        return bool(self.kernel_calls)

    def collect_calls(self) -> None:
        self.call_nodes = [n for n in ast.walk(self.node)
                           if isinstance(n, ast.Call)]
        self.calls = [(head, n.lineno) for n in self.call_nodes
                      if (head := dotted(n.func)) is not None]

    def collect_kernel_calls(self) -> None:
        libs = {t.id for n in ast.walk(self.node)
                if isinstance(n, ast.Assign)
                and _is_library_call(self.module, n.value)
                for t in n.targets if isinstance(t, ast.Name)}
        self.kernel_calls = []
        for n in self.call_nodes:
            if not (isinstance(n.func, ast.Attribute)
                    and n.func.attr.startswith("rt_")):
                continue
            base = n.func.value
            if (isinstance(base, ast.Name) and base.id in libs) \
                    or _is_library_call(self.module, base):
                self.kernel_calls.append(n)
        self.kernel_calls.sort(key=lambda c: (c.lineno, c.col_offset))


class ModuleIndex:
    """One parsed file: functions, classes, imports, transformed names."""

    def __init__(self, path: pathlib.Path, rel: str, source: str):
        self.path = path
        self.rel = rel                          # repo-relative, "/" seps
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        #: local alias -> imported module dotted path ("T" -> "x.y.z")
        self.import_modules: Dict[str, str] = {}
        #: local name -> (module dotted path, original name)
        self.import_names: Dict[str, Tuple[str, str]] = {}
        #: names bound to a transform's result (``step_fn = vmap(f)``)
        self.transformed_names: Set[str] = set()
        #: (line, head) of every transform call and autograd.Function
        #: class in the module: where the roots come from
        self.root_sites: List[Tuple[int, str]] = []
        self._index()

    # -- construction -----------------------------------------------------
    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._index_import(node)
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(node, cls=None)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                autograd = any(canonical(self, dotted(b)) in
                               AUTOGRAD_FUNCTIONS for b in node.bases)
                if autograd:
                    self.root_sites.append((node.lineno, node.name))
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        info = self._add_function(item, cls=node.name)
                        if autograd and item.name in AUTOGRAD_METHODS:
                            info.is_root = True
        self._index_roots()

    def _index_import(self, node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                self.import_modules[alias.asname
                                    or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                local = alias.asname or alias.name
                self.import_names[local] = (node.module, alias.name)

    def _add_function(self, node, cls: Optional[str]) -> FunctionInfo:
        qual = f"{cls}.{node.name}" if cls else node.name
        info = FunctionInfo(qual, node, self, cls=cls)
        info.collect_calls()
        if any(isinstance(n.func, ast.Attribute)
               and n.func.attr.startswith("rt_") for n in info.call_nodes):
            info.collect_kernel_calls()
        if any(self._transform_decorator(d) for d in node.decorator_list):
            info.is_root = True
        self.functions[qual] = info
        return info

    def is_transform(self, node: ast.AST) -> bool:
        """Whether ``node`` names a transform (``torch.func.vmap``...)."""
        return canonical(self, dotted(node)) in TRANSFORMS

    def is_transform_call(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and self.is_transform(node.func)

    def _transform_decorator(self, dec: ast.AST) -> bool:
        if self.is_transform(dec):
            return True
        if isinstance(dec, ast.Call):
            # torch.compile(mode=...) used as a decorator factory
            if self.is_transform(dec.func):
                return True
            # functools.partial(torch.vmap, in_dims=...)
            h = dotted(dec.func)
            if h and h.split(".")[-1] == "partial" and dec.args:
                return self.is_transform(dec.args[0])
        return False

    def _index_roots(self) -> None:
        """Mark functions referenced inside a transform call, and the
        names bound to a transform's result (``step_fn = vmap(f)``,
        ``self.f = torch.compile(g)``)."""
        lam_count = 0
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) \
                    and self.is_transform_call(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.transformed_names.add(tgt.id)
                    elif isinstance(tgt, ast.Attribute):
                        self.transformed_names.add(tgt.attr)
            if not self.is_transform_call(node):
                continue
            self.root_sites.append((node.lineno,
                                    canonical(self, dotted(node.func))))
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Lambda):
                        lam_count += 1
                        qual = f"<transform-lambda-{lam_count}>"
                        info = FunctionInfo(qual, sub, self, is_root=True)
                        info.collect_calls()
                        self.functions[qual] = info
                    else:
                        name = None
                        if isinstance(sub, ast.Name):
                            name = sub.id
                        elif isinstance(sub, ast.Attribute):
                            name = sub.attr
                        if name is None:
                            continue
                        for qual, fi in self.functions.items():
                            if qual == name or qual.endswith(f".{name}"):
                                fi.is_root = True
        self.root_sites.sort()


class TreeIndex:
    """All modules of one analysis run plus cross-module resolution."""

    def __init__(self, files: Iterable[Tuple[pathlib.Path, str]]):
        self.modules: Dict[str, ModuleIndex] = {}
        #: dotted module path guess -> ModuleIndex (for import resolution)
        self._by_dotted: Dict[str, ModuleIndex] = {}
        for path, rel in files:
            mi = ModuleIndex(path, rel, path.read_text())
            self.modules[rel] = mi
            self._by_dotted[self._dotted_of(rel)] = mi

    @staticmethod
    def _dotted_of(rel: str) -> str:
        parts = pathlib.PurePosixPath(rel).with_suffix("").parts
        # strip a leading src/ layout segment if present
        if parts and parts[0] == "src":
            parts = parts[1:]
        return ".".join(parts)

    def sources(self) -> Dict[str, str]:
        return {rel: mi.source for rel, mi in self.modules.items()}

    # -- resolution -------------------------------------------------------
    def resolve(self, mi: ModuleIndex, caller: FunctionInfo,
                head: str) -> Optional[FunctionInfo]:
        """Best-effort: call head string -> FunctionInfo in the tree."""
        parts = head.split(".")
        if len(parts) == 1:
            name = parts[0]
            if name in mi.functions:
                return mi.functions[name]
            if name in mi.import_names:
                modpath, orig = mi.import_names[name]
                target = self._module_for(modpath)
                if target and orig in target.functions:
                    return target.functions[orig]
            return None
        base, rest = parts[0], parts[1:]
        if base in ("self", "cls") and caller.cls and len(rest) == 1:
            return mi.functions.get(f"{caller.cls}.{rest[0]}")
        if base in mi.import_modules and len(rest) == 1:
            target = self._module_for(mi.import_modules[base])
            if target:
                return target.functions.get(rest[0])
        if base in mi.import_names and len(rest) == 1:
            modpath, orig = mi.import_names[base]
            # `from repro_torch.models import transformer as T` -> T.f
            target = self._module_for(f"{modpath}.{orig}")
            if target:
                return target.functions.get(rest[0])
            # `from x import Cls` -> Cls.method
            target = self._module_for(modpath)
            if target and orig in target.classes:
                return target.functions.get(f"{orig}.{rest[0]}")
        if base in mi.classes and len(rest) == 1:
            return mi.functions.get(f"{base}.{rest[0]}")
        return None

    def _module_for(self, modpath: str) -> Optional[ModuleIndex]:
        return self._by_dotted.get(modpath)

    def sibling(self, mi: ModuleIndex, name: str) -> Optional[ModuleIndex]:
        """The indexed module ``name`` (``"ref.py"``) beside ``mi``."""
        rel = str(pathlib.PurePosixPath(mi.rel).parent / name)
        return self.modules.get(rel)

    def is_transformed_call(self, mi: ModuleIndex, head: str) -> bool:
        """True if `head` names a value produced by a transform."""
        return head.split(".")[-1] in mi.transformed_names

    # -- reachability -----------------------------------------------------
    def transformed_functions(self) -> Set[FunctionInfo]:
        """Every function reachable from a transformed root (roots
        included)."""
        work = [fi for mi in self.modules.values()
                for fi in mi.functions.values() if fi.is_root]
        seen: Set[int] = set()
        out: Set[FunctionInfo] = set()
        while work:
            fi = work.pop()
            if id(fi) in seen:
                continue
            seen.add(id(fi))
            out.add(fi)
            for head, _ in fi.calls:
                callee = self.resolve(fi.module, fi, head)
                if callee is not None and id(callee) not in seen:
                    work.append(callee)
        return out

    def kernel_wrappers(self) -> List[FunctionInfo]:
        return [fi for _, mi in sorted(self.modules.items())
                for _, fi in sorted(mi.functions.items())
                if fi.is_kernel_wrapper]
