"""Rule family 1: host syncs under transforms, RNG discipline, blocking reads.

The port's counterpart of the JAX package's ``repro.analysis.purity``,
mapped onto eager PyTorch.  Eager code runs every line on every call, so
what JAX loses at trace time PyTorch loses under a function transform
(``torch.func``, ``torch.vmap``, ``torch.compile``, an
``autograd.Function``: see :mod:`repro_torch.analysis.callgraph`), and
the RNG rules guard the port's own rule that every draw comes from an
explicit generator.

* ``torch-host-sync`` (``jax-host-sync``) — ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` of a
  value, or ``np.asarray()``, in a transformed function or anything it
  reaches.  Under ``vmap`` ``.item()`` raises; under ``grad`` a host
  read cuts the graph.  A literal, and a size read (an argument that
  reads ``.shape``, ``.size()``, ``.dim()``, ``.ndim``, ``.numel()``,
  ``.stride()``, ``.element_size()``, ``.itemsize`` or ``len()``), is
  not a tensor and stays silent.
* ``torch-global-rng`` (``jax-host-random``) — fires anywhere in the
  tree, module level included, not only in transformed code: a sampler
  of torch's global generator without ``generator=``
  (``torch.{rand, randn, randint, randperm, normal, bernoulli,
  multinomial, poisson}`` and the ``*_like`` forms;
  ``Tensor.{uniform_, normal_, random_, bernoulli_, exponential_,
  geometric_, cauchy_, log_normal_}``; ``torch.nn.init.*_`` but the
  deterministic fills), a reseed of it (``torch.manual_seed``,
  ``torch.seed``, ``torch.cuda.manual_seed[_all]``, ``torch.cuda.seed
  [_all]``, ``torch.random.*``), ``np.random.<fn>`` but ``default_rng``,
  ``Generator``, ``SeedSequence`` and the bit generators, and the
  stdlib ``random`` module's functions (a ``random.Random(seed)``
  instance is an explicit generator).
* ``torch-constant-seed`` (``prng-constant-key``) —
  ``<generator>.manual_seed(<literal>)`` or
  ``np.random.default_rng(<literal>)`` inside a function body: every
  call replays one stream.  Seeds enter as parameters.
* ``torch-seed-reuse`` (``prng-key-reuse``) — one seed expression (the
  same source text) seeds two generators of one family (torch's
  ``manual_seed``; numpy's ``default_rng`` / ``SeedSequence``) in one
  function, and no name in it is rebound between: the two streams are
  one.  A torch and a numpy generator seeded alike draw different
  streams and stay silent.

One rule reaches outside transformed code, as in the JAX package:

* ``torch-blocking-sync`` (``jax-blocking-sync``) — a host read, as
  listed under ``torch-host-sync``, of a name just bound to what a call
  into the port's **device code** returned.  Device code is a function
  within ``DEVICE_REACH`` (2) resolved calls of device work: a
  transformed root, a kernel wrapper, a function that calls a transform
  or a transformed name, or anything the call graph reaches from a
  transformed root.  Two calls is how far ``fed/client.py::evaluate``
  sits from its ``functional_call`` (``evaluate`` -> ``cnn_loss`` ->
  ``cnn_apply``); one more reaches drivers such as a round or an engine
  solve, whose results are host values already.  A ``float()`` of a
  plain helper's result stays silent.

``jax-host-time`` has no counterpart: a clock in eager code reads on
every call, so it cannot freeze.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.callgraph import (FunctionInfo, ModuleIndex,
                                            TreeIndex, canonical, dotted)
from repro_torch.analysis.findings import Finding

#: how many resolved calls from device work still count as device code
DEVICE_REACH = 2

#: torch's samplers of the global generator (they take ``generator=``)
TORCH_SAMPLERS = frozenset(f"torch.{name}" for name in (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like"))
#: in-place Tensor samplers (they take ``generator=``)
TENSOR_SAMPLERS = frozenset([
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_"])
#: reseeds of a global generator
GLOBAL_RESEEDS = frozenset([
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all"])
#: ``torch.nn.init`` functions that draw nothing
INIT_FILLS = frozenset(["zeros_", "ones_", "constant_", "eye_", "dirac_"])
#: ``np.random`` names that make an explicit generator
NUMPY_EXPLICIT = frozenset([
    "default_rng", "Generator", "SeedSequence", "BitGenerator", "PCG64",
    "PCG64DXSM", "MT19937", "Philox", "SFC64"])
#: host reads of a tensor: methods, and builtins of one argument
READ_METHODS = frozenset(["item", "tolist", "cpu", "numpy"])
READ_BUILTINS = frozenset(["float", "int", "bool"])
#: attribute and call names that read a size, not a value
_SIZE_READS = frozenset(["shape", "size", "dim", "ndim", "numel", "stride",
                         "element_size", "itemsize", "len"])


def _finding(mi: ModuleIndex, rule: str, line: int, msg: str,
             symbol: str) -> Finding:
    src_lines = mi.source.splitlines()
    text = src_lines[line - 1].strip() if 0 < line <= len(src_lines) else ""
    return Finding(rule=rule, path=mi.rel, line=line, message=msg,
                   symbol=symbol, source=text)


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) \
        and isinstance(node.value, (int, float)) \
        and not isinstance(node.value, bool)


def _reads_size(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _SIZE_READS:
            return True
        if isinstance(sub, ast.Name) and sub.id == "len":
            return True
    return False


def _numpy_call(mi: ModuleIndex, call: ast.Call, name: str) -> bool:
    head = canonical(mi, dotted(call.func))
    return head == f"numpy.{name}"


def host_read(mi: ModuleIndex, call: ast.Call) -> Optional[ast.AST]:
    """The value a call reads to the host, or None: the receiver of
    ``x.item()`` and friends, the argument of ``float(x)`` / ``int(x)`` /
    ``bool(x)`` / ``np.asarray(x)``."""
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in READ_METHODS and not call.args:
        return call.func.value
    head = dotted(call.func)
    if head in READ_BUILTINS or _numpy_call(mi, call, "asarray"):
        if len(call.args) == 1:
            return call.args[0]
    return None


def _seed_arg(mi: ModuleIndex, call: ast.Call):
    """(family, seed) of a generator being seeded by ``call``, or None:
    ``<gen>.manual_seed(s)`` (not a global reseed) is torch's,
    ``np.random.default_rng(s)`` and ``np.random.SeedSequence(s)``
    numpy's.  Two families seeded alike draw different streams."""
    if not call.args:
        return None
    head = canonical(mi, dotted(call.func))
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr == "manual_seed" \
            and head not in GLOBAL_RESEEDS:
        return "torch", call.args[0]
    if head in ("numpy.random.default_rng", "numpy.random.SeedSequence"):
        return "numpy", call.args[0]
    return None


def _stdlib_random(mi: ModuleIndex, head: Optional[str]) -> bool:
    if not head:
        return False
    first = head.split(".")[0]
    if mi.import_modules.get(first) == "random":
        return True
    return first in mi.import_names and mi.import_names[first][0] == "random"


def _global_rng(mi: ModuleIndex, call: ast.Call) -> Optional[str]:
    """Why ``call`` draws from (or reseeds) a global generator, or None."""
    raw = dotted(call.func)
    head = canonical(mi, raw)
    if head in GLOBAL_RESEEDS:
        return f"'{raw}()' reseeds a global generator"
    if head in TORCH_SAMPLERS and not _has_generator(call):
        return f"'{raw}()' without generator= draws from torch's global " \
               f"generator"
    if head and head.startswith("torch.nn.init."):
        last = head.split(".")[-1]
        if last.endswith("_") and last not in INIT_FILLS \
                and not _has_generator(call):
            return f"'{raw}()' without generator= draws from torch's " \
                   f"global generator"
        return None
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in TENSOR_SAMPLERS \
            and not _has_generator(call):
        return f"'.{call.func.attr}()' without generator= draws from " \
               f"torch's global generator"
    if head and head.startswith("numpy.random.") and head.count(".") == 2 \
            and head.split(".")[-1] not in NUMPY_EXPLICIT:
        return f"'{raw}()' draws from numpy's global generator"
    if _stdlib_random(mi, raw) and head != "random.Random" \
            and head.count(".") == 1:
        return f"stdlib '{raw}()' draws from the global random state"
    return None


class _ModuleRng(ast.NodeVisitor):
    """``torch-global-rng`` over a whole module, with each finding's
    enclosing function or class as its symbol."""

    def __init__(self, mi: ModuleIndex):
        self.mi = mi
        self.stack: List[str] = []
        self.findings: List[Finding] = []

    def _scoped(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _scoped

    def visit_Call(self, node: ast.Call) -> None:
        why = _global_rng(self.mi, node)
        if why:
            self.findings.append(_finding(
                self.mi, "torch-global-rng", node.lineno,
                f"{why}; draw from an explicit torch.Generator "
                f"(generator=) or numpy Generator",
                ".".join(self.stack)))
        self.generic_visit(node)


def _calls_in_order(node: ast.AST) -> List[ast.Call]:
    calls = [n for n in ast.walk(node) if isinstance(n, ast.Call)]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return calls


def _own_nodes(fn: ast.AST):
    """The nodes of ``fn`` outside its nested functions and lambdas."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


def _rebound_names(fn: ast.AST) -> List[tuple]:
    """(line, name) of every binding in ``fn``'s own body."""
    out = []
    for node in _own_nodes(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For)):
            targets = [node.target]
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name):
                    out.append((node.lineno, sub.id))
    return out


def _check_seeds(fi: FunctionInfo) -> List[Finding]:
    """``torch-constant-seed`` and ``torch-seed-reuse`` in one function
    body (nested functions are checked as their own bodies)."""
    mi = fi.module
    findings: List[Finding] = []
    rebinds = _rebound_names(fi.node)
    seen: Dict[tuple, int] = {}        # (family, seed source) -> line
    calls = sorted((n for n in _own_nodes(fi.node)
                    if isinstance(n, ast.Call)),
                   key=lambda n: (n.lineno, n.col_offset))
    for call in calls:
        got = _seed_arg(mi, call)
        if got is None:
            continue
        family, seed = got
        if _is_literal(seed):
            findings.append(_finding(
                mi, "torch-constant-seed", call.lineno,
                f"generator seeded with the literal {ast.unparse(seed)} "
                f"inside a function — every call replays one stream; "
                f"pass the seed (or a generator) in", fi.qualname))
        text = ast.unparse(seed)
        names = {n.id for n in ast.walk(seed) if isinstance(n, ast.Name)}
        first = seen.get((family, text))
        if first is not None and not any(
                first < line <= call.lineno and name in names
                for line, name in rebinds):
            findings.append(_finding(
                mi, "torch-seed-reuse", call.lineno,
                f"seed '{text}' already seeded a generator at line "
                f"{first} — identical streams; derive a fresh seed "
                f"(SeedSequence, an offset) between uses", fi.qualname))
        seen[(family, text)] = call.lineno
    return findings


def _nested_functions(fi: FunctionInfo):
    """``fi`` and every function defined inside it."""
    yield fi.qualname, fi.node
    for node in ast.walk(fi.node):
        if node is not fi.node and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield f"{fi.qualname}.{node.name}", node


def _check_transformed(fi: FunctionInfo) -> List[Finding]:
    mi = fi.module
    findings: List[Finding] = []
    for call in _calls_in_order(fi.node):
        value = host_read(mi, call)
        if value is None or _is_literal(value) or _reads_size(value):
            continue
        what = (f"'.{call.func.attr}()'"
                if isinstance(call.func, ast.Attribute)
                and call.func.attr in READ_METHODS
                else f"'{dotted(call.func)}(...)'")
        findings.append(_finding(
            mi, "torch-host-sync", call.lineno,
            f"{what} in a transformed function reads a tensor to the "
            f"host — it raises under vmap and cuts the graph under "
            f"grad; keep the value a tensor", fi.qualname))
    return findings


def device_code(tree: TreeIndex) -> Set[int]:
    """ids of the functions within ``DEVICE_REACH`` calls of device work
    (see the module docstring)."""
    funcs = [fi for mi in tree.modules.values()
             for fi in mi.functions.values()]
    transformed = {id(fi) for fi in tree.transformed_functions()}
    depth: Dict[int, int] = {}
    for fi in funcs:
        mi = fi.module
        if id(fi) in transformed or fi.is_kernel_wrapper or any(
                mi.is_transform(n.func)
                or tree.is_transformed_call(mi, head)
                for n in fi.call_nodes if (head := dotted(n.func))):
            depth[id(fi)] = 0
    callees = {id(fi): [c for head, _ in fi.calls
                        if (c := tree.resolve(fi.module, fi, head))
                        is not None]
               for fi in funcs}
    for level in range(1, DEVICE_REACH + 1):
        for fi in funcs:
            if id(fi) not in depth and any(
                    depth.get(id(c)) == level - 1 for c in callees[id(fi)]):
                depth[id(fi)] = level
    return set(depth)


def _check_blocking_sync(fi: FunctionInfo, tree: TreeIndex,
                         device: Set[int]) -> List[Finding]:
    """Host reads of names bound to a device-code call's result, in one
    function body.  A call on the right of an assignment runs before
    the binding, so ``acc = float(acc)`` reads the old binding."""
    mi = fi.module
    findings: List[Finding] = []
    bound: Dict[str, int] = {}           # name -> line of the device call

    def from_device(value: ast.AST) -> bool:
        if not isinstance(value, ast.Call):
            return False
        head = dotted(value.func)
        if not head:
            return False
        callee = tree.resolve(mi, fi, head)
        return (callee is not None and id(callee) in device) \
            or tree.is_transformed_call(mi, head)

    events = []
    for node in _own_nodes(fi.node):
        if isinstance(node, ast.Assign):
            end = (node.value.end_lineno, node.value.end_col_offset)
            events.append((end, 1, node))
        elif isinstance(node, ast.Call):
            events.append(((node.lineno, node.col_offset), 0, node))
    events.sort(key=lambda e: (e[0], e[1]))
    for _, _, node in events:
        if isinstance(node, ast.Call):
            value = host_read(mi, node)
            if isinstance(value, ast.Name) and value.id in bound:
                findings.append(_finding(
                    mi, "torch-blocking-sync", node.lineno,
                    f"host read of '{value.id}' blocks on the device "
                    f"call at line {bound[value.id]}; defer the sync "
                    f"(keep the tensor, materialize when observed)",
                    fi.qualname))
            continue
        device_value = from_device(node.value)
        for tgt in node.targets:
            names = ([tgt] if isinstance(tgt, ast.Name)
                     else [e for e in getattr(tgt, "elts", [])
                           if isinstance(e, ast.Name)])
            for n in names:
                if device_value:
                    bound[n.id] = node.lineno
                else:
                    bound.pop(n.id, None)
    return findings


def check(tree: TreeIndex) -> List[Finding]:
    findings: List[Finding] = []
    transformed = tree.transformed_functions()
    for fi in sorted(transformed, key=lambda f: (f.module.rel, f.qualname)):
        findings.extend(_check_transformed(fi))
    device = device_code(tree)
    for rel, mi in sorted(tree.modules.items()):
        rng = _ModuleRng(mi)
        rng.visit(mi.tree)
        findings.extend(rng.findings)
        for qual, fi in sorted(mi.functions.items()):
            if not isinstance(fi.node, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                continue
            for sub_qual, node in _nested_functions(fi):
                sub = FunctionInfo(sub_qual, node, mi, cls=fi.cls)
                findings.extend(_check_seeds(sub))
                if fi not in transformed:
                    findings.extend(_check_blocking_sync(sub, tree, device))
    return findings
