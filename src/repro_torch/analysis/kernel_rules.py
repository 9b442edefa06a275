"""Rule family 2: kernel-wrapper discipline and the ctypes ABI.

The port's counterpart of the JAX package's ``repro.analysis.
pallas_rules``, renamed because the port has no Pallas: its kernels are
CUDA C++ (``kernels/csrc/``) built by ``kernels/_build.py`` and called
through :mod:`ctypes`.  A *kernel wrapper* is a function that calls an
attribute of ``_build.library()``'s result (``lib.rt_*``; see
:mod:`repro_torch.analysis.callgraph`).  Four rules hold each wrapper to
the ROADMAP's device rule and to the sources it launches:

* ``kernel-ref-oracle`` (``pallas-ref-oracle``) — the wrapper ``<name>``
  has ``<name>_ref`` in the sibling ``ref.py`` (aliases count), when
  that ``ref.py`` is among the analyzed files.
* ``kernel-cpu-route`` (``pallas-interpret``) — the kernel must stay
  runnable off the card: the wrapper's body calls ``ref.<name>_ref``
  (a CPU tensor runs the plain version).
* ``kernel-no-fallback`` — no quiet fallback and no unchecked launch:
  no ``try`` whose handler returns or calls a ``*_ref``; every
  ``lib.rt_*`` result is bound to a name that goes to
  ``_build.check(...)`` before ``launched("<name>")``, and nothing
  counts a launch before that; ``<name>`` is a key of the sibling
  ``_common.py``'s ``LAUNCH_COUNTS``.  A wrapper that tests
  ``is_fake(...)`` has a branch taken on a fake tensor that calls
  ``kernel_work(...)``, returns, and never touches ``lib``.
* ``kernel-abi`` (``pallas-static-args``: the call's shape contract) —
  every ``rt_*`` entry of ``_build.py``'s ``_SIGNATURES`` matches the
  ``extern "C"`` prototype of the same name in ``csrc/<source>`` (or a
  header it includes) in count and kind: a pointer is ``c_void_p`` or
  ``POINTER(...)`` of its type, ``long long*`` is
  ``POINTER(c_longlong)``, ``float`` ``c_float``, ``int`` ``c_int``, and
  the return type is ``int`` (the loader's ``restype``); every
  ``extern "C"`` ``rt_*`` in ``csrc/`` has an entry and every entry a
  prototype; every ``lib.rt_x(...)`` call passes as many positional
  arguments as the entry lists.  ctypes converts by the table, so a
  mismatch here reads garbage on the card and raises nothing.

The ``.cu`` / ``.cuh`` text is read with a comment-stripping regex;
both ``extern "C" { ... }`` blocks and single ``extern "C" int
rt_...(`` declarations spread over lines are parsed.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.callgraph import (FunctionInfo, ModuleIndex,
                                            TreeIndex, canonical, dotted)
from repro_torch.analysis.findings import Finding

#: a C base type -> the ctypes type that passes it
C_TO_CTYPES = {"float": "c_float", "double": "c_double", "int": "c_int",
               "long long": "c_longlong", "int64_t": "c_longlong",
               "unsigned": "c_uint", "unsigned int": "c_uint",
               "size_t": "c_size_t", "bool": "c_bool", "char": "c_char"}
_TOKENS = re.compile(
    r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"|\'(?:\\.|[^\'\\\n])*\'', re.S)
_EXTERN = re.compile(r'extern\s+"C"\s*')
_PROTO = re.compile(r"(?P<ret>[A-Za-z_][\w \t\n\*&]*?)\s*\b(?P<name>rt_\w+)"
                    r"\s*\((?P<params>[^()]*)\)")
_INCLUDE = re.compile(r'#\s*include\s+"([^"]+)"')


def _src_line(mi: ModuleIndex, line: int) -> str:
    lines = mi.source.splitlines()
    return lines[line - 1].strip() if 0 < line <= len(lines) else ""


def _finding(mi: ModuleIndex, rule: str, line: int, symbol: str,
             msg: str) -> Finding:
    return Finding(rule=rule, path=mi.rel, line=line, symbol=symbol,
                   source=_src_line(mi, line), message=msg)


# -- the C side ------------------------------------------------------------

def strip_comments(text: str) -> str:
    """``text`` with its comments blanked (newlines kept, so line
    numbers hold); string and character literals are kept."""
    def blank(m):
        s = m.group(0)
        if s.startswith(("//", "/*")):
            return "\n" * s.count("\n")
        return s
    return _TOKENS.sub(blank, text)


def _top_level(text: str) -> str:
    """``text`` (one brace level) with every nested ``{...}`` blanked,
    newlines kept: what remains are the declarations' heads."""
    out, depth = [], 0
    for ch in text:
        if ch == "{":
            depth += 1
            out.append(" ")
        elif ch == "}":
            depth -= 1
            out.append(" ")
        else:
            out.append(ch if depth == 0 or ch == "\n" else " ")
    return "".join(out)


def _close(text: str, at: int) -> int:
    """Index just past the ``}`` that closes the ``{`` at ``at``."""
    depth = 0
    for i in range(at, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def _c_kind(param: str) -> str:
    """``const float* x`` -> ``ptr:float``; ``int n`` -> ``int``."""
    text = param.replace("*", " * ").replace("&", " & ")
    words = text.split()
    pointer = "*" in words
    words = [w for w in words if w not in ("*", "&", "const", "volatile",
                                           "restrict", "__restrict__")]
    # drop the parameter's name: the last word after a type
    if len(words) > 1 and words[-1] not in ("int", "long", "float",
                                            "double", "char", "unsigned"):
        words = words[:-1]
    base = " ".join(words)
    return f"ptr:{base}" if pointer else base


def prototypes(text: str) -> Dict[str, Tuple[int, str, List[str]]]:
    """{name: (line, return type, [parameter kinds])} of the ``rt_*``
    functions declared ``extern "C"`` in one C++ source."""
    code = strip_comments(text)
    out: Dict[str, Tuple[int, str, List[str]]] = {}
    for m in _EXTERN.finditer(code):
        start = m.end()
        if code.startswith("{", start):
            end = _close(code, start)
            region = _top_level(code[start + 1:end - 1])
            offset = start + 1
        else:
            stop = min([i for i in (code.find("{", start),
                                    code.find(";", start)) if i >= 0]
                       or [len(code)])
            region, offset = code[start:stop], start
        for p in _PROTO.finditer(region):
            params = [q.strip() for q in p.group("params").split(",")
                      if q.strip() and q.strip() != "void"]
            line = code.count("\n", 0, offset + p.start("name")) + 1
            ret = " ".join(p.group("ret").replace("extern", " ").split())
            out[p.group("name")] = (line, ret, [_c_kind(q) for q in params])
    return out


def _ctypes_kind(node: ast.AST, aliases: Dict[str, ast.AST]) -> str:
    """``ctypes.c_void_p`` -> ``c_void_p``; ``ctypes.POINTER(ctypes.
    c_longlong)`` -> ``POINTER(c_longlong)``; module aliases followed."""
    seen = 0
    while isinstance(node, ast.Name) and node.id in aliases and seen < 16:
        node, seen = aliases[node.id], seen + 1
    if isinstance(node, ast.Call):
        head = dotted(node.func)
        if head and head.split(".")[-1] == "POINTER" and node.args:
            return f"POINTER({_ctypes_kind(node.args[0], aliases)})"
        return "?"
    head = dotted(node)
    return head.split(".")[-1] if head else "?"


def _matches(ctype: str, ckind: str) -> bool:
    if ckind.startswith("ptr:"):
        base = ckind[4:]
        if ctype == "c_void_p":
            return base != "long long"
        if ctype.startswith("POINTER("):
            return C_TO_CTYPES.get(base) == ctype[len("POINTER("):-1]
        return False
    return C_TO_CTYPES.get(ckind) == ctype


def _c_text(ckind: str) -> str:
    return f"{ckind[4:]}*" if ckind.startswith("ptr:") else ckind


class Signatures:
    """``_SIGNATURES`` of one ``_build.py`` and the prototypes of its
    ``csrc/``."""

    def __init__(self, mi: ModuleIndex):
        self.mi = mi
        self.csrc = mi.path.resolve().parent / "csrc"
        self.csrc_rel = str(pathlib.PurePosixPath(mi.rel).parent / "csrc")
        aliases: Dict[str, ast.AST] = {}
        table: Optional[ast.Dict] = None
        for node in mi.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if name == "_SIGNATURES" and isinstance(node.value,
                                                        ast.Dict):
                    table = node.value
                else:
                    aliases[name] = node.value
        #: {rt name: (source, key line, [ctypes kinds])}
        self.entries: Dict[str, Tuple[str, int, List[str]]] = {}
        if table is not None:
            for src_key, fns in zip(table.keys, table.values):
                if not (isinstance(src_key, ast.Constant)
                        and isinstance(fns, ast.Dict)):
                    continue
                for key, types in zip(fns.keys, fns.values):
                    if isinstance(key, ast.Constant) \
                            and isinstance(types, (ast.List, ast.Tuple)):
                        self.entries[key.value] = (
                            src_key.value, key.lineno,
                            [_ctypes_kind(t, aliases) for t in types.elts])
        self.found = table is not None
        #: {file name: {rt name: (line, ret, kinds)}}, and its includes
        self.protos: Dict[str, Dict[str, Tuple[int, str, List[str]]]] = {}
        self.includes: Dict[str, List[str]] = {}
        if self.csrc.is_dir():
            for path in sorted(self.csrc.iterdir()):
                if path.suffix in (".cu", ".cuh"):
                    text = path.read_text()
                    self.protos[path.name] = prototypes(text)
                    self.includes[path.name] = _INCLUDE.findall(text)

    def prototype(self, source: str, name: str):
        """(file, (line, ret, kinds)) of ``name`` in ``source`` or a
        header it includes, else None."""
        for f in [source] + self.includes.get(source, []):
            if name in self.protos.get(f, {}):
                return f, self.protos[f][name]
        return None

    def check(self) -> List[Finding]:
        findings: List[Finding] = []
        mi = self.mi
        for name, (source, line, kinds) in sorted(self.entries.items()):
            got = self.prototype(source, name)
            if got is None:
                elsewhere = [f for f, ps in self.protos.items() if name in ps]
                where = (f"; it is in csrc/{elsewhere[0]}" if elsewhere
                         else "")
                findings.append(_finding(
                    mi, "kernel-abi", line, name,
                    f"_SIGNATURES lists '{name}' under '{source}', which "
                    f"declares no extern \"C\" prototype of it{where}"))
                continue
            f, (_, ret, ckinds) = got
            problems = []
            if ret != "int":
                problems.append(f"returns '{ret}', the loader sets "
                                f"restype c_int")
            if len(ckinds) != len(kinds):
                problems.append(f"takes {len(ckinds)} parameters, "
                                f"_SIGNATURES lists {len(kinds)}")
            for i, (ct, ck) in enumerate(zip(kinds, ckinds)):
                if not _matches(ct, ck):
                    problems.append(f"parameter {i} is '{_c_text(ck)}' in "
                                    f"C but {ct} in _SIGNATURES")
            if problems:
                findings.append(_finding(
                    mi, "kernel-abi", line, name,
                    f"'{name}' (csrc/{f}) and its _SIGNATURES entry "
                    f"disagree: " + "; ".join(problems)))
        for f, protos in sorted(self.protos.items()):
            for name, (line, _, _) in sorted(protos.items()):
                if name not in self.entries:
                    findings.append(Finding(
                        rule="kernel-abi", path=f"{self.csrc_rel}/{f}",
                        line=line, symbol=name, source="",
                        message=(f"extern \"C\" '{name}' in csrc/{f} has "
                                 f"no _SIGNATURES entry in {mi.rel} — "
                                 f"ctypes cannot type its call")))
        return findings


# -- the Python side -------------------------------------------------------

def _ref_symbols(tree: TreeIndex, mi: ModuleIndex) -> Optional[Set[str]]:
    """Top-level symbols of the sibling ref.py, if one is indexed."""
    ref = tree.sibling(mi, "ref.py")
    if ref is None:
        return None
    symbols = set(ref.functions)
    for node in ref.tree.body:                 # aliases: `x_ref = y_ref`
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    symbols.add(tgt.id)
    return symbols


def _launch_counts(tree: TreeIndex, mi: ModuleIndex) -> Optional[Set[str]]:
    """Keys of the sibling _common.py's ``LAUNCH_COUNTS``, if indexed."""
    common = tree.sibling(mi, "_common.py")
    if common is None:
        return None
    for node in common.tree.body:
        target = (node.targets[0] if isinstance(node, ast.Assign)
                  and len(node.targets) == 1 else getattr(node, "target",
                                                          None))
        if isinstance(target, ast.Name) and target.id == "LAUNCH_COUNTS" \
                and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
    return set()


def _last_segment(mi: ModuleIndex, call: ast.Call) -> str:
    head = canonical(mi, dotted(call.func)) or ""
    return head.split(".")[-1]


def _string_value(fn: ast.AST, node: ast.AST, before: int) -> Optional[str]:
    """A str constant, or the last str constant bound to a name before
    line ``before``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        value = None
        for a in ast.walk(fn):
            if isinstance(a, ast.Assign) and a.lineno < before \
                    and any(isinstance(t, ast.Name) and t.id == node.id
                            for t in a.targets) \
                    and isinstance(a.value, ast.Constant) \
                    and isinstance(a.value.value, str):
                value = a.value.value
        return value
    return None


def _touches_lib(mi: ModuleIndex, nodes, libs: Set[str]) -> bool:
    for stmt in nodes:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Name) and sub.id in libs:
                return True
            if isinstance(sub, ast.Attribute) and sub.attr.startswith("rt_"):
                return True
            if isinstance(sub, ast.Call) and _last_segment(mi, sub) \
                    == "library":
                return True
    return False


def _check_fake_route(fi: FunctionInfo, name: str,
                      libs: Set[str]) -> List[Finding]:
    mi, fn = fi.module, fi.node
    fake_names = {t.id for a in ast.walk(fn) if isinstance(a, ast.Assign)
                  and isinstance(a.value, ast.Call)
                  and _last_segment(mi, a.value) == "is_fake"
                  for t in a.targets if isinstance(t, ast.Name)}
    tests_fake = fake_names or any(
        isinstance(c, ast.Call) and _last_segment(mi, c) == "is_fake"
        for c in ast.walk(fn))
    if not tests_fake:
        return []

    def positive(test: ast.AST) -> bool:
        return (isinstance(test, ast.Name) and test.id in fake_names) or (
            isinstance(test, ast.Call) and _last_segment(mi, test)
            == "is_fake")

    branches = [n for n in ast.walk(fn)
                if isinstance(n, ast.If) and positive(n.test)]
    ok = any(
        any(isinstance(c, ast.Call) and _last_segment(mi, c) == "kernel_work"
            for stmt in b.body for c in ast.walk(stmt))
        and any(isinstance(s, ast.Return) for stmt in b.body
                for s in ast.walk(stmt))
        and not _touches_lib(mi, b.body, libs)
        for b in branches)
    if ok:
        return []
    return [_finding(mi, "kernel-no-fallback", fn.lineno, fi.qualname,
                     f"'{name}' tests is_fake(...) but has no branch taken "
                     f"on a fake tensor that calls kernel_work(...), "
                     f"returns and never touches lib")]


def _check_wrapper(tree: TreeIndex, fi: FunctionInfo,
                   sigs: Optional[Signatures]) -> List[Finding]:
    mi, fn = fi.module, fi.node
    name = fn.name
    findings: List[Finding] = []
    want = f"{name}_ref"

    symbols = _ref_symbols(tree, mi)
    if symbols is not None and want not in symbols:
        findings.append(_finding(
            mi, "kernel-ref-oracle", fn.lineno, fi.qualname,
            f"'{name}' has no oracle '{want}' in "
            f"{pathlib.PurePosixPath(mi.rel).parent}/ref.py — every "
            f"kernel needs a plain PyTorch version"))

    calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)]
    if not any((canonical(mi, dotted(c.func)) or "").split(".")[-2:]
               == ["ref", want] or dotted(c.func) == want for c in calls):
        findings.append(_finding(
            mi, "kernel-cpu-route", fn.lineno, fi.qualname,
            f"'{name}' never calls ref.{want} — a CPU tensor must run the "
            f"plain version, so the kernel stays testable off the card"))

    # no quiet fallback
    for t in ast.walk(fn):
        if not isinstance(t, ast.Try):
            continue
        for h in t.handlers:
            quiet = any(isinstance(s, ast.Return) for stmt in h.body
                        for s in ast.walk(stmt)) or any(
                isinstance(c, ast.Call)
                and (dotted(c.func) or "").endswith("_ref")
                for stmt in h.body for c in ast.walk(stmt))
            if quiet:
                findings.append(_finding(
                    mi, "kernel-no-fallback", h.lineno, fi.qualname,
                    f"'{name}' catches a failure and returns or runs the "
                    f"plain version — on the card a wrapper launches or "
                    f"raises"))

    # every launch checked, then counted under its name
    libs = {t.id for a in ast.walk(fn) if isinstance(a, ast.Assign)
            and isinstance(a.value, ast.Call)
            and _last_segment(mi, a.value) == "library"
            for t in a.targets if isinstance(t, ast.Name)}
    results: Dict[int, Tuple[str, ast.Call]] = {}
    for a in ast.walk(fn):
        if isinstance(a, ast.Assign) and a.value in fi.kernel_calls \
                and len(a.targets) == 1 and isinstance(a.targets[0],
                                                       ast.Name):
            results[id(a.value)] = (a.targets[0].id, a.value)
    checks = [c for c in calls if _last_segment(mi, c) == "check"
              and (canonical(mi, dotted(c.func)) or "").split(".")[-2:]
              == ["_build", "check"] and c.args
              and isinstance(c.args[0], ast.Name)]
    launches = sorted((c for c in calls
                       if _last_segment(mi, c) == "launched"),
                      key=lambda c: (c.lineno, c.col_offset))
    checked_at: List[int] = []
    for kc in fi.kernel_calls:
        got = results.get(id(kc))
        check_line = None
        if got is not None:
            lines = [c.lineno for c in checks
                     if c.args[0].id == got[0] and c.lineno >= kc.lineno]
            check_line = min(lines) if lines else None
        if check_line is None:
            findings.append(_finding(
                mi, "kernel-no-fallback", kc.lineno, fi.qualname,
                f"the result of lib.{kc.func.attr}(...) is not bound to a "
                f"name passed to _build.check(...) — a launch error would "
                f"pass unseen"))
            continue
        checked_at.append(check_line)
        after = [c for c in launches if c.lineno > check_line]
        if not after or _string_value(fn, after[0].args[0]
                                      if after[0].args else None,
                                      after[0].lineno) != name:
            findings.append(_finding(
                mi, "kernel-no-fallback", kc.lineno, fi.qualname,
                f"lib.{kc.func.attr}(...) is checked but not followed by "
                f"launched({name!r})"))
    for c in launches:
        if not any(line < c.lineno for line in checked_at):
            findings.append(_finding(
                mi, "kernel-no-fallback", c.lineno, fi.qualname,
                f"'{name}' counts a launch where no checked kernel call "
                f"precedes it"))
        counted = _string_value(fn, c.args[0] if c.args else None,
                                c.lineno)
        keys = _launch_counts(tree, mi)
        if keys is not None and counted not in keys:
            findings.append(_finding(
                mi, "kernel-no-fallback", c.lineno, fi.qualname,
                f"launched({counted!r}) names no key of "
                f"_common.LAUNCH_COUNTS"))

    findings.extend(_check_fake_route(fi, name, libs))

    # each call passes what the table lists
    if sigs is not None and sigs.found:
        for kc in fi.kernel_calls:
            rt = kc.func.attr
            if rt not in sigs.entries:
                findings.append(_finding(
                    mi, "kernel-abi", kc.lineno, fi.qualname,
                    f"lib.{rt}(...) has no _SIGNATURES entry"))
                continue
            n_want = len(sigs.entries[rt][2])
            starred = any(isinstance(a, ast.Starred) for a in kc.args)
            if starred or kc.keywords or len(kc.args) != n_want:
                findings.append(_finding(
                    mi, "kernel-abi", kc.lineno, fi.qualname,
                    f"lib.{rt}(...) passes {len(kc.args)} positional "
                    f"arguments{' (starred)' if starred else ''}"
                    f"{' and keywords' if kc.keywords else ''}; "
                    f"_SIGNATURES lists {n_want}"))
    return findings


def check(tree: TreeIndex) -> List[Finding]:
    findings: List[Finding] = []
    sigs: Dict[str, Signatures] = {}
    for rel, mi in sorted(tree.modules.items()):
        if pathlib.PurePosixPath(rel).name == "_build.py":
            s = Signatures(mi)
            if s.found:
                sigs[rel] = s
                findings.extend(s.check())
    for fi in tree.kernel_wrappers():
        if not isinstance(fi.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        build = str(pathlib.PurePosixPath(fi.module.rel).parent
                    / "_build.py")
        findings.extend(_check_wrapper(tree, fi, sigs.get(build)))
    return findings
