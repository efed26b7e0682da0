"""RL203, RL205: the kernel contract checker, aimed at the port's kernel
boundary.

The JAX package's checker (``repro.analysis.kernel_contracts``) parses
every ``pl.pallas_call`` site, since "a scalar operand out of order
aliases the wrong ref". The port's kernels are CUDA C++ with a plain C
interface, loaded through ``ctypes`` (``kernels/_build.py``): a wrapper
declares each entry's argument types in a Python list and calls the
entry positionally. ctypes cannot see the C signature, so an ``argtypes``
list one ``c_int`` short, or a ``c_int`` where the C side takes a
``float``, launches the kernel on wrong values and raises nothing. This
checker holds the two sides to each other:

  * RL203, in a wrapper — for every ``_build.entry(source, symbol,
    ARGTYPES)`` call, the statically evaluated ``ARGTYPES`` (a list of
    ``[ctypes.c_void_p] * n + ...``) against the ``extern "C"``
    signature of ``symbol`` in ``csrc/<source>.cu``: the same count, and
    the same kind at every position (a pointer takes ``c_void_p``, an
    ``int`` ``c_int``, a ``float`` ``c_float``; any other C type is
    named in the message); an entry that the source does not define;
    and every call of the returned function with a positional count
    other than ``len(ARGTYPES)``;
  * RL203, in a CUDA source — an ``extern "C"`` entry that no wrapper
    declares through ``_build.entry``;
  * RL205 — a ``.cu``/``.cuh`` that exponentiates in half precision
    (``hexp``, ``h2exp``, ``hexp2``, ``h2exp2``, ``hlog``, ``h2log``):
    the online softmax and the scans keep their exponents in fp32, as
    the JAX rule demands of the Pallas bodies.

A wrapper's source is found as ``../csrc/<source>.cu`` from the wrapper
(the port's layout) or beside it (the fixture corpora); a source's
wrappers are the ``*.py`` of ``../kernels/`` and of its own directory.

Static only; conservative: a site whose source, symbol, ``ARGTYPES`` or
call arguments are not literal enough to evaluate is skipped, never
guessed (:func:`entry_sites` reports what each site resolved).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, make_finding

#: ctypes type -> the C parameter kind it passes; any other ctypes type
#: or C type is its own kind, named in the message
_CTYPES_KIND = {"c_void_p": "pointer", "c_int": "int", "c_float": "float"}
_QUALIFIERS = {"const", "volatile", "__restrict__", "restrict"}
#: the half-precision exponent and log intrinsics of cuda_fp16.h
HALF_EXP = ("hexp", "h2exp", "hexp2", "h2exp2", "hlog", "h2log")
_HALF_EXP_RE = re.compile(r"\b(" + "|".join(HALF_EXP) + r")\s*\(")
_EXTERN_RE = re.compile(r'extern\s+"C"\s+([^;{}()]*?)\b(\w+)\s*\(([^)]*)\)')


# ----------------------------------------------------------- C side ----

def strip_c_comments(source: str, strings: bool = False) -> str:
    """``source`` with every comment (and, with ``strings``, the body of
    every string and character literal) blanked, newlines kept so that
    offsets keep their lines."""
    out: List[str] = []
    i, n = 0, len(source)
    while i < n:
        c = source[i]
        two = source[i:i + 2]
        if two == "//":
            j = source.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif two == "/*":
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("".join(ch if ch == "\n" else " "
                               for ch in source[i:j]))
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            j = min(j + 1, n)
            body = source[i + 1:j - 1]
            out.append(c + (" " * len(body) if strings else body)
                       + source[j - 1:j])
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _line_of(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


@dataclass
class CParam:
    text: str                    # the declaration, whitespace collapsed
    kind: str                    # "pointer", else the type


@dataclass
class CEntry:
    symbol: str
    line: int
    params: List[CParam]


def _c_param(decl: str) -> CParam:
    text = " ".join(decl.split())
    if "*" in text or "[" in text:
        return CParam(text, "pointer")
    words = [w for w in text.split() if w not in _QUALIFIERS]
    return CParam(text, " ".join(words[:-1] if len(words) > 1 else words))


def c_entries(source: str) -> List[CEntry]:
    """Every ``extern "C"`` function of a CUDA source, in order (the
    first declaration of a symbol wins)."""
    text = strip_c_comments(source)
    out: Dict[str, CEntry] = {}
    for m in _EXTERN_RE.finditer(text):
        symbol, args = m.group(2), m.group(3).strip()
        if symbol in out:
            continue
        decls = [] if args in ("", "void") else args.split(",")
        out[symbol] = CEntry(symbol, _line_of(text, m.start()),
                             [_c_param(d) for d in decls])
    return list(out.values())


def analyze_cuda(path: Path, source: str,
                 declared: Optional[Sequence[str]] = None
                 ) -> List[Finding]:
    """RL205 over one CUDA source, and RL203 for each of its ``extern
    "C"`` entries not in ``declared`` (the symbols its wrappers name;
    None skips that check)."""
    findings: List[Finding] = []
    text = strip_c_comments(source, strings=True)
    for m in _HALF_EXP_RE.finditer(text):
        findings.append(make_finding(
            "RL205", path, _line_of(text, m.start()),
            f"half-precision exponent {m.group(1)}() in a CUDA source",
            "promote to fp32 (__half2float / __bfloat162float) and use "
            "expf/exp2f/logf; accumulate in fp32"))
    if declared is not None:
        for e in c_entries(source):
            if e.symbol not in declared:
                findings.append(make_finding(
                    "RL203", path, e.line,
                    f'extern "C" entry {e.symbol!r} is declared by no '
                    f"wrapper's _build.entry",
                    "declare it in its wrapper with its argtypes, or "
                    "remove the dead entry"))
    return findings


# ------------------------------------------------------ Python side ----

def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    return None


class _Scope:
    """Single assignments of a function body (or of the module), the
    only bindings the evaluator follows: a name bound twice, by a loop,
    by unpacking or as a parameter is not followed."""

    def __init__(self, body: Sequence[ast.stmt], params=(),
                 parent: Optional["_Scope"] = None):
        self.parent = parent
        self.values: Dict[str, Optional[ast.AST]] = {p: None
                                                     for p in params}
        self.lines: Dict[str, int] = {}
        for node in _walk_local(body):
            for name, value in _bindings(node):
                if name in self.values:
                    self.values[name] = None       # bound twice
                else:
                    self.values[name] = value
                    self.lines[name] = getattr(node, "lineno", 0)

    def lookup(self, name: str) -> Tuple[Optional[ast.AST],
                                         Optional["_Scope"]]:
        if name in self.values:
            return self.values[name], self
        if self.parent is not None:
            return self.parent.lookup(name)
        return None, None


def _walk_local(body: Sequence[ast.stmt]):
    """Every node of a body, breadth first, nested blocks and
    expressions included; a nested function, class or lambda is yielded
    but not entered."""
    stack = list(body)
    while stack:
        node = stack.pop(0)
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                yield child
                continue
            stack.append(child)


def _bindings(node: ast.AST):
    """(name, value or None) of each name ``node`` binds."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Name):
                yield t.id, node.value if len(node.targets) == 1 else None
            else:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        yield sub.id, None
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                        ast.Name):
        yield node.target.id, node.value
    elif isinstance(node, (ast.AugAssign, ast.For, ast.AsyncFor,
                           ast.comprehension)):
        for sub in ast.walk(node.target):
            if isinstance(sub, ast.Name):
                yield sub.id, None
    elif isinstance(node, (ast.With, ast.AsyncWith)):
        for item in node.items:
            if item.optional_vars is not None:
                for sub in ast.walk(item.optional_vars):
                    if isinstance(sub, ast.Name):
                        yield sub.id, None
    elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        yield node.name, None
    elif isinstance(node, (ast.Import, ast.ImportFrom)):
        for a in node.names:
            yield (a.asname or a.name).split(".")[0], None
    elif isinstance(node, ast.NamedExpr):
        yield node.target.id, None


class _Evaluator:
    """Static items of the sequences a site needs: its argtypes list and
    the arguments of each call of its entry. None where not literal."""

    def __init__(self, module: ast.Module):
        self.mscope = _Scope(module.body)
        self.functions = {n.name: n for n in module.body
                          if isinstance(n, ast.FunctionDef)}

    def items(self, node: ast.AST, scope: _Scope,
              depth: int = 0) -> Optional[List[ast.AST]]:
        """The expressions a sequence expression yields, in order (for a
        generator or a helper's return, only their count is meant)."""
        if depth > 20:                       # a name bound to itself
            return None
        if isinstance(node, (ast.List, ast.Tuple)):
            return self.args(node.elts, scope, depth + 1)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            a = self.items(node.left, scope, depth + 1)
            b = self.items(node.right, scope, depth + 1)
            return None if a is None or b is None else a + b
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            for seq, k in ((node.left, node.right),
                           (node.right, node.left)):
                n = _int(k)
                if n is not None:
                    sub = self.items(seq, scope, depth + 1)
                    return None if sub is None else sub * n
            return None
        if isinstance(node, ast.GeneratorExp) \
                and len(node.generators) == 1 \
                and not node.generators[0].ifs:
            sub = self.items(node.generators[0].iter, scope, depth + 1)
            return None if sub is None else [node.elt] * len(sub)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id == "tuple" and len(node.args) == 1 \
                    and not node.keywords:
                return self.items(node.args[0], scope, depth + 1)
            fn = self.functions.get(node.func.id)
            return None if fn is None else self._returned(fn, depth + 1)
        if isinstance(node, ast.Name):
            value, where = scope.lookup(node.id)
            if value is None:
                return None
            return self.items(value, where, depth + 1)
        return None

    def args(self, args: Sequence[ast.AST], scope: _Scope,
             depth: int = 0) -> Optional[List[ast.AST]]:
        """The positional arguments ``args`` pass, starred ones
        expanded."""
        out: List[ast.AST] = []
        for a in args:
            if isinstance(a, ast.Starred):
                sub = self.items(a.value, scope, depth + 1)
                if sub is None:
                    return None
                out += sub
            else:
                out.append(a)
        return out

    def _returned(self, fn: ast.FunctionDef,
                  depth: int) -> Optional[List[ast.AST]]:
        """The items every ``return`` of a module helper yields, when
        they all yield as many."""
        scope = self.function_scope(fn)
        rets = [self.items(r.value, scope, depth)
                for r in _walk_local(fn.body)
                if isinstance(r, ast.Return) and r.value is not None]
        if not rets or any(r is None for r in rets) \
                or len({len(r) for r in rets}) != 1:
            return None
        return rets[0]

    def ctypes_kinds(self, node: ast.AST,
                     scope: _Scope) -> Optional[List[str]]:
        """The ctypes type names of an argtypes list."""
        items = self.items(node, scope)
        if items is None:
            return None
        names = [_dotted(e).rpartition(".")[2] for e in items]
        return names if all(n.startswith("c_") for n in names) else None

    def count(self, args: Sequence[ast.AST],
              scope: _Scope) -> Optional[int]:
        items = self.args(args, scope)
        return None if items is None else len(items)

    def function_scope(self, fn: Optional[ast.FunctionDef]) -> _Scope:
        if fn is None:
            return self.mscope
        a = fn.args
        params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        params += [p.arg for p in (a.vararg, a.kwarg) if p is not None]
        return _Scope(fn.body, params, self.mscope)


@dataclass
class EntrySite:
    """One ``_build.entry(source, symbol, argtypes)`` call of a wrapper,
    with what the checker resolved of it (None: not resolved)."""
    line: int
    source: Optional[str]
    symbol: Optional[str]
    argtypes_name: str
    argtypes_line: int
    argtypes: Optional[List[str]]
    cu_path: Optional[Path] = None
    c_entry: Optional[CEntry] = None
    #: (line, positional count or None) of each call of the entry's
    #: returned function
    calls: List[Tuple[int, Optional[int]]] = field(default_factory=list)

    @property
    def resolved(self) -> bool:
        """Both sides and every call evaluated: nothing was skipped."""
        return (self.argtypes is not None and self.c_entry is not None
                and bool(self.calls)
                and all(n is not None for _, n in self.calls))


def _is_build_call(node: ast.AST, name: str) -> bool:
    """``node`` is a call of ``_build.<name>``."""
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    return d == f"_build.{name}" or d.endswith(f"._build.{name}")


def find_cuda_source(wrapper: Path, source: str) -> Optional[Path]:
    for cand in (wrapper.parent.parent / "csrc" / f"{source}.cu",
                 wrapper.parent / f"{source}.cu"):
        if cand.is_file():
            return cand
    return None


def entry_sites(path: Path, source: str,
                file_path: Optional[Path] = None) -> List[EntrySite]:
    """Every ``_build.entry`` site of one wrapper, resolved as far as
    the checker can (``file_path``: where the wrapper lies on disk, to
    find its CUDA sources; default ``path``)."""
    module = ast.parse(source)
    ev = _Evaluator(module)
    file_path = path if file_path is None else file_path
    sites: List[EntrySite] = []

    def visit(node: ast.AST, fn: Optional[ast.FunctionDef]) -> None:
        for child in ast.iter_child_nodes(node):
            nfn = child if isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)) \
                else fn
            if _is_build_call(child, "entry"):
                sites.append(_site(child, fn))
            visit(child, nfn)

    def _site(call: ast.Call, fn: Optional[ast.FunctionDef]) -> EntrySite:
        scope = ev.function_scope(fn)
        args = list(call.args) + [None] * 3
        src, sym, at = _str(args[0]), _str(args[1]), args[2]
        at_name, at_line, kinds = "<missing>", call.lineno, None
        if at is not None:
            kinds = ev.ctypes_kinds(at, scope)
            at_name = ast.unparse(at) if not isinstance(at, ast.Name) \
                else at.id
            at_line = at.lineno
            if isinstance(at, ast.Name):
                _, where = scope.lookup(at.id)
                if where is not None and at.id in where.lines:
                    at_line = where.lines[at.id]
        site = EntrySite(call.lineno, src, sym, at_name, at_line, kinds)
        if src is not None:
            site.cu_path = find_cuda_source(file_path, src)
        if site.cu_path is not None and sym is not None:
            site.c_entry = next((e for e in c_entries(
                site.cu_path.read_text()) if e.symbol == sym), None)
        site.calls = _calls_of(call, fn, scope)
        return site

    def _calls_of(call: ast.Call, fn: Optional[ast.FunctionDef],
                  scope: _Scope) -> List[Tuple[int, Optional[int]]]:
        body = fn.body if fn is not None else module.body
        out: List[Tuple[int, Optional[int]]] = []
        bound = None
        for node in _walk_local(body):
            if isinstance(node, ast.Assign) and node.value is call \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                bound = node.targets[0].id
        for node in _walk_local(body):
            if isinstance(node, ast.Call) and (node.func is call or (
                    bound is not None and isinstance(node.func, ast.Name)
                    and node.func.id == bound)):
                out.append((node.lineno, ev.count(node.args, scope)))
        return out

    visit(module, None)
    return sites


def analyze_wrapper(path: Path, source: str,
                    file_path: Optional[Path] = None) -> List[Finding]:
    """RL203 over one kernel wrapper (see the module docstring)."""
    findings: List[Finding] = []
    for site in entry_sites(path, source, file_path):
        kinds, entry = site.argtypes, site.c_entry
        if site.cu_path is not None and site.symbol is not None \
                and entry is None:
            findings.append(make_finding(
                "RL203", path, site.line,
                f"_build.entry names {site.symbol!r}, which "
                f"{site.cu_path.name} does not define",
                'declare the entry extern "C" in its source, or fix the '
                "symbol"))
        if kinds is not None and entry is not None:
            where = f"{site.cu_path.name}:{entry.line}"
            if len(kinds) != len(entry.params):
                findings.append(make_finding(
                    "RL203", path, site.argtypes_line,
                    f"argtypes {site.argtypes_name} of {site.symbol!r} "
                    f"declare {len(kinds)} arguments; {where} takes "
                    f"{len(entry.params)}",
                    "one ctypes type per C parameter, in the C order"))
            else:
                bad = [f"argument {i} is ctypes.{k} for C {p.text!r}"
                       for i, (k, p) in enumerate(zip(kinds, entry.params))
                       if _CTYPES_KIND.get(k, k) != p.kind]
                if bad:
                    findings.append(make_finding(
                        "RL203", path, site.argtypes_line,
                        f"argtypes {site.argtypes_name} of "
                        f"{site.symbol!r} disagree with {where}: "
                        + "; ".join(bad),
                        "a pointer takes c_void_p, an int c_int, a float "
                        "c_float"))
        if kinds is not None:
            for line, n in site.calls:
                if n is not None and n != len(kinds):
                    findings.append(make_finding(
                        "RL203", path, line,
                        f"entry {site.symbol!r} called with {n} "
                        f"positional arguments; argtypes "
                        f"{site.argtypes_name} declare {len(kinds)}",
                        "pass one argument per declared argtype"))
    return findings


def sources_reached(wrapper_sources: Sequence[str]) -> Dict[str, set]:
    """``source -> {symbols}`` of the ``_build.entry`` sites and the
    ``_build.load`` calls (symbol set empty) of some wrappers; a site
    whose source or symbol is not a literal maps to ``"*"`` (everything
    is possibly reached)."""
    out: Dict[str, set] = {}
    for text in wrapper_sources:
        for node in ast.walk(ast.parse(text)):
            if _is_build_call(node, "entry"):
                args = list(node.args) + [None] * 2
                src, sym = _str(args[0]), _str(args[1])
                out.setdefault(src or "*", set()).add(sym or "*")
            elif _is_build_call(node, "load"):
                src = _str(node.args[0]) if node.args else None
                out.setdefault(src or "*", set())
    return out


def wrappers_of(cu_path: Path) -> List[Path]:
    """The wrappers that may declare a CUDA source's entries: the
    ``*.py`` of ``../kernels/`` and of the source's own directory."""
    out: List[Path] = []
    for d in (cu_path.parent.parent / "kernels", cu_path.parent):
        if d.is_dir():
            out += sorted(d.glob("*.py"))
    return out


def declared_symbols(cu_path: Path) -> Optional[List[str]]:
    """The symbols of ``cu_path`` its wrappers declare, or None when a
    site cannot be resolved (then no entry is flagged)."""
    reached = sources_reached([p.read_text() for p in wrappers_of(cu_path)])
    if "*" in reached:
        return None
    syms = reached.get(cu_path.stem, set())
    return None if "*" in syms else sorted(syms)
