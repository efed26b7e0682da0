"""RL001–RL005: the effects race detector, the JAX package's
(``repro.analysis.effects_check``) over the port's
``env/tools_impl.py``.

``execute_graph_batch`` trusts ``TOOL_EFFECTS`` for RAW/WAR/WAW hazard
inference — an *undeclared* workspace write is a silent data race the
bitwise-parity tests may never trigger (two "independent" nodes land in
one wave and mutate the same resource), and an *over-declared* effect
serializes nodes that could fuse (lost parallelism). This analyzer
closes the loop statically: it parses every tool handler branch in the
dispatch function, infers the handler's actual workspace reads/writes
and rng use from the AST, and diffs that against the declared
``ToolEffects`` entry.

Inference rules, over the workspace parameter (first arg of the
dispatch function, ``ws`` by convention):

  * ``ws.attr = ...``, ``ws.attr += ...``, ``ws.attr[...] = ...`` and
    mutating method calls (``append``/``extend``/``update``/...) are
    WRITES of the resource mapped to ``attr``;
  * any method call on ``ws.rng`` is an rng WRITE (consuming the seeded
    stream reorders every later draw — core/toolgraph.py models rng as
    a write resource for exactly this reason);
  * every other load of ``ws.attr`` is a READ;
  * helpers called with the workspace (``_helper(ws, ...)``) are
    summarized once and inlined at their call sites;
  * a declared WRITE subsumes reads of the same resource (write-hazard
    edges are a superset of read-hazard edges), so ``reads ⊆ declared
    reads ∪ declared writes`` and ``writes ⊆ declared writes`` is the
    soundness condition; anything declared but never inferred is
    over-declaration.

Handler branches are the ``if name == "x":`` / ``if name in (...):``
arms of the dispatch function; a branch shared by several tools
attributes its whole body to each of them (a sound over-approximation —
the declared entries for those tools are identical today).

The attr→resource map and read-only attr set come from module literals
``WORKSPACE_RESOURCE_ATTRS`` / ``READONLY_WORKSPACE_ATTRS`` when the
analyzed file defines them (env/tools_impl.py does), else from the
defaults mirrored here — so the analyzer runs unchanged on fixture
corpora.

The sweep is parameterized over (effects table, dispatch key): the base
pass checks ``TOOL_EFFECTS`` against the ``name``-keyed dispatch, and a
second pass (analysis/runner.py) checks ``CATALOG_FAMILY_EFFECTS``
against the ``family``-keyed dispatch covering every generated catalog
family (core/catalog.py) — so scaling the catalog cannot open effects
coverage gaps.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding, make_finding

_MUTATORS = {"append", "extend", "add", "update", "insert", "pop",
             "clear", "setdefault", "remove", "discard", "popitem",
             "appendleft", "sort", "reverse"}

_DEFAULT_ATTRS = {
    "handles": "handles", "map": "map_layers", "detections": "detections",
    "landcover": "landcover", "artifacts": "artifacts",
    "answer": "last_answer", "ui": "ui_state", "rng": "rng",
}
_DEFAULT_READONLY = {"world", "temperature"}

#: names of workspace methods that touch no hazard resource
_WS_PURE_METHODS = {"obs"}

#: second-parameter names that mark a module function as a dispatch
#: function rather than a summarizable helper — one per effects table
#: ("name": TOOL_EFFECTS base pass; "family": CATALOG_FAMILY_EFFECTS
#: generated-catalog pass)
_DISPATCH_PARAMS = ("name", "family")


@dataclass
class InferredEffects:
    reads: Set[str] = field(default_factory=set)
    writes: Set[str] = field(default_factory=set)
    #: attr -> first line where an unknown workspace attr was touched
    unknown: Dict[str, int] = field(default_factory=dict)
    #: resource -> first line of read / write (for finding locations)
    read_line: Dict[str, int] = field(default_factory=dict)
    write_line: Dict[str, int] = field(default_factory=dict)

    def merge(self, other: "InferredEffects", line: int) -> None:
        """Fold ``other`` in; ``line`` is the fallback location (the
        call/branch site) when ``other`` lacks a precise one."""
        for r in other.reads:
            self.reads.add(r)
            self.read_line.setdefault(r, other.read_line.get(r, line))
        for r in other.writes:
            self.writes.add(r)
            self.write_line.setdefault(r, other.write_line.get(r, line))
        for a, aline in other.unknown.items():
            self.unknown.setdefault(a, aline)


class _WsVisitor(ast.NodeVisitor):
    """Collect workspace effects inside one statement list."""

    def __init__(self, ws_name: str, attr_map: Dict[str, str],
                 readonly: Set[str],
                 helpers: Dict[str, "InferredEffects"]):
        self.ws = ws_name
        self.res_of = {attr: res for res, attr in attr_map.items()}
        self.readonly = set(readonly)
        self.helpers = helpers
        self.eff = InferredEffects()

    # -- helpers ----------------------------------------------------------
    def _is_ws(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and node.id == self.ws

    def _ws_attr(self, node: ast.AST) -> Optional[Tuple[str, int]]:
        """(attr, line) when ``node`` is ``ws.<attr>``."""
        if isinstance(node, ast.Attribute) and self._is_ws(node.value):
            return node.attr, node.lineno
        return None

    def _note(self, attr: str, line: int, write: bool) -> None:
        if attr in self.readonly or attr in _WS_PURE_METHODS:
            return
        res = self.res_of.get(attr)
        if res is None:
            self.eff.unknown.setdefault(attr, line)
            return
        if write:
            self.eff.writes.add(res)
            self.eff.write_line.setdefault(res, line)
        else:
            self.eff.reads.add(res)
            self.eff.read_line.setdefault(res, line)

    # -- writes -----------------------------------------------------------
    def _target(self, tgt: ast.AST) -> None:
        wa = self._ws_attr(tgt)
        if wa:
            self._note(wa[0], wa[1], write=True)
            return
        if isinstance(tgt, ast.Subscript):
            wa = self._ws_attr(tgt.value)
            if wa:
                self._note(wa[0], wa[1], write=True)
                return
            self.visit(tgt.value)
            self.visit(tgt.slice)
            return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._target(e)
            return
        self.visit(tgt)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._target(tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._target(node.target)
        # augmented assignment also reads the target resource, but a
        # write subsumes the read for hazard purposes
        self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        # ws.attr.method(...) — mutators write, others read the attr
        if isinstance(fn, ast.Attribute):
            wa = self._ws_attr(fn.value)
            if wa is not None:
                attr, line = wa
                # any rng method consumes the seeded stream => write
                is_write = (fn.attr in _MUTATORS
                            or self.res_of.get(attr) == "rng")
                self._note(attr, line, write=is_write)
                for a in node.args:
                    self.visit(a)
                for kw in node.keywords:
                    self.visit(kw.value)
                return
            # ws.method(...): pure observation helpers are transparent
            if self._is_ws(fn.value) and fn.attr in _WS_PURE_METHODS:
                for a in node.args:
                    self.visit(a)
                for kw in node.keywords:
                    self.visit(kw.value)
                return
        # helper(ws, ...) — inline the helper's summary
        if isinstance(fn, ast.Name) and fn.id in self.helpers and any(
                self._is_ws(a) for a in node.args):
            self.eff.merge(self.helpers[fn.id], node.lineno)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        wa = self._ws_attr(node)
        if wa:
            self._note(wa[0], wa[1], write=False)
            return
        self.generic_visit(node)


def _infer(body: Sequence[ast.stmt], ws_name: str,
           attr_map: Dict[str, str], readonly: Set[str],
           helpers: Dict[str, InferredEffects]) -> InferredEffects:
    v = _WsVisitor(ws_name, attr_map, readonly, helpers)
    for stmt in body:
        v.visit(stmt)
    return v.eff


# --------------------------------------------------- module-level parse ----

def _literal_str_dict(node: ast.AST) -> Optional[Dict[str, str]]:
    if isinstance(node, ast.Dict):
        try:
            d = {ast.literal_eval(k): ast.literal_eval(v)
                 for k, v in zip(node.keys, node.values)}
        except (ValueError, TypeError):
            return None
        if all(isinstance(k, str) and isinstance(v, str)
               for k, v in d.items()):
            return d
    return None


def _tool_names_of_test(test: ast.AST, name_arg: str) -> List[str]:
    """Tool names matched by ``name == "x"`` / ``name in ("x", "y")``."""
    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return []
    left, op, right = test.left, test.ops[0], test.comparators[0]
    if not (isinstance(left, ast.Name) and left.id == name_arg):
        return []
    if isinstance(op, ast.Eq) and isinstance(right, ast.Constant) \
            and isinstance(right.value, str):
        return [right.value]
    if isinstance(op, ast.In) and isinstance(right, (ast.Tuple, ast.List,
                                                     ast.Set)):
        names = []
        for e in right.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                names.append(e.value)
        return names
    return []


@dataclass
class HandlerInfo:
    tools: Tuple[str, ...]
    line: int
    effects: InferredEffects


def _declared_effects(tree: ast.Module, table_name: str = "TOOL_EFFECTS"
                      ) -> Dict[str, Tuple[Set[str], Set[str], int]]:
    """Parse the ``<table_name> = {...}`` literal: tool -> (reads,
    writes, line). Supports the ``_eff(reads=..., writes=...)`` helper
    and direct ``ToolEffects(frozenset(...), frozenset(...))`` calls."""
    out: Dict[str, Tuple[Set[str], Set[str], int]] = {}
    for node in tree.body:
        if not (isinstance(node, (ast.Assign, ast.AnnAssign))):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        if not any(isinstance(t, ast.Name) and t.id == table_name
                   for t in targets):
            continue
        value = node.value
        if not isinstance(value, ast.Dict):
            continue
        for k, v in zip(value.keys, value.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            reads: Set[str] = set()
            writes: Set[str] = set()
            if isinstance(v, ast.Call):
                args = list(v.args)
                kwargs = {kw.arg: kw.value for kw in v.keywords}
                def _strset(n: Optional[ast.AST]) -> Set[str]:
                    if n is None:
                        return set()
                    try:
                        val = ast.literal_eval(n)
                    except (ValueError, TypeError):
                        return set()
                    if isinstance(val, str):
                        return set(val.split())
                    return set(val)
                fn = v.func
                fname = fn.id if isinstance(fn, ast.Name) else getattr(
                    fn, "attr", "")
                if fname == "_eff":
                    reads = _strset(args[0] if args else
                                    kwargs.get("reads"))
                    writes = _strset(args[1] if len(args) > 1 else
                                     kwargs.get("writes"))
                else:   # ToolEffects(frozenset({...}), frozenset({...}))
                    def _inner(n: Optional[ast.AST]) -> Set[str]:
                        if isinstance(n, ast.Call) and n.args:
                            return _strset(n.args[0])
                        return _strset(n)
                    reads = _inner(args[0] if args else
                                   kwargs.get("reads"))
                    writes = _inner(args[1] if len(args) > 1 else
                                    kwargs.get("writes"))
            out[k.value] = (reads, writes, v.lineno)
    return out


def _dispatch_functions(tree: ast.Module, name_param: str = "name"
                        ) -> List[ast.FunctionDef]:
    """Dispatch functions: module-level defs whose params look like
    ``(ws-like, <name_param>, ...)`` — we key on a first param named
    ``ws`` (or annotated Workspace) and a second param matching the
    pass's dispatch key (``name`` or ``family``)."""
    out = []
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        params = [a.arg for a in node.args.args]
        if len(params) >= 2 and params[1] == name_param and (
                params[0] == "ws" or _annotated_workspace(node.args.args[0])):
            out.append(node)
    return out


def _annotated_workspace(arg: ast.arg) -> bool:
    ann = arg.annotation
    name = ""
    if isinstance(ann, ast.Name):
        name = ann.id
    elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value
    return name == "Workspace"


def _helper_summaries(tree: ast.Module, attr_map: Dict[str, str],
                      readonly: Set[str]) -> Dict[str, InferredEffects]:
    """One-level summaries for module functions taking a ws param."""
    out: Dict[str, InferredEffects] = {}
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        params = [a.arg for a in node.args.args]
        # a dispatch function (second param is a dispatch key) must not
        # be summarized as a helper: inlining its union-of-branches at
        # a call site would attribute every family's effects to the
        # calling tool
        if (params and params[0] == "ws"
                and (len(params) < 2
                     or params[1] not in _DISPATCH_PARAMS)):
            out[node.name] = _infer(node.body, "ws", attr_map, readonly, {})
    return out


def analyze_effects(path: Path, source: str,
                    registry_names: Optional[Sequence[str]] = None,
                    table_name: str = "TOOL_EFFECTS",
                    name_param: str = "name") -> List[Finding]:
    """Run RL001–RL005 over one tools-impl-shaped file.

    ``registry_names``: when given (the real repo run passes the
    catalog), RL004 also checks registry ⇔ effects-table coverage.
    ``table_name``/``name_param`` select the pass: the default checks
    ``TOOL_EFFECTS`` against the ``name``-keyed dispatch; the
    generated-catalog pass checks ``CATALOG_FAMILY_EFFECTS`` against
    the ``family``-keyed dispatch.
    """
    findings: List[Finding] = []
    tree = ast.parse(source)

    attr_map = dict(_DEFAULT_ATTRS)
    readonly = set(_DEFAULT_READONLY)
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names = {t.id for t in targets if isinstance(t, ast.Name)}
            if "WORKSPACE_RESOURCE_ATTRS" in names and node.value is not None:
                parsed = _literal_str_dict(node.value)
                if parsed:
                    attr_map = parsed
            if "READONLY_WORKSPACE_ATTRS" in names and node.value is not None:
                try:
                    val = ast.literal_eval(
                        node.value.args[0]
                        if isinstance(node.value, ast.Call)
                        and node.value.args else node.value)
                    readonly = set(val)
                except (ValueError, TypeError):
                    pass

    declared = _declared_effects(tree, table_name)
    helpers = _helper_summaries(tree, attr_map, readonly)

    handlers: List[HandlerInfo] = []
    for fn in _dispatch_functions(tree, name_param):
        ws_name = fn.args.args[0].arg
        name_arg = fn.args.args[1].arg
        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.If):
                continue
            tools = _tool_names_of_test(stmt.test, name_arg)
            if not tools:
                continue
            eff = _infer(stmt.body, ws_name, attr_map, readonly, helpers)
            handlers.append(HandlerInfo(tuple(tools), stmt.lineno, eff))

    handled_tools: Set[str] = set()
    for h in handlers:
        handled_tools.update(h.tools)

    # nested `if name == ...` arms inside a multi-tool branch re-appear
    # as their own HandlerInfo; union per tool
    per_tool: Dict[str, Tuple[InferredEffects, int]] = {}
    for h in handlers:
        for t in h.tools:
            if t in per_tool:
                per_tool[t][0].merge(h.effects, h.line)
            else:
                eff = InferredEffects()
                eff.merge(h.effects, h.line)
                per_tool[t] = (eff, h.line)

    for tool in sorted(per_tool):
        eff, line = per_tool[tool]
        for attr, aline in sorted(eff.unknown.items()):
            findings.append(make_finding(
                "RL005", path, aline,
                f"handler {tool!r} touches workspace attribute "
                f"{attr!r} outside the hazard alphabet",
                "add the resource to WORKSPACE_RESOURCE_ATTRS + "
                "core.toolgraph.WORKSPACE_RESOURCES (or mark it "
                "read-only) so hazard inference can order it"))
        if tool not in declared:
            findings.append(make_finding(
                "RL004", path, line,
                f"tool {tool!r} has a handler but no {table_name} entry",
                "add an entry; unknown tools fail graph compilation"))
            continue
        dr, dw, dline = declared[tool]
        for res in sorted(eff.writes - dw):
            findings.append(make_finding(
                "RL001", path, eff.write_line.get(res, line),
                f"tool {tool!r} writes {res!r} but declares writes="
                f"{sorted(dw)}",
                f"declare the write in {table_name}: undeclared writes "
                "race inside execute_graph_batch waves"))
        for res in sorted(eff.reads - (dr | dw)):
            findings.append(make_finding(
                "RL002", path, eff.read_line.get(res, line),
                f"tool {tool!r} reads {res!r} but declares reads="
                f"{sorted(dr)} writes={sorted(dw)}",
                "declare the read: an unordered RAW hazard makes "
                "observations schedule-dependent"))
        for res in sorted(dw - eff.writes):
            findings.append(make_finding(
                "RL003", path, dline,
                f"tool {tool!r} declares write of {res!r} it never "
                f"performs",
                "drop the over-declaration: it serializes nodes that "
                "could run in one wave"))
        for res in sorted(dr - eff.reads - eff.writes):
            findings.append(make_finding(
                "RL003", path, dline,
                f"tool {tool!r} declares read of {res!r} it never "
                f"performs",
                "drop the over-declaration: it serializes against "
                "writers needlessly"))

    for tool in sorted(set(declared) - handled_tools):
        findings.append(make_finding(
            "RL004", path, declared[tool][2],
            f"{table_name} entry {tool!r} has no handler branch",
            "remove the dead entry or add the handler"))

    if registry_names is not None and declared:
        reg = set(registry_names)
        for tool in sorted(reg - set(declared)):
            findings.append(make_finding(
                "RL004", path, 1,
                f"registry tool {tool!r} missing from {table_name}",
                "every catalog tool needs an effects entry for hazard "
                "inference"))
        for tool in sorted(set(declared) - reg):
            findings.append(make_finding(
                "RL004", path, declared[tool][2],
                f"{table_name} entry {tool!r} not in the tool registry",
                "remove the dead entry or register the tool"))

    return findings
