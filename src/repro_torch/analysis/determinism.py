"""RL101–RL106: determinism lint, the JAX package's
(``repro.analysis.determinism``) over the port's tree.

The serving stack's headline claims — bitwise-identical replays, tick
clocks, seeded rng everywhere — are conventions, not types. This pass
makes them machine-checked in the deterministic directories (``core/``,
``serving/``, ``env/``, ``kernels/``; ``benchmarks/`` and tests
legitimately read wall-clock and are out of scope by default):

  * RL101 — wall-clock reads: ``time.time/monotonic/perf_counter/
    time_ns``, ``datetime.now/utcnow/today``. A tick-based system that
    reads the wall clock is only *usually* reproducible.
  * RL102 — stdlib ``random``: the module-global Mersenne stream is
    process-wide mutable state; all randomness must flow through seeded
    ``np.random.Generator`` / ``torch.Generator`` objects.
  * RL103 — ``os.environ`` / ``os.getenv`` reads: behaviour keyed on
    ambient environment diverges across machines and CI.
  * RL104 — iterating a ``set``/``frozenset`` expression directly into
    an ordered sink (for-loop, comprehension, ``list``/``tuple``/
    ``join``/``enumerate``) without ``sorted(...)``: set order is
    hash-seed-dependent across processes.
  * RL105 — float-keyed dict literals/comprehensions: float key
    identity is representation-fragile (``0.1 + 0.2`` lookups, JSON
    round-trips stringify keys).
  * RL106 — the *boundary* rule for every other ``src/repro_torch``
    package
    (``common``, ``configs``, ``models``, ``distributed``,
    ``training``, ``analysis``): wall-clock reads are only legal
    behind an injected ``clock=`` callable (the engine/tracer
    convention — ``InferenceEngine(clock=...)``,
    ``Tracer.bind_clock``). Direct ``time.*``/``datetime.now``-family
    reads are flagged; the full RL102–RL105 battery is not, those
    packages may legitimately read env vars etc. Only
    ``src/repro_torch/obs/`` and ``src/repro_torch/launch/`` (the clock
    *providers*) may touch the wall clock directly — see
    :data:`CLOCK_ALLOWLIST` / :func:`wallclock_scope`.

Purely syntactic (AST) — no imports of the analyzed code.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.findings import Finding, make_finding

_WALLCLOCK_TIME = {"time", "monotonic", "perf_counter", "time_ns",
                   "monotonic_ns", "perf_counter_ns"}
_WALLCLOCK_DT = {"now", "utcnow", "today"}
_ORDERED_SINKS = {"list", "tuple", "enumerate"}

#: packages under the full RL101–RL105 battery
FULL_LINT_DIRS = ("src/repro_torch/core/", "src/repro_torch/serving/",
                  "src/repro_torch/env/", "src/repro_torch/kernels/")
#: the only packages allowed to read the wall clock directly: obs/
#: binds injected clocks to traces, launch/ is the process entry that
#: *supplies* ``time.time`` to everything else
CLOCK_ALLOWLIST = ("src/repro_torch/obs/", "src/repro_torch/launch/")


def wallclock_scope(rel: str) -> str:
    """Which determinism lint applies to a repo-relative path:

    * ``"full"``     — RL101–RL105 (deterministic core dirs, and any
      path outside ``src/repro_torch`` such as the fixture corpora);
    * ``"allow"``    — no determinism lint (the clock providers);
    * ``"boundary"`` — RL106 only (remaining ``src/repro_torch``
      packages).
    """
    rel = rel.replace("\\", "/")
    if any(rel.startswith(p) for p in CLOCK_ALLOWLIST):
        return "allow"
    if any(rel.startswith(p) for p in FULL_LINT_DIRS) \
            or not rel.startswith("src/repro_torch/"):
        return "full"
    return "boundary"


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for nested attributes rooted at a Name, else ''."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    return False


class _Lint(ast.NodeVisitor):
    """``clock_only=True`` is the RL106 boundary mode: the same
    wall-clock detection, emitted under ``clock_rule``, with every
    other rule (RL102–RL105) switched off."""

    def __init__(self, path: Path, *, clock_rule: str = "RL101",
                 clock_only: bool = False):
        self.path = path
        self.clock_rule = clock_rule
        self.clock_only = clock_only
        self.findings: List[Finding] = []

    def _add(self, rule: str, line: int, message: str, hint: str) -> None:
        self.findings.append(make_finding(rule, self.path, line,
                                          message, hint))

    def _add_clock(self, line: int, dotted: str, full_hint: str) -> None:
        if self.clock_rule == "RL106":
            self._add("RL106", line,
                      f"wall-clock read {dotted}() outside the "
                      f"injected-clock boundary",
                      "accept an injected clock= callable (the "
                      "engine/tracer convention); only "
                      "src/repro_torch/obs/ and src/repro_torch/launch/ "
                      "read the wall clock directly")
        else:
            self._add("RL101", line, f"wall-clock read {dotted}()",
                      full_hint)

    # ------------------------------------------------ RL101/RL106-103 ----
    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        head, _, tail = dotted.rpartition(".")
        if head in ("time",) and tail in _WALLCLOCK_TIME:
            self._add_clock(node.lineno, dotted,
                            "inject a clock / use the tick counter; "
                            "wall-clock belongs in launch/ and "
                            "benchmarks/")
        elif tail in _WALLCLOCK_DT and head.split(".")[-1] == "datetime":
            self._add_clock(node.lineno, dotted,
                            "pass timestamps in explicitly")
        elif self.clock_only:
            pass                 # boundary scope: clock reads only
        elif dotted in ("os.getenv",) or (
                head == "os.environ" and tail == "get"):
            self._add("RL103", node.lineno,
                      f"environment read {dotted}(...)",
                      "thread configuration through explicit config "
                      "objects / PerfFlags")
        elif head == "random" or dotted.startswith("random."):
            self._add("RL102", node.lineno,
                      f"stdlib random call {dotted}()",
                      "use a seeded np.random.Generator or "
                      "torch.Generator threaded from the caller")
        # ordered sinks over raw set expressions
        if not self.clock_only and isinstance(node.func, ast.Name) \
                and node.func.id in _ORDERED_SINKS and node.args \
                and _is_set_expr(node.args[0]):
            self._add("RL104", node.lineno,
                      f"{node.func.id}() over an unordered set "
                      f"expression",
                      "wrap the set in sorted(...)")
        if not self.clock_only and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join" and node.args \
                and _is_set_expr(node.args[0]):
            self._add("RL104", node.lineno,
                      "str.join over an unordered set expression",
                      "wrap the set in sorted(...)")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if not self.clock_only and _dotted(node.value) == "os.environ" \
                and isinstance(node.ctx, ast.Load):
            self._add("RL103", node.lineno, "os.environ[...] read",
                      "thread configuration through explicit config")
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if not self.clock_only and alias.name == "random":
                self._add("RL102", node.lineno, "import random",
                          "stdlib random is a process-global stream; "
                          "use seeded generators")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if not self.clock_only and node.module == "random":
            self._add("RL102", node.lineno, "from random import ...",
                      "use seeded generators")
        self.generic_visit(node)

    # ---------------------------------------------------------- RL104 ----
    def _check_iter(self, it: ast.AST, line: int) -> None:
        if not self.clock_only and _is_set_expr(it):
            self._add("RL104", line,
                      "iteration over an unordered set expression",
                      "iterate sorted(...) so downstream order is "
                      "deterministic")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter, node.lineno)
        self.generic_visit(node)

    def _comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter, node.lineno)
        self.generic_visit(node)

    visit_ListComp = _comp
    visit_GeneratorExp = _comp

    def visit_SetComp(self, node: ast.SetComp) -> None:
        # building another set keeps order irrelevant; don't descend
        # into RL104 for its generators, but other rules still apply
        self.generic_visit(node)

    def visit_DictComp(self, node: ast.DictComp) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter, node.lineno)
        if not self.clock_only and _is_float_const(node.key):
            self._add("RL105", node.lineno,
                      "dict comprehension with float keys",
                      "key on ints/strings (quantize or stringify)")
        self.generic_visit(node)

    # ---------------------------------------------------------- RL105 ----
    def visit_Dict(self, node: ast.Dict) -> None:
        for k in node.keys:
            if not self.clock_only and k is not None \
                    and _is_float_const(k):
                self._add("RL105", k.lineno,
                          "dict literal with float key",
                          "key on ints/strings (quantize or stringify)")
                break
        self.generic_visit(node)


def _is_float_const(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, float)


def analyze_determinism(path: Path, source: str) -> List[Finding]:
    """Full RL101–RL105 battery (deterministic-core scope)."""
    lint = _Lint(path)
    lint.visit(ast.parse(source))
    return lint.findings


def analyze_clock_boundary(path: Path, source: str) -> List[Finding]:
    """RL106 only: wall-clock reads in boundary-scope packages (the
    rest of the determinism battery does not apply there)."""
    lint = _Lint(path, clock_rule="RL106", clock_only=True)
    lint.visit(ast.parse(source))
    return lint.findings
