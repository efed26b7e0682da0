"""Shared finding model for the port's static-analysis suite (``python -m
repro_torch.analysis``), the JAX package's (``repro.analysis.findings``)
with the port's rule catalog.

A :class:`Finding` is one rule violation at one source location; every
analyzer in this package emits the same shape so the CLI can merge,
suppress, baseline and render them uniformly. Severities:

  * ``error``   — breaks the repo's determinism/parity contract
                  (undeclared workspace write, wall-clock in serving,
                  kernel contract violation, ...);
  * ``warning`` — correct but wasteful or fragile (over-declared
                  effects = lost parallelism).

The catalog keeps every id and severity of the JAX package's but three:
RL201 (non-fp32 VMEM scratch), RL202 (BlockSpec ``index_map`` arity)
and RL204 (``dimension_semantics`` arity) check Pallas constructs the
port's CUDA kernels do not have. RL203 and RL205 keep their ids and
guard the same hazards at the port's kernel boundary: RL203 the ctypes
``argtypes`` of each wrapper against its ``extern "C"`` entry (an
argument out of order or missing launches on wrong values and raises
nothing), RL205 an exponent taken in half precision in a CUDA source.

Suppression, in precedence order:

  1. inline  — ``# repro-lint: disable=RL001`` (comma-separated ids,
     or ``all``) on the finding's line; in a CUDA source
     ``// repro-lint: disable=RL205``;
  2. file    — ``# repro-lint: disable-file=RL104`` (``//`` in a CUDA
     source) anywhere in the file suppresses that rule for the whole
     file;
  3. baseline — a JSON file of accepted findings, matched on
     ``(rule, path, message)`` so line drift does not resurrect them.

Suppressed findings are kept (flagged) rather than dropped: reports
show them, exit codes ignore them.
"""
from __future__ import annotations

import io
import json
import tokenize
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Set, Tuple

SEVERITIES = ("error", "warning")

#: the suffixes of CUDA sources, whose comments start with ``//``
C_SUFFIXES = (".cu", ".cuh")

#: rule id -> (severity, one-line summary); the authoritative catalog
RULES: Dict[str, Tuple[str, str]] = {
    # effects race detector (env/tools_impl.py handlers vs TOOL_EFFECTS)
    "RL001": ("error", "undeclared workspace write (hazard race)"),
    "RL002": ("error", "undeclared workspace read (unordered RAW)"),
    "RL003": ("warning", "over-declared effect (lost parallelism)"),
    "RL004": ("error", "registry/effects-table coverage gap"),
    "RL005": ("error", "workspace attribute outside the hazard alphabet"),
    # determinism lint (core/ serving/ env/ kernels/)
    "RL101": ("error", "wall-clock read in deterministic code"),
    "RL102": ("error", "stdlib random (unseeded global stream)"),
    "RL103": ("error", "environment read in deterministic code"),
    "RL104": ("error", "unordered set iteration feeding ordered output"),
    "RL105": ("error", "float-keyed dict (hash/round-trip fragile)"),
    "RL106": ("error", "wall-clock read outside the injected-clock "
                       "boundary"),
    # kernel contract checker (kernels/*.py wrappers, csrc/*.cu{,h})
    "RL203": ("error", "ctypes argtypes / C entry signature mismatch"),
    "RL205": ("error", "exponent in half precision in a CUDA source"),
    # kernel registry checker (kernels/backend.py, kernels/, csrc/)
    "RL301": ("error", "op function signature violates OP_SURFACE"),
    "RL302": ("error", "kernel module or source not wired into the "
                       "registry"),
    "RL303": ("error", "op, launch counter or registry import missing"),
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str                    # repo-relative, "/"-separated
    line: int
    message: str
    hint: str = ""
    suppressed: str = ""         # "", "inline", "file" or "baseline"

    @property
    def severity(self) -> str:
        return RULES[self.rule][0]

    def to_json(self) -> Dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint,
                "suppressed": self.suppressed}

    def render(self) -> str:
        tag = f" [suppressed:{self.suppressed}]" if self.suppressed else ""
        hint = f"\n    hint: {self.hint}" if self.hint else ""
        return (f"{self.path}:{self.line}: {self.rule} "
                f"{self.severity}: {self.message}{tag}{hint}")


def make_finding(rule: str, path, line: int, message: str,
                 hint: str = "") -> Finding:
    assert rule in RULES, rule
    return Finding(rule, str(path).replace("\\", "/"), line, message, hint)


# ------------------------------------------------------- suppressions ----

_MARK = "repro-lint:"


def _parse_directive(comment: str) -> Tuple[str, Set[str]]:
    """Parse one ``# repro-lint: disable[-file]=RL001,RL002`` comment
    (or its ``//`` form); returns ("", set()) when the comment is not a
    directive."""
    text = comment.lstrip("#/").strip()
    if not text.startswith(_MARK):
        return "", set()
    body = text[len(_MARK):].strip()
    for kind in ("disable-file", "disable"):
        if body.startswith(kind):
            rest = body[len(kind):].lstrip("= ")
            ids = {r.strip() for r in rest.split(",") if r.strip()}
            return kind, ids
    return "", set()


@dataclass
class Suppressions:
    """Per-file suppression state parsed from comments."""
    by_line: Dict[int, Set[str]] = field(default_factory=dict)
    whole_file: Set[str] = field(default_factory=set)

    def _add(self, line: int, comment: str) -> None:
        kind, ids = _parse_directive(comment)
        if kind == "disable":
            self.by_line.setdefault(line, set()).update(ids)
        elif kind == "disable-file":
            self.whole_file.update(ids)

    @classmethod
    def for_source(cls, source: str) -> "Suppressions":
        sup = cls()
        try:
            toks = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    sup._add(tok.start[0], tok.string)
        except (tokenize.TokenizeError, SyntaxError):
            pass
        return sup

    @classmethod
    def for_c_source(cls, source: str) -> "Suppressions":
        """The ``// repro-lint: ...`` comments of a CUDA source."""
        sup = cls()
        for i, line in enumerate(source.splitlines(), 1):
            at = line.find("//")
            if at >= 0:
                sup._add(i, line[at:])
        return sup

    @classmethod
    def for_path(cls, path: str, source: str) -> "Suppressions":
        if path.endswith(C_SUFFIXES):
            return cls.for_c_source(source)
        return cls.for_source(source)

    def match(self, f: Finding) -> str:
        inline = self.by_line.get(f.line, set())
        if f.rule in inline or "all" in inline:
            return "inline"
        if f.rule in self.whole_file or "all" in self.whole_file:
            return "file"
        return ""


def apply_suppressions(findings: Sequence[Finding],
                       source_by_path: Dict[str, str]) -> List[Finding]:
    """Mark findings suppressed by in-source directives."""
    cache: Dict[str, Suppressions] = {}
    out: List[Finding] = []
    for f in findings:
        if f.path not in cache and f.path in source_by_path:
            cache[f.path] = Suppressions.for_path(f.path,
                                                  source_by_path[f.path])
        kind = cache[f.path].match(f) if f.path in cache else ""
        out.append(replace(f, suppressed=kind) if kind else f)
    return out


# ----------------------------------------------------------- baseline ----

def load_baseline(path: Path) -> Set[Tuple[str, str, str]]:
    """Accepted findings as (rule, path, message) triples."""
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return {(e["rule"], e["path"], e["message"])
            for e in data.get("accepted", [])}


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    entries = [{"rule": f.rule, "path": f.path, "message": f.message}
               for f in findings if not f.suppressed]
    entries.sort(key=lambda e: (e["path"], e["rule"], e["message"]))
    path.write_text(json.dumps({"accepted": entries}, indent=2) + "\n")


def apply_baseline(findings: Sequence[Finding],
                   baseline: Set[Tuple[str, str, str]]) -> List[Finding]:
    out: List[Finding] = []
    for f in findings:
        if not f.suppressed and (f.rule, f.path, f.message) in baseline:
            f = replace(f, suppressed="baseline")
        out.append(f)
    return out


def active(findings: Iterable[Finding], severity: str = "error"
           ) -> List[Finding]:
    """Unsuppressed findings at or above ``severity``."""
    keep = {"error": ("error",),
            "warning": ("error", "warning")}[severity]
    return [f for f in findings
            if not f.suppressed and f.severity in keep]
