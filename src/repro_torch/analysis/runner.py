"""Orchestration: which analyzer runs where, suppression/baseline
application, and report assembly for the CLI (the JAX package's
``repro.analysis.runner`` over the port's tree).

Scopes (relative to the repo root, auto-detected from this package's
location unless overridden):

  * effects race detector  — ``src/repro_torch/env/tools_impl.py``
    (diffed against the live tool registry and catalog families);
  * determinism lint       — ``src/repro_torch/{core,serving,env,
    kernels}`` under the full RL101–RL105 battery; every other
    ``src/repro_torch`` package gets the RL106 injected-clock boundary
    rule only, except the clock providers ``obs/`` and ``launch/``
    (``determinism.wallclock_scope`` is the dispatcher; tests stay out
    of scope);
  * kernel contracts       — every ``src/repro_torch/kernels/*.py``
    that binds a CUDA entry through ``_build.entry`` (RL203), and every
    ``src/repro_torch/csrc/*.cu``/``*.cuh`` (RL203 unreferenced
    entries, RL205);
  * kernel registry        — ``src/repro_torch/kernels/`` with its
    ``csrc/`` as a unit.

``run_repo`` is the one entry the CLI and tests share; ``run_paths``
analyzes an explicit file/dir list (fixture corpora) with the same
rule engine but no repo-wide registry coupling.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.analysis import findings as F
from repro_torch.analysis.backend_check import analyze_backend_registry
from repro_torch.analysis.determinism import (analyze_clock_boundary,
                                              analyze_determinism,
                                              wallclock_scope)
from repro_torch.analysis.effects_check import analyze_effects
from repro_torch.analysis.kernel_contracts import (analyze_cuda,
                                                   analyze_wrapper,
                                                   declared_symbols)

DETERMINISM_DIRS = ("core", "serving", "env", "kernels")
#: RL106-only scope: everything else under src/repro_torch except the
#: allowlisted clock providers (obs/, launch/)
BOUNDARY_DIRS = ("analysis", "common", "configs", "distributed",
                 "models", "training")
#: the CUDA sources (RL203, RL205)
CUDA_DIR = "csrc"
#: the port's own, so that neither suite's baseline suppresses the
#: other's findings
BASELINE_NAME = "analysis_baseline_torch.json"


def repo_root() -> Path:
    """…/src/repro_torch/analysis/runner.py -> the repo checkout root."""
    return Path(__file__).resolve().parents[3]


def _rel(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def _is_wrapper(path: Path, source: str) -> bool:
    return (path.stem not in ("__init__", "ref", "backend", "_build")
            and "entry(" in source)


def analyze_file(path: Path, root: Path,
                 registry_names: Optional[Sequence[str]] = None
                 ) -> List[F.Finding]:
    """Every applicable single-file analyzer over one source file."""
    source = path.read_text()
    rel = _rel(path, root)
    if path.suffix in F.C_SUFFIXES:
        declared = declared_symbols(path) if path.suffix == ".cu" else None
        return analyze_cuda(Path(rel), source, declared)
    out: List[F.Finding] = []
    scope = wallclock_scope(rel)
    if scope == "full":
        out.extend(analyze_determinism(Path(rel), source))
    elif scope == "boundary":
        out.extend(analyze_clock_boundary(Path(rel), source))
    # "allow": the clock providers get no determinism-family lint
    has_effects_table = any(ln.startswith("TOOL_EFFECTS")
                            for ln in source.splitlines())
    if path.name == "tools_impl.py" or has_effects_table:
        out.extend(analyze_effects(Path(rel), source,
                                   registry_names=registry_names))
    # generated-catalog pass: the family-keyed dispatch must cover the
    # CATALOG_FAMILY_EFFECTS table (and vice versa) so growing the
    # catalog can't open an effects coverage gap
    if any(ln.startswith("CATALOG_FAMILY_EFFECTS")
           for ln in source.splitlines()):
        try:
            from repro_torch.core.catalog import FAMILY_NAMES
            family_names: Optional[Sequence[str]] = FAMILY_NAMES
        except Exception:
            family_names = None
        out.extend(analyze_effects(Path(rel), source,
                                   registry_names=family_names,
                                   table_name="CATALOG_FAMILY_EFFECTS",
                                   name_param="family"))
    if _is_wrapper(path, source):
        out.extend(analyze_wrapper(Path(rel), source, file_path=path))
    return out


def _suppress(findings: List[F.Finding], root: Path) -> List[F.Finding]:
    sources: Dict[str, str] = {}
    for f in findings:
        p = root / f.path
        if f.path not in sources and p.exists():
            sources[f.path] = p.read_text()
    return F.apply_suppressions(findings, sources)


def _files(p: Path) -> List[Path]:
    if not p.is_dir():
        return [p]
    return sorted([*p.rglob("*.py"), *p.rglob("*.cu"), *p.rglob("*.cuh")])


def run_paths(paths: Iterable[Path], root: Optional[Path] = None,
              baseline: Optional[Path] = None) -> List[F.Finding]:
    """Analyze an explicit list of files/dirs (no registry coupling)."""
    root = root or repo_root()
    files: List[Path] = []
    for p in paths:
        files.extend(_files(Path(p)))
    findings: List[F.Finding] = []
    for f in files:
        findings.extend(analyze_file(f, root))
    findings = _suppress(findings, root)
    if baseline is not None:
        findings = F.apply_baseline(findings, F.load_baseline(baseline))
    findings.sort(key=lambda x: (x.path, x.line, x.rule))
    return findings


def run_repo(root: Optional[Path] = None,
             baseline: Optional[Path] = None) -> List[F.Finding]:
    """The full four-analyzer sweep the CI gate runs."""
    root = root or repo_root()
    pkg = root / "src" / "repro_torch"
    findings: List[F.Finding] = []

    try:
        from repro_torch.core.tools import DEFAULT_REGISTRY
        registry_names: Optional[List[str]] = DEFAULT_REGISTRY.names()
    except Exception:
        registry_names = None

    for d in DETERMINISM_DIRS + BOUNDARY_DIRS:
        for f in sorted((pkg / d).rglob("*.py")):
            findings.extend(analyze_file(f, root,
                                         registry_names=registry_names))
    for f in _files(pkg / CUDA_DIR):
        findings.extend(analyze_file(f, root))

    kfinds = analyze_backend_registry(pkg / "kernels")
    for f in kfinds:
        findings.append(F.Finding(f.rule, _rel(Path(f.path), root),
                                  f.line, f.message, f.hint))

    findings = _suppress(findings, root)
    bl = baseline if baseline is not None else root / BASELINE_NAME
    findings = F.apply_baseline(findings, F.load_baseline(bl))
    findings.sort(key=lambda x: (x.path, x.line, x.rule))
    return findings
