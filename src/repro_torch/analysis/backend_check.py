"""RL301–RL303: the kernel registry checker, over the port's
``kernels/backend.py``.

The JAX package's checker (``repro.analysis.backend_check``) holds each
registered backend (``reference``, ``pallas``) to the op surface. The
port registers no backends: ``kernels/backend.py`` defines one function
per op of ``OP_SURFACE`` and dispatches by the device of its tensors (a
CUDA tensor to the kernel, a CPU tensor to its plain version), so JAX's
``REQUIRED_BACKENDS`` has no counterpart. The three rules mean this
here:

  * RL301 — a module-level op function whose signature cannot serve
    ``OP_SURFACE[op]`` (the port's ``backend.check_op_signature``, the
    JAX package's rule), at the function's ``def``;
  * RL302 — a kernel module under ``kernels/`` that ``backend.py``
    never imports (the kernel exists but no op reaches it), at
    ``backend.py``'s last kernel import; or a ``csrc/*.cu`` that no
    wrapper reaches through ``_build.entry`` / ``_build.load``, at its
    first line;
  * RL303 — ``backend.py`` failing to import, an op of ``OP_SURFACE``
    with no function (at its ``OP_SURFACE`` entry), or an entry of
    ``KERNELS`` without its ``launches`` counter (at ``KERNELS``).

RL302 is static over the sources, so it works on any checkout; RL301
and RL303 import the ``backend.py`` of the checked directory.
"""
from __future__ import annotations

import ast
import importlib
import importlib.util
import sys
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.analysis.findings import Finding, make_finding
from repro_torch.analysis.kernel_contracts import sources_reached

#: kernels/ modules that are not kernel implementations
_NON_KERNEL_MODULES = {"__init__", "ref", "backend", "_build"}


def _load_backend(backend_py: Path):
    """The module of ``backend_py``: the package's own when it is the
    installed one, else loaded from the file under a private name (its
    absolute imports still reach the package's kernels)."""
    own = Path(__file__).resolve().parents[1] / "kernels" / "backend.py"
    if backend_py.resolve() == own:
        return importlib.import_module("repro_torch.kernels.backend")
    name = "_repro_lint_backend"
    spec = importlib.util.spec_from_file_location(name, backend_py)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    return mod


def _lines(tree: ast.Module) -> Dict[str, int]:
    """``def`` lines of module functions, ``OP_SURFACE`` key lines (as
    ``surface:<op>``) and the line of each module assignment."""
    out: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node.lineno
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, node.lineno)
                    if t.id == "OP_SURFACE" and isinstance(node.value,
                                                           ast.Dict):
                        for k in node.value.keys:
                            if isinstance(k, ast.Constant):
                                out[f"surface:{k.value}"] = k.lineno
    return out


def analyze_backend_registry(kernels_dir: Path) -> List[Finding]:
    findings: List[Finding] = []
    backend_py = kernels_dir / "backend.py"
    rel = backend_py

    # ---- RL302: every kernel module is imported by backend.py --------
    imported: set = set()
    line_of_imports = 1
    lines: Dict[str, int] = {}
    if backend_py.exists():
        tree = ast.parse(backend_py.read_text())
        lines = _lines(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                parts = node.module.split(".")
                if "kernels" in parts:
                    imported.add(parts[-1])
                    line_of_imports = node.lineno
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    parts = alias.name.split(".")
                    if "kernels" in parts:
                        imported.add(parts[-1])
    wrappers = sorted(kernels_dir.glob("*.py"))
    for mod in sorted(p.stem for p in wrappers):
        if mod in _NON_KERNEL_MODULES:
            continue
        if mod not in imported:
            findings.append(make_finding(
                "RL302", rel, line_of_imports,
                f"kernel module {mod!r} is not imported by the backend "
                f"registry",
                "dispatch an op of OP_SURFACE to it in backend.py (or "
                "fold it into ref.py if it is a plain version)"))

    # ---- RL302: every CUDA source is reached by a wrapper --------------
    reached = sources_reached([p.read_text() for p in wrappers])
    csrc = kernels_dir.parent / "csrc"
    if "*" not in reached:
        for cu in sorted(csrc.glob("*.cu")):
            if cu.stem not in reached:
                findings.append(make_finding(
                    "RL302", cu, 1,
                    f"CUDA source {cu.name!r} is reached by no wrapper's "
                    f"_build.entry or _build.load",
                    "bind its entries in a kernels/ wrapper, or remove "
                    "the dead source"))

    # ---- RL301/RL303: the op functions and the launch counters --------
    try:
        KB = _load_backend(backend_py)
    except Exception as e:          # any import failure is the finding
        findings.append(make_finding(
            "RL303", rel, 1,
            f"kernel registry failed to import: {e}",
            "fix the import error in backend.py"))
        return findings

    surface = getattr(KB, "OP_SURFACE", None)
    check = getattr(KB, "check_op_signature", None)
    if not isinstance(surface, dict) or not callable(check):
        findings.append(make_finding(
            "RL303", rel, 1,
            "kernel registry defines no OP_SURFACE or "
            "check_op_signature",
            "keep the JAX package's op surface and its signature rule"))
        return findings
    for op in sorted(surface):
        impl: Optional[object] = getattr(KB, op, None)
        if not callable(impl):
            findings.append(make_finding(
                "RL303", rel, lines.get(f"surface:{op}", 1),
                f"op {op!r} of OP_SURFACE has no function",
                f"define {op}(...) with OP_SURFACE[{op!r}]'s parameters"))
            continue
        defect = check(op, impl)
        if defect:
            findings.append(make_finding(
                "RL301", rel, lines.get(op, 1),
                f"op {op!r}: {defect}",
                f"align the function with OP_SURFACE[{op!r}]"))
    if not hasattr(KB, "KERNELS"):
        findings.append(make_finding(
            "RL303", rel, 1, "kernel registry defines no KERNELS",
            "list every kernel wrapper in KERNELS"))
    for k in getattr(KB, "KERNELS", ()):
        if not hasattr(k, "launches"):
            findings.append(make_finding(
                "RL303", rel, lines.get("KERNELS", 1),
                f"kernel {getattr(k, '__name__', k)!r} of KERNELS has no "
                f"launches counter",
                "set <kernel>.launches = 0 beside the wrapper and add one "
                "where it launches its kernel"))
    return findings
