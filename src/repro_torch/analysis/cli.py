"""CLI for the port's static-analysis suite (the JAX package's
``python -m repro.analysis``, with its flags).

    python -m repro_torch.analysis                     # full repo sweep
    python -m repro_torch.analysis --fail-on error     # CI gate (default)
    python -m repro_torch.analysis --json report.json  # machine-readable
    python -m repro_torch.analysis --format github     # PR annotations
    python -m repro_torch.analysis path/to/file.py ... # explicit scope
    python -m repro_torch.analysis --write-baseline    # accept current set

Exit status: 1 when any unsuppressed finding at or above ``--fail-on``
severity remains, else 0. ``--fail-on never`` always exits 0 (report-
only mode).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis import findings as F
from repro_torch.analysis.runner import (BASELINE_NAME, repo_root,
                                         run_paths, run_repo)


def _github_line(f: F.Finding) -> str:
    level = "error" if f.severity == "error" else "warning"
    msg = f"{f.rule}: {f.message}" + (f" ({f.hint})" if f.hint else "")
    return (f"::{level} file={f.path},line={f.line},"
            f"title={f.rule}::{msg}")


def render(findings: Sequence[F.Finding], fmt: str) -> str:
    lines: List[str] = []
    if fmt == "github":
        lines = [_github_line(f) for f in findings if not f.suppressed]
    else:
        lines = [f.render() for f in findings]
    n_err = sum(1 for f in findings
                if not f.suppressed and f.severity == "error")
    n_warn = sum(1 for f in findings
                 if not f.suppressed and f.severity == "warning")
    n_sup = sum(1 for f in findings if f.suppressed)
    lines.append(f"{n_err} error(s), {n_warn} warning(s), "
                 f"{n_sup} suppressed")
    return "\n".join(lines)


def report_json(findings: Sequence[F.Finding]) -> dict:
    return {
        "findings": [f.to_json() for f in findings],
        "summary": {
            "errors": sum(1 for f in findings
                          if not f.suppressed and f.severity == "error"),
            "warnings": sum(1 for f in findings if not f.suppressed
                            and f.severity == "warning"),
            "suppressed": sum(1 for f in findings if f.suppressed),
            "rules": sorted({f.rule for f in findings}),
        },
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="determinism & hazard static analysis of the port "
                    "(rule catalog: repro_torch.analysis.findings.RULES)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: full repo "
                         "sweep incl. registry checks)")
    ap.add_argument("--fail-on", choices=("error", "warning", "never"),
                    default="error",
                    help="lowest severity that fails the run "
                         "(default: error)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the full report as JSON")
    ap.add_argument("--format", choices=("text", "github"),
                    default="text",
                    help="stdout format (github = PR annotations)")
    ap.add_argument("--baseline", metavar="PATH",
                    help=f"accepted-findings file "
                         f"(default: <repo>/{BASELINE_NAME})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current unsuppressed findings to "
                         "the baseline file and exit 0")
    args = ap.parse_args(argv)

    root = repo_root()
    baseline = Path(args.baseline) if args.baseline else None
    if args.paths:
        findings = run_paths([Path(p) for p in args.paths], root=root,
                             baseline=baseline)
    else:
        findings = run_repo(root=root, baseline=baseline)

    if args.write_baseline:
        target = baseline or root / BASELINE_NAME
        F.write_baseline(target, findings)
        print(f"wrote {target} "
              f"({sum(1 for f in findings if not f.suppressed)} entries)")
        return 0

    print(render(findings, args.format))
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report_json(findings), indent=2)
                       + "\n")

    if args.fail_on == "never":
        return 0
    return 1 if F.active(findings, args.fail_on) else 0


if __name__ == "__main__":          # pragma: no cover
    sys.exit(main())
