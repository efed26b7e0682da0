"""The port's static-analysis suite (``src/repro_torch/analysis``) held
against the JAX package's (``src/repro/analysis``) on the CPU.

  * shared corpus — on every file of ``tests/fixtures/analysis/`` but
    the two Pallas fixtures, the port's analyzers give the JAX suite's
    (rule, line, message, suppression) set, the RL106 fixtures under a
    tmp ``src/repro_torch/<pkg>/`` tree against JAX's under
    ``src/repro/<pkg>/``; the Pallas fixtures are data to the port (it
    has no Pallas rule);
  * the port's corpus — ``tests/fixtures/analysis_torch/``: each
    ``# expect:`` / ``// expect:`` marker of the wrapper / CUDA pair is
    caught at its line (RL203, RL205), the clean pair stays silent, and
    every file rule of the port's catalog is seeded by one corpus or
    the other;
  * semantics — JAX's tests of suppression precedence, baselines, the
    CLI's exit codes, ``--json``, ``--format github`` and write-then-use
    baselines, on the port;
  * repo gate — ``run_repo`` on the tree: no unsuppressed finding, one
    suppressed (RL103 in ``kernels/_build.py``), all twelve
    ``_build.entry`` sites resolved and every C entry declared;
  * mutations — on a tmp copy of ``kernels/`` and ``csrc/``, each
    seeded defect (an orphan module or source, a drifted or dropped
    op, a missing launch counter, an argtypes list one short, a c_int
    for a float, a call with one argument more, an undeclared extern
    "C", a half-precision exponent) is caught at its line.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import findings as JF
from repro.analysis import runner as JR
from repro.kernels import backend as JKB
from repro_torch.analysis import findings as F
from repro_torch.analysis.backend_check import analyze_backend_registry
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.determinism import wallclock_scope
from repro_torch.analysis.kernel_contracts import c_entries, entry_sites
from repro_torch.analysis.runner import (BASELINE_NAME, repo_root,
                                         run_paths, run_repo)
from repro_torch.kernels import backend as KB

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
TORCH_FIXTURES = ROOT / "tests" / "fixtures" / "analysis_torch"
PKG = ROOT / "src" / "repro_torch"
SHARED = ["bad_effects.py", "bad_determinism.py", "clean_effects.py",
          "clean_determinism.py", "suppressed.py"]
PALLAS = ["bad_kernel.py", "clean_kernel.py"]
BAD = ["bad_effects.py", "bad_determinism.py"]
BOUNDARY_BAD = ["bad_clock_boundary.py"]
TORCH_BAD = ["bad_wrapper.py", "bad_wrapper.cu"]
TORCH_CLEAN = ["clean_wrapper.py", "clean_wrapper.cu"]
N_ENTRIES = 12

_MARKER = re.compile(r"(?:#|//)\s*expect:\s*(RL\d{3}(?:\s*,\s*RL\d{3})*)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: its pool, under the suite's workers, slows
    these small ops ~10x (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def expected_markers(path: Path):
    """(line, rule) pairs pinned by `# expect: RL###` (`//` in CUDA)."""
    out = set()
    for i, line in enumerate(path.read_text().splitlines(), 1):
        m = _MARKER.search(line)
        if m:
            for rule in m.group(1).split(","):
                out.add((i, rule.strip()))
    return out


def found_pairs(findings):
    return {(f.line, f.rule) for f in findings}


def keyed(findings):
    return {(f.path, f.rule, f.line, f.message, f.suppressed)
            for f in findings}


# ----------------------------------------------- shared corpus vs JAX ----

@pytest.mark.parametrize("name", SHARED)
def test_shared_fixture_findings_equal_jax(name):
    path = FIXTURES / name
    jax_f = JR.run_paths([path])
    ours = run_paths([path])
    assert keyed(ours) == keyed(jax_f)
    assert len(ours) == len(jax_f)
    if name.startswith("bad_"):
        assert ours


def _copy_as(tmp_path, name, rel_dir):
    tree = tmp_path / rel_dir
    tree.mkdir(parents=True, exist_ok=True)
    dst = tree / name
    dst.write_text((FIXTURES / name).read_text())
    return dst


@pytest.mark.parametrize("name", ["bad_clock_boundary.py",
                                  "clean_clock_boundary.py"])
@pytest.mark.parametrize("pkg", ["models", "training", "obs", "launch",
                                 "serving"])
def test_boundary_fixture_findings_equal_jax(tmp_path, name, pkg):
    """Boundary (models, training), allowlisted (obs, launch) and full
    (serving) scopes: the same (rule, line, message) set."""
    jax_f = JR.run_paths(
        [_copy_as(tmp_path / "j", name, f"src/repro/{pkg}")],
        root=tmp_path / "j")
    ours = run_paths([_copy_as(tmp_path / "t", name,
                               f"src/repro_torch/{pkg}")],
                     root=tmp_path / "t")
    assert {(f.rule, f.line, f.message) for f in ours} == \
        {(f.rule, f.line, f.message) for f in jax_f}
    if name.startswith("bad_") and pkg in ("models", "training"):
        assert {f.rule for f in ours} == {"RL106"}
        assert all("src/repro_torch/" in f.hint for f in ours)


@pytest.mark.parametrize("name", PALLAS)
def test_pallas_fixtures_are_data_to_the_port(name):
    """JAX's Pallas fixtures raise only Pallas rules there; the port has
    none (RL201/202/204 are not in its catalog; its RL203/205 read the
    ctypes boundary and the CUDA sources), so it reports nothing."""
    path = FIXTURES / name
    assert {f.rule for f in JR.run_paths([path])} <= {
        "RL201", "RL202", "RL203", "RL204", "RL205"}
    assert run_paths([path]) == []


def test_catalog_is_jax_but_the_pallas_rules():
    assert set(JF.RULES) - set(F.RULES) == {"RL201", "RL202", "RL204"}
    assert set(F.RULES) <= set(JF.RULES)
    for rule, (sev, summary) in F.RULES.items():
        assert sev == JF.RULES[rule][0], rule
        if rule not in ("RL203", "RL205") and not rule.startswith("RL3"):
            assert summary == JF.RULES[rule][1], rule


def test_wallclock_scope_dispatch():
    assert wallclock_scope("src/repro_torch/serving/engine.py") == "full"
    assert wallclock_scope("src/repro_torch/kernels/_build.py") == "full"
    assert wallclock_scope("tests/fixtures/analysis/x.py") == "full"
    assert wallclock_scope("src/repro/models/model.py") == "full"
    assert wallclock_scope("src/repro_torch/obs/tracer.py") == "allow"
    assert wallclock_scope("src/repro_torch/launch/serve.py") == "allow"
    assert wallclock_scope("src/repro_torch/training/loop.py") == "boundary"
    assert wallclock_scope("src/repro_torch/models/model.py") == "boundary"
    assert wallclock_scope("src/repro_torch/analysis/runner.py") == \
        "boundary"


# ------------------------------------------------------ port's corpus ----

@pytest.mark.parametrize("name", TORCH_BAD)
def test_torch_bad_fixture_caught_at_exact_lines(name):
    path = TORCH_FIXTURES / name
    expected = expected_markers(path)
    assert expected, f"{name} has no expect markers"
    findings = run_paths([path])
    assert found_pairs(findings) == expected
    assert not any(f.suppressed for f in findings)
    assert all(f.hint for f in findings)


@pytest.mark.parametrize("name", TORCH_CLEAN)
def test_torch_clean_fixture_has_no_false_positives(name):
    assert run_paths([TORCH_FIXTURES / name]) == []


def test_torch_fixture_sites_resolve():
    """Every site of both wrappers is evaluated (the clean one through a
    splatted tuple and a helper returning a tuple literal)."""
    for name, n in (("clean_wrapper.py", 2), ("bad_wrapper.py", 4)):
        path = TORCH_FIXTURES / name
        sites = entry_sites(path, path.read_text())
        assert len(sites) == n
        assert all(s.argtypes is not None and s.calls for s in sites)
    clean = TORCH_FIXTURES / "clean_wrapper.py"
    assert all(s.resolved for s in entry_sites(clean, clean.read_text()))


def test_corpus_covers_every_file_rule():
    seeded = set()
    for name in BAD + BOUNDARY_BAD:
        seeded |= {rule for _, rule in expected_markers(FIXTURES / name)}
    for name in TORCH_BAD:
        seeded |= {rule for _, rule in
                   expected_markers(TORCH_FIXTURES / name)}
    file_rules = {r for r in F.RULES if not r.startswith("RL3")}
    assert seeded == file_rules


def test_cuda_suppression():
    findings = run_paths([TORCH_FIXTURES / "suppressed.cu"])
    assert [(f.line, f.suppressed) for f in findings] == \
        [(6, "inline"), (10, "")]
    assert [f.message for f in F.active(findings)] == \
        ["half-precision exponent hexp() in a CUDA source"]


def test_unresolved_site_is_skipped_not_guessed(tmp_path):
    """An argtypes list whose length is a parameter, and a call
    splatting a parameter: nothing is evaluated, nothing is flagged."""
    (tmp_path / "odd.cu").write_text(
        'extern "C" int odd_f32(const void* x, int n, void* s) '
        '{ return 0; }\n')
    wrapper = tmp_path / "odd.py"
    wrapper.write_text(
        "import ctypes\n"
        "from repro_torch.kernels import _build\n"
        "def types(n):\n"
        "    return [ctypes.c_void_p] * n\n"
        "def odd(args):\n"
        "    fn = _build.entry('odd', 'odd_f32', types(3))\n"
        "    return fn(*args)\n")
    (site,) = entry_sites(wrapper, wrapper.read_text())
    assert site.argtypes is None and site.c_entry is not None
    assert site.calls == [(7, None)] and not site.resolved
    assert run_paths([wrapper, tmp_path / "odd.cu"], root=tmp_path) == []


# ----------------------------------------------------- semantics (JAX) ----

def test_findings_carry_hints_and_severity():
    findings = run_paths([FIXTURES / "bad_effects.py"])
    assert findings and all(f.hint for f in findings)
    assert {f.severity for f in findings} <= {"error", "warning"}
    rules_at_error = {f.rule for f in F.active(findings, "error")}
    rules_at_warn = {f.rule for f in F.active(findings, "warning")}
    assert "RL003" not in rules_at_error
    assert "RL003" in rules_at_warn


def _suppressed_fixture_findings():
    return run_paths([FIXTURES / "suppressed.py"])


def test_inline_and_file_suppression():
    findings = _suppressed_fixture_findings()
    by_msg = {f.message: f for f in findings}
    assert by_msg["import random"].suppressed == "inline"
    assert by_msg["list() over an unordered set expression"] \
        .suppressed == "file"
    assert [f.message for f in F.active(findings)] == \
        ["stdlib random call random.choice()"]


def test_baseline_matches_on_message_not_line(tmp_path):
    leftover = F.active(_suppressed_fixture_findings())[0]
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"accepted": [
        {"rule": leftover.rule, "path": leftover.path,
         "message": leftover.message}]}))
    findings = run_paths([FIXTURES / "suppressed.py"], baseline=bl)
    assert F.active(findings) == []
    assert {f.suppressed for f in findings} == \
        {"inline", "file", "baseline"}


def test_write_baseline_round_trip(tmp_path):
    findings = _suppressed_fixture_findings()
    bl = tmp_path / "baseline.json"
    F.write_baseline(bl, findings)
    triples = F.load_baseline(bl)
    assert len(triples) == 1
    assert F.active(F.apply_baseline(findings, triples)) == []


def test_cli_exit_codes(capsys):
    bad = str(FIXTURES / "bad_determinism.py")
    assert cli_main([bad]) == 1
    assert cli_main([bad, "--fail-on", "never"]) == 0
    assert cli_main([str(FIXTURES / "clean_determinism.py")]) == 0
    assert cli_main([str(TORCH_FIXTURES / "bad_wrapper.cu")]) == 1
    out = capsys.readouterr().out
    assert "0 error(s), 0 warning(s), 0 suppressed" in out


def test_cli_json_report(tmp_path):
    report = tmp_path / "report.json"
    assert cli_main([str(FIXTURES / "bad_determinism.py"),
                     "--json", str(report)]) == 1
    data = json.loads(report.read_text())
    assert data["summary"]["errors"] == len(data["findings"]) > 0
    assert set(data["summary"]["rules"]) == \
        {"RL101", "RL102", "RL103", "RL104", "RL105"}
    sample = data["findings"][0]
    assert {"rule", "severity", "path", "line", "message",
            "hint", "suppressed"} <= set(sample)


def test_cli_github_format(capsys):
    assert cli_main([str(FIXTURES / "bad_determinism.py"),
                     "--format", "github"]) == 1
    out = capsys.readouterr().out
    assert "::error file=tests/fixtures/analysis/bad_determinism.py," \
        in out
    assert "title=RL101" in out
    assert cli_main([str(TORCH_FIXTURES / "bad_wrapper.cu"),
                     "--format", "github"]) == 1
    out = capsys.readouterr().out
    assert "::error file=tests/fixtures/analysis_torch/bad_wrapper.cu," \
        "line=9,title=RL205::" in out


def test_cli_write_then_use_baseline(tmp_path):
    bad = str(FIXTURES / "bad_determinism.py")
    bl = tmp_path / "accepted.json"
    assert cli_main([bad, "--baseline", str(bl),
                     "--write-baseline"]) == 0
    assert cli_main([bad, "--baseline", str(bl)]) == 0
    assert cli_main([str(FIXTURES / "bad_effects.py"),
                     "--baseline", str(bl)]) == 1


def test_baselines_are_apart():
    """Neither suite's default baseline suppresses the other's
    findings; the sweep is clean, so none is committed."""
    assert BASELINE_NAME == "analysis_baseline_torch.json" \
        != JR.BASELINE_NAME
    assert not (ROOT / BASELINE_NAME).exists()


@pytest.mark.parametrize("op", KB.OPS)
def test_op_signature_rule_is_jax(op):
    """The port's check_op_signature gives JAX's verdict on the surface
    function and on four drifts of it."""
    assert KB.OP_SURFACE == JKB.OP_SURFACE
    pos, kws = KB.OP_SURFACE[op]
    src = [", ".join(pos) + (", *, " + ", ".join(f"{k}=0" for k in kws)
                             if kws else ""),
           ", ".join(("renamed_",) + pos[1:]),
           ", ".join(pos + ("extra",)),
           ", ".join(pos + ("extra=None",)) + (
               ", *, " + ", ".join(f"{k}=0" for k in kws) if kws else ""),
           ", ".join(pos) + ", *, strict"]
    for params in src:
        fn = eval(f"lambda {params}: None")
        assert KB.check_op_signature(op, fn) == \
            JKB.check_op_signature(op, fn), params
    assert KB.check_op_signature(op, getattr(KB, op)) is None


# ------------------------------------------------------------ repo gate ----

def test_repo_sweep_is_clean_but_the_nvcc_lookup():
    findings = run_repo()
    unsuppressed = [f for f in findings if not f.suppressed]
    assert unsuppressed == [], "\n".join(f.render() for f in unsuppressed)
    assert [(f.rule, f.path, f.suppressed) for f in findings] == \
        [("RL103", "src/repro_torch/kernels/_build.py", "inline")]
    line = (ROOT / findings[0].path).read_text().splitlines()[
        findings[0].line - 1]
    assert 'os.environ.get("CUDA_HOME"' in line
    assert repo_root() == ROOT


def test_cli_sweep_exit_codes(capsys):
    assert cli_main([]) == 0
    assert cli_main(["--fail-on", "warning"]) == 0
    out = capsys.readouterr().out
    assert "0 error(s), 0 warning(s), 1 suppressed" in out


def test_module_entry_point(tmp_path):
    """``python -m repro_torch.analysis`` from any directory: exit 0 on
    the tree, also at ``--fail-on warning``; the report's last line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for extra in ([], ["--fail-on", "warning"]):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *extra],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr
        assert res.stdout.splitlines()[-1] == \
            "0 error(s), 0 warning(s), 1 suppressed"


def test_backend_registry_check_is_clean():
    assert analyze_backend_registry(PKG / "kernels") == []


def test_every_entry_site_resolves():
    """The twelve _build.entry sites: argtypes evaluated, C signature
    parsed, every call counted; none skipped. Every extern "C" entry of
    csrc/ is one of them."""
    sites = []
    for p in sorted((PKG / "kernels").glob("*.py")):
        sites += entry_sites(p, p.read_text())
    assert len(sites) == N_ENTRIES
    assert [s.symbol for s in sites if not s.resolved] == []
    for s in sites:
        assert len(s.argtypes) == len(s.c_entry.params)
        assert {n for _, n in s.calls} == {len(s.argtypes)}
    c_syms = sorted((cu.stem, e.symbol)
                    for cu in (PKG / "csrc").glob("*.cu")
                    for e in c_entries(cu.read_text()))
    assert c_syms == sorted((s.source, s.symbol) for s in sites)
    assert {s.symbol for s in sites} == {
        f"{k.__name__}_{'bf16' if k.__name__.startswith('flash') else 'f32'}"
        for k in KB.KERNELS}


# ------------------------------------------------------------ mutations ----

@pytest.fixture
def tree(tmp_path):
    """A copy of kernels/ and csrc/ under tmp/src/repro_torch/."""
    dst = tmp_path / "src" / "repro_torch"
    for d in ("kernels", "csrc"):
        shutil.copytree(PKG / d, dst / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _edit(path: Path, old: str, new: str) -> int:
    """Replace ``old`` once; the 1-based line where it started."""
    text = path.read_text()
    at = text.index(old)
    path.write_text(text[:at] + new + text[at + len(old):])
    return text.count("\n", 0, at) + 1


def _line_of(path: Path, needle: str) -> int:
    return next(i for i, ln in enumerate(path.read_text().splitlines(), 1)
                if needle in ln)


def _kernels(tree):
    return tree / "src" / "repro_torch" / "kernels"


def _csrc(tree):
    return tree / "src" / "repro_torch" / "csrc"


def test_mutation_orphan_kernel_module(tree):
    k = _kernels(tree)
    (k / "orphan.py").write_text("def orphan_kernel():\n    pass\n")
    last_import = max(i for i, ln in enumerate(
        (k / "backend.py").read_text().splitlines(), 1)
        if ln.startswith("from repro_torch.kernels"))
    findings = analyze_backend_registry(k)
    assert [(f.rule, f.line) for f in findings] == [("RL302", last_import)]
    assert "'orphan'" in findings[0].message


def test_mutation_orphan_cuda_source(tree):
    cu = _csrc(tree) / "orphan.cu"
    cu.write_text('extern "C" int orphan_f32(int n) { return 0; }\n')
    findings = analyze_backend_registry(_kernels(tree))
    assert [(f.rule, Path(f.path).name, f.line) for f in findings] == \
        [("RL302", "orphan.cu", 1)]


def test_mutation_drifted_op_signature(tree):
    b = _kernels(tree) / "backend.py"
    line = _edit(b, "def router_topk(logits, k):",
                 "def router_topk(scores, k):")
    findings = analyze_backend_registry(_kernels(tree))
    assert [(f.rule, f.line) for f in findings] == [("RL301", line)]
    assert "'router_topk'" in findings[0].message


def test_mutation_dropped_op(tree):
    b = _kernels(tree) / "backend.py"
    key = _line_of(b, '"verify_attention": ')
    _edit(b, "def verify_attention(", "def verify_attention_gone(")
    findings = analyze_backend_registry(_kernels(tree))
    assert [(f.rule, f.line) for f in findings] == [("RL303", key)]
    assert "'verify_attention'" in findings[0].message


def test_mutation_kernel_without_launch_counter(tree):
    b = _kernels(tree) / "backend.py"
    line = _line_of(b, "KERNELS = (")
    b.write_text(b.read_text() + "\n\ndef uncounted():\n    pass\n\n\n"
                 "KERNELS = KERNELS + (uncounted,)\n")
    findings = analyze_backend_registry(_kernels(tree))
    assert [(f.rule, f.line) for f in findings] == [("RL303", line)]
    assert "'uncounted'" in findings[0].message


def test_mutation_registry_fails_to_import(tree):
    b = _kernels(tree) / "backend.py"
    b.write_text(b.read_text() + "\nraise ImportError('seeded')\n")
    findings = analyze_backend_registry(_kernels(tree))
    assert [(f.rule, f.line) for f in findings] == [("RL303", 1)]
    assert "seeded" in findings[0].message


def _contract_findings(tree, path):
    return run_paths([path], root=tree)


def test_mutation_argtypes_one_short(tree):
    w = _kernels(tree) / "flash_decode.py"
    line = _line_of(w, "_ARGTYPES = (")
    _edit(w, "+ [ctypes.c_float] * 2 + [ctypes.c_void_p])",
          "+ [ctypes.c_float] * 1 + [ctypes.c_void_p])")
    findings = _contract_findings(tree, w)
    assert [(f.rule, f.line) for f in findings] == [
        ("RL203", line), ("RL203", _line_of(w, "rc = fn("))]
    assert "declare 12 arguments; flash_decode.cu:" in findings[0].message
    assert "takes 13" in findings[0].message
    assert "called with 13 positional arguments" in findings[1].message


def test_mutation_c_int_for_a_float(tree):
    w = _kernels(tree) / "flash_decode.py"
    line = _line_of(w, "_ARGTYPES = (")
    _edit(w, "[ctypes.c_int] * 5\n             + [ctypes.c_float] * 2",
          "[ctypes.c_int] * 6\n             + [ctypes.c_float] * 1")
    findings = _contract_findings(tree, w)
    assert [(f.rule, f.line) for f in findings] == [("RL203", line)]
    assert "argument 10 is ctypes.c_int for C 'float cap'" in \
        findings[0].message


def test_mutation_call_with_an_extra_argument(tree):
    w = _kernels(tree) / "ssm_scan.py"
    line = _line_of(w, "rc = fn(*(t.data_ptr()")
    _edit(w, "+ grads + scratch), Bsz, S, di, n, stream)",
          "+ grads + scratch), Bsz, S, di, n, 0, stream)")
    findings = _contract_findings(tree, w)
    assert [(f.rule, f.line) for f in findings] == [("RL203", line)]
    assert findings[0].message == "entry 'ssm_scan_bwd_f32' called with " \
        "24 positional arguments; argtypes _BWD_ARGTYPES declare 23"


def test_mutation_undeclared_extern_c(tree):
    cu = _csrc(tree) / "flash_decode.cu"
    n = len(cu.read_text().splitlines())
    cu.write_text(cu.read_text() + '\nextern "C" int flash_decode_f16('
                  "const void* q, int B,\n    void* stream) {\n"
                  "  return 0;\n}\n")
    findings = _contract_findings(tree, cu)
    assert [(f.rule, f.line) for f in findings] == [("RL203", n + 2)]
    assert "'flash_decode_f16'" in findings[0].message


def test_mutation_half_exponent(tree):
    cuh = _csrc(tree) / "decode_warp.cuh"
    n = len(cuh.read_text().splitlines())
    cuh.write_text(cuh.read_text() + "\n__device__ __half2 e2(__half2 s) "
                   "{ return h2exp(s); }\n")
    findings = _contract_findings(tree, cuh)
    assert [(f.rule, f.line) for f in findings] == [("RL205", n + 2)]
    # suppressed inline with its reason, as the fixture shows
    text = cuh.read_text().rstrip("\n")
    cuh.write_text(text + "  // repro-lint: disable=RL205\n")
    findings = _contract_findings(tree, cuh)
    assert [f.suppressed for f in findings] == ["inline"]


def test_mutated_tree_is_clean_unmutated(tree):
    """The copy itself: no finding but the suppressed one, so each
    mutation above is the only cause of its finding."""
    k, c = _kernels(tree), _csrc(tree)
    findings = run_paths([k, c], root=tree)
    assert [(f.rule, f.suppressed) for f in findings] == \
        [("RL103", "inline")]
    assert analyze_backend_registry(k) == []
