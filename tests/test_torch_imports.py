"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` load
neither JAX nor anything of the JAX package ``repro``, and importing any
port module builds no kernel (the CPU tests import every module). The
one private PyTorch module the port imports is the fake process group
(``torch.testing._internal.distributed.fake_pg``), and only inside
``launch/mesh.py:fake_mesh``; that it still registers the ``fake``
backend is pinned here."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.serving.engine" in mods and len(mods) >= 20
    assert {"repro_torch.distributed.sharding",
            "repro_torch.distributed.annotate",
            "repro_torch.distributed.parallel", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.profiles", "repro_torch.analysis",
            "repro_torch.analysis.__main__", "repro_torch.analysis.cli",
            "repro_torch.analysis.runner", "repro_torch.analysis.findings",
            "repro_torch.analysis.determinism",
            "repro_torch.analysis.effects_check",
            "repro_torch.analysis.backend_check",
            "repro_torch.analysis.kernel_contracts",
            "repro_torch.launch.quickstart",
            "repro_torch.launch.gating_ablation",
            "repro_torch.launch.serve_copilot"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LIBS\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_sources_import_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)], names


FAKE_PG = "torch.testing._internal.distributed.fake_pg"


def _private_torch_imports(tree):
    """[(module, enclosing function or None)] of every import of a
    private PyTorch module or name (a component starting with '_')."""
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            f = (child.name if isinstance(child, (ast.FunctionDef,
                                                  ast.AsyncFunctionDef))
                 else fn)
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [f"{child.module}.{a.name}" for a in child.names]
            for n in names:
                parts = n.split(".")
                if parts[0] == "torch" and any(p.startswith("_")
                                               for p in parts[1:]):
                    out.append((n, f))
            visit(child, f)
    visit(tree, None)
    return out


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_private_torch_module_but_the_fake_group(path):
    found = _private_torch_imports(ast.parse((ROOT / path).read_text()))
    allowed = [(f"{FAKE_PG}.FakeStore", "fake_mesh")] \
        if path == "src/repro_torch/launch/mesh.py" else []
    assert found == allowed, found


def test_fake_process_group_still_registers_the_fake_backend():
    """launch/mesh.py:fake_mesh imports PyTorch's private fake process
    group; it must still register the "fake" backend (in a subprocess:
    a process group is per-process state)."""
    code = ("import torch.distributed as dist\n"
            f"from {FAKE_PG} import FakeStore\n"
            "dist.init_process_group('fake', store=FakeStore(), rank=0, "
            "world_size=8)\n"
            "assert dist.get_world_size() == 8\n"
            "assert dist.get_backend() == 'fake'\n"
            "dist.destroy_process_group()\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr
