"""Structure of the port: it imports neither JAX nor the JAX package, builds
no kernel at import, and mirrors the JAX package's module layout."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax_or_repro_imports_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "triton"), (path, name)


def test_layout_mirrors_the_jax_package():
    jax_pkg = ROOT / "src" / "repro"
    for p in PORT.rglob("*.py"):
        rel = p.relative_to(PORT)
        if rel.name in ("__init__.py", "build.py", "threefry.py") or \
                rel.parts[0] in ("device.py", "interop.py", "loops.py", "tracing.py", "tree.py"):
            continue
        assert (jax_pkg / rel).exists(), f"{rel} has no counterpart in src/repro"
    assert sorted(p.name for p in (PORT / "kernels" / "csrc").iterdir()) == \
        ["flash_attention.cu", "hop_gemm.cu", "hop_project.cu", "linear_scan.cu", "mma.cuh",
         "tma.cuh", "window_gather.cu"]
