"""What the benchmark's modules import: nothing of JAX or the JAX package
anywhere, and nothing of the program in the yardstick (the reference, the
counts, the peaks, the metric readers)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
#: The files that may import the program: the system under test's driver
#: and its adapters (``adapters/``), the faults planted in it, and the run's
#: own harness.
PROGRAM_SIDE = {"program.py", "faults.py", "harness.py", "run.py", "calibrate.py"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args:
            arg = node.args[0]
            head = arg.values[0] if isinstance(arg, ast.JoinedStr) else arg
            if isinstance(head, ast.Constant) and isinstance(head.value, str):
                names.add(head.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", [p for p in SOURCES if p.name not in PROGRAM_SIDE
                                  and p.parent.name != "adapters"
                                  and not p.name.startswith(("test_", "conftest"))],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_scan_sees_the_program_side():
    assert "repro_torch" in top_level_imports(BENCH / "program.py")
    assert "repro_torch" in top_level_imports(BENCH / "faults.py")
    assert "repro_torch" in top_level_imports(BENCH / "adapters" / "random_walk.py")
