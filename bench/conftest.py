"""A copy of the benchmark's files at a size the CPU runs in a second."""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TINY = {"num_nodes": 20, "entries": 400}


def shrink(path: Path) -> None:
    """Cut the configuration file ``path`` to its size for the CPU: 20
    sensors and 400 rows, then its own ``cpu`` overrides (which may shrink
    widths, layers and experts too). A run on the card never reads ``cpu``."""
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps({**cfg, **TINY, **cfg.get("cpu", {})}))


@pytest.fixture
def tiny_tree(tmp_path):
    """``(spec, bench_dir)``: BENCHMARK.json and a copy of ``bench/`` whose
    configurations are cut to their CPU size (:func:`shrink`), and whose
    batches hold at most 4 windows."""
    bench = tmp_path / "bench"
    shutil.copytree(REPO / "bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    for f in (bench / "configs").glob("*.json"):
        shrink(f)
    for f in (bench / "traffic").glob("*.json"):
        d = json.loads(f.read_text())
        f.write_text(json.dumps({**d, "batch": min(d["batch"], 4)}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return spec, bench
