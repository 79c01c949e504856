#!/usr/bin/env python3
"""The dry-run matrix: every cell of ``launch.specs.all_cells()`` that is not
skipped, at both production meshes (16x16, 2x16x16), one
``python -m repro_torch.launch.dryrun --both-meshes --cell-timeout 240``
process a cell, eight at once.  Prints a line a cell and the count of cells
``ok`` at both meshes; writes the records and a summary under ``--out``.

Usage, from the repository root (on a machine with a card the fake mesh is
CUDA; add ``--device cpu`` on a CPU, where a cell can take minutes):

    python3 tools/dryrun_matrix.py --out build/matrix
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = 8             # processes at once (the card's host has 8 cores)
CELL_TIMEOUT = 240   # seconds a cell may run at one mesh before it is recorded as failed


def run(cell, out, device):
    arch, shape = cell
    path = os.path.join(out, f"{arch}-{shape}.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.time()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--device", device,
                        "--arch", arch, "--shape", shape, "--both-meshes",
                        "--cell-timeout", str(CELL_TIMEOUT), "--out", path], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=4 * CELL_TIMEOUT)
    recs = []
    if os.path.exists(path):
        with open(path) as f:
            recs = json.load(f)
    return {"arch": arch, "shape": shape, "wall": time.time() - t0, "rc": p.returncode,
            "runs": [{"mesh": r.get("mesh"), "status": r["status"],
                      "error": r.get("error", "")[:300]} for r in recs]}


def main() -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.specs import all_cells

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "matrix"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    cells = [(a, s) for a, s, skip in all_cells() if skip is None]
    with ThreadPoolExecutor(JOBS) as pool:
        rows = list(pool.map(lambda c: run(c, args.out, args.device), cells))
    both = [r for r in rows if len(r["runs"]) == 2 and all(x["status"] == "ok" for x in r["runs"])]
    for r in rows:
        print(f"{r['arch']:24s} {r['shape']:14s} {r['wall']:7.1f}s "
              + " ".join(f"{x['mesh']}:{x['status']}" for x in r["runs"])
              + ("" if r in both else "  " + " | ".join(x["error"][:160] for x in r["runs"]
                                                         if x["status"] != "ok")))
    print(f"matrix: {len(both)} of {len(cells)} cells ok at both meshes; wall "
          f"{time.time() - t0:.1f} s")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"rows": rows, "ok_both": len(both), "cells": len(cells)}, f, indent=1)


if __name__ == "__main__":
    main()
