"""BENCHMARK.json against the benchmark's files: every cell and metric
resolves by name, and a cell added as files alone is picked up."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench.conftest import shrink
from bench.harness import BENCH, load_json, resolve

SPEC = load_json(BENCH.parent / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = resolve(cell)
    assert c.config["reference"] and c.traffic["mode"] in ("train", "forecast")
    assert c.limits, "a cell compares at least one number"
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "a cell reports at least one per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]).read)
    assert callable(c.counts().flops)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_has_reader(metric):
    assert (BENCH / "metrics" / f"{metric}.py").is_file()


def test_spec_keeps_to_its_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + CELLS + METRICS
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert Path(c["file"]).parts[0] in SPEC["paths"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_cell_added_as_files_is_picked_up(tiny_tree):
    spec, bench = tiny_tree
    (bench / "traffic" / "train_b2.json").write_text(json.dumps(
        {**load_json(bench / "traffic" / "train_b8.json"), "batch": 2}))
    (bench / "workloads" / "dcrnn-pems.train_b2.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    spec["workloads"].append({"name": "dcrnn-pems.train_b2", "config": "dcrnn-pems",
                              "traffic": "train_b2", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("dcrnn-pems.train_b2")
    cell = resolve("dcrnn-pems.train_b2", spec, bench)
    assert cell.traffic["batch"] == 2 and cell.limits == {"loss_gap": 1.0}
    assert "train_windows_per_s" in {m["name"] for m in cell.end_to_end}


def test_a_model_family_added_as_files_runs(tiny_tree):
    """A configuration of a new model family (its adapter to the port, its
    plain reference and its counts, each a new file) runs through the
    harness with no existing file edited."""
    spec, bench = tiny_tree
    for folder, old, new in (("adapters", "random_walk", "walk_copy"),
                             ("models", "pgt_dcrnn", "pgt_copy"),
                             ("counts", "pgt_dcrnn", "pgt_copy")):
        shutil.copy(bench / folder / f"{old}.py", bench / folder / f"{new}.py")
    config = {**load_json(bench / "configs" / "pgt-dcrnn-pems-all-la.json"),
              "reference": "pgt_copy", "adapter": "walk_copy"}
    (bench / "configs" / "pgt-copy.json").write_text(json.dumps(config))
    (bench / "workloads" / "pgt-copy.train.json").write_text(
        json.dumps(load_json(bench / "workloads" / "pgt-dcrnn-la.train.json")))
    spec["configs"].append({"name": "pgt-copy", "source": "a test",
                            "file": "bench/configs/pgt-copy.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "pgt-copy.train", "config": "pgt-copy",
                              "traffic": "train_b32", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "pgt-dcrnn-la.train" in m.get("workloads", []):
            m["workloads"].append("pgt-copy.train")
    root = bench.parent
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    script = ("import json, sys, time\n"
              "from bench.harness import BENCH, resolve, run\n"
              "cell = resolve('pgt-copy.train')\n"
              "line = run(cell, 5, 0.2, False, 'cpu', time.perf_counter())\n"
              "cell.counts()\n"
              "mods = [sys.modules[m].__file__ for m in ('bench.adapters.walk_copy',"
              " 'bench.models.pgt_copy', 'bench.counts.pgt_copy')]\n"
              "print(json.dumps({'line': line, 'bench': str(BENCH), 'mods': mods}))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(BENCH.parent / "src")])}
    out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bench"] == str(bench)
    assert all(Path(m).parent.parent == bench for m in got["mods"])
    assert got["line"]["correct"], got["line"]["checks"]
    assert "train_windows_per_s" in got["line"]["metrics"]


#: Driven in a process whose ``bench`` package is the copy: a family at an
#: LM's widths, cut to its CPU size, run correct, traced, with its window's
#: counters; its control and three faults; its FLOPs against the counter.
FAMILY_SCRIPT = """
import json, time
import torch
from torch.utils.flop_counter import FlopCounterMode
from bench import check, faults
from bench.harness import Run, resolve, run
from bench.inputs import leaves, make_params
cell = resolve("node-mlp.train")
out = {"line": run(cell, 2 ** 33 + 5, 0.2, False, "cpu", time.perf_counter()),
       "traced": run(cell, 6, 0.2, True, "cpu", time.perf_counter())}
r = Run(cell, 7, "cpu", time.perf_counter())
r.setup()
r.window(0.2)
out["counters"], out["steps"] = r.record.counters, r.record.steps
ids = [r.inputs.splits["train"][i * 4:(i + 1) * 4] for i in range(3)]
ref = lambda p: check.reference_train(cell.config, cell.traffic, r.inputs, ids, "cpu", p)
out["control"] = check.train_numbers(ref("tf32"), ref("float32"), leaves(r.inputs.params))
for fault in ("frozen_state", "half_batch", "scaled_gradient"):
    with getattr(faults, fault)():
        out[fault] = run(cell, 5, 0.2, False, "cpu", time.perf_counter())["correct"]
cfg, model = cell.config, check.reference_model(cell.config)
params = make_params(model.param_specs(cfg), 3, "cpu")
for p in leaves(params).values():
    p.requires_grad_(True)
x = torch.randn(3, cfg["input_len"], cfg["num_nodes"], cfg["in_features"])
y = torch.randn(3, cfg["horizon"], cfg["num_nodes"], cfg["in_features"])
with FlopCounterMode(display=False) as counter:
    model.loss(params, cfg, None, x, y, torch.mm).backward()
out["flops"] = [counter.get_total_flops(), cell.counts().flops(cfg, 3, train=True)]
out["gains"] = [float(params["norm"]["g"].min()), float(params["norm"]["g"].max())]
out["config"] = cfg
print(json.dumps(out))
"""


def test_a_family_at_lm_widths_added_as_files_runs(tiny_tree):
    """The example family (``bench/example_family``: a per-node forecaster
    with no graph operator and no hops, norm gains that start at one, a
    reference that takes one window an autograd pass, an adapter with
    counters) added to a copy of the tree as files alone: its configuration
    states widths the CPU could not hold, and its ``cpu`` size shrinks them."""
    spec, bench = tiny_tree
    family = BENCH / "example_family"
    for f in family.rglob("*.*"):
        shutil.copy(f, bench / f.relative_to(family))
    stated = load_json(family / "configs" / "node-mlp.json")
    assert stated["hidden_size"] >= 16384
    shrink(bench / "configs" / "node-mlp.json")
    spec["configs"].append({"name": "node-mlp", "source": "a test",
                            "file": "bench/configs/node-mlp.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "node-mlp.train", "config": "node-mlp",
                              "traffic": "train_b32", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "pgt-dcrnn-la.train" in m.get("workloads", []):
            m["workloads"].append("node-mlp.train")
    root = bench.parent
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(BENCH.parent / "src")])}
    out = subprocess.run([sys.executable, "-c", FAMILY_SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"]["hidden_size"] == stated["cpu"]["hidden_size"] < 64
    for line in (got["line"], got["traced"]):
        assert line["correct"], line["checks"]
        assert line["attempted"] >= 1 and line["failed"] == 0
    assert "train_windows_per_s" in got["line"]["metrics"]
    assert "hop_gemm_roofline" not in got["traced"]["metrics"]
    assert got["counters"] == {"loss_calls": got["steps"]} and got["steps"] >= 1
    limits = load_json(bench / "workloads" / "node-mlp.train.json")["limits"]
    assert any(got["control"][k] > v for k, v in limits.items()), got["control"]
    assert not any(got[f] for f in ("frozen_state", "half_batch", "scaled_gradient"))
    assert got["flops"][0] == got["flops"][1]
    assert got["gains"] == [1.0, 1.0]
