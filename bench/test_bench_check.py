"""The comparison that decides ``correct``, at a size the CPU runs: the
program passes, and the control and each fault the cells can have fail.
The harness's look for a card is skipped: ``run`` is the rest of a run."""
import time

import pytest

from bench import check, faults
from bench.harness import BENCH, Run, load_json, resolve, run
from bench.inputs import leaves

CELLS = [w["name"] for w in load_json(BENCH.parent / "BENCHMARK.json")["workloads"]]
TRAIN = [c for c in CELLS if resolve(c).traffic["mode"] == "train"]
FORECAST = [c for c in CELLS if resolve(c).traffic["mode"] == "forecast"]
SEED = 2 ** 31 + 977  # more than 32 signed bits hold


def _run(tiny_tree, name, seconds=0.2, trace=False):
    spec, bench = tiny_tree
    cell = resolve(name, spec, bench)
    return cell, run(cell, SEED, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", TRAIN + FORECAST)
def test_program_is_correct(tiny_tree, name):
    cell, line = _run(tiny_tree, name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(cell.limits)
    assert {"setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("name", TRAIN + FORECAST)
def test_traced_run_reports_per_layer_metrics(tiny_tree, name):
    cell, line = _run(tiny_tree, name, trace=True)
    assert line["correct"]
    assert "resident_gib" in line["metrics"]
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    # the program's spans are in the trace, so their readers read
    assert {m["name"] for m in cell.per_layer if m["source"] == "program_span"} \
        <= set(line["metrics"])
    assert line["device"]["window_s"] > 0 and "breakdown" in line


@pytest.mark.parametrize("name", TRAIN + FORECAST)
def test_control_is_not_correct(tiny_tree, name):
    """The reference in TF32 in the program's place fails a limit."""
    spec, bench = tiny_tree
    cell = resolve(name, spec, bench)
    r = Run(cell, SEED, "cpu", time.perf_counter())
    inputs = r.make_inputs()
    if cell.traffic["mode"] == "train":
        ids = [inputs.splits["train"][i * 4:(i + 1) * 4] for i in range(3)]
        ref = lambda p: check.reference_train(cell.config, cell.traffic, inputs, ids, "cpu", p)
        numbers = check.train_numbers(ref("tf32"), ref("float32"), leaves(inputs.params))
    else:
        ids = [inputs.splits["test"][i * 4:(i + 1) * 4] for i in range(4)]
        ref = lambda p: check.reference_forecast(cell.config, inputs, ids, "cpu", p)
        numbers = check.forecast_numbers(ref("tf32"), ref("float32"))
    assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["frozen_state", "half_batch", "scaled_gradient"])
def test_train_fault_is_caught(tiny_tree, name, fault):
    spec, bench = tiny_tree
    cell = resolve(name, spec, bench)
    with getattr(faults, fault)():
        line = run(cell, SEED, 0.2, False, "cpu", time.perf_counter())
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", FORECAST)
def test_altered_answer_is_caught(tiny_tree, name):
    spec, bench = tiny_tree
    cell = resolve(name, spec, bench)
    with faults.altered_answer():
        line = run(cell, SEED, 0.2, False, "cpu", time.perf_counter())
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("part", [1, 3])
def test_sub_batched_reference_gives_the_batch_gradient(tiny_tree, name, part):
    """The reference taking ``part`` windows an autograd pass (the last
    part shorter where ``part`` does not divide the batch) gives the whole
    batch's loss, gradient norm, gradient and step to float32 rounding."""
    spec, bench = tiny_tree
    cell = resolve(name, spec, bench)
    inputs = Run(cell, SEED, "cpu", time.perf_counter()).make_inputs()
    ids = [inputs.splits["train"][:4]]
    whole = check.reference_train(cell.config, cell.traffic, inputs, ids, "cpu")
    parts = check.reference_train({**cell.config, "reference_windows": part}, cell.traffic,
                                  inputs, ids, "cpu")
    for got, want in zip(parts["losses"] + parts["grad_norms"],
                         whole["losses"] + whole["grad_norms"]):
        assert got == pytest.approx(want, rel=1e-5)
    for k, want in whole["first_gradient"].items():
        scale = float(want.abs().max())
        assert float((parts["first_gradient"][k] - want).abs().max()) <= 1e-5 * scale, k
    numbers = check.train_numbers(parts, whole, leaves(inputs.params))
    assert all(v < 1e-5 for v in numbers.values()), numbers
