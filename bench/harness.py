"""One run of one cell: set up, measure for ``--seconds``, check, report.

Everything particular to a configuration, a traffic mix, a cell or a metric
is a file that this module finds by the name ``BENCHMARK.json`` gives it:

- ``configs[].file``: the configuration's sizes, naming its plain reference
  (``bench/models/<reference>.py``), its FLOP counts
  (``bench/counts/<reference>.py``) and its adapter to the port
  (``bench/adapters/<adapter>.py``);
- ``bench/traffic/<traffic>.json``: the mix (mode, batch, split, ...);
- ``bench/workloads/<cell>.json``: the limits of the cell's compared numbers;
- ``bench/metrics/<metric>.py``: a reader, ``read(record) -> float | None``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench import check
from bench.inputs import Inputs, batches, gaussian_adjacency, leaves, make_params, \
    make_series, sensor_coords, to_device
from bench.reference import window_split

BENCH = Path(__file__).resolve().parent
#: Top-level module names that may not be loaded in a run's process.
BANNED = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"bench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries of the metrics the cell reports
    per_layer: list
    bench_dir: Path

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py")

    def counts(self):
        return importlib.import_module(f"bench.counts.{self.config['reference']}")


def resolve(name: str, spec: dict | None = None, bench_dir: Path = BENCH) -> Cell:
    """The cell ``name`` of ``spec`` (default: ``BENCHMARK.json`` beside
    ``bench_dir``) with its files read."""
    root = bench_dir.parent
    if spec is None:
        spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    config_file = {c["name"]: c["file"] for c in spec["configs"]}[w["config"]]
    end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, chips=w["chips"], config=load_json(root / config_file),
                traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(bench_dir / "workloads" / f"{name}.json")["limits"],
                end_to_end=end_to_end, per_layer=per_layer, bench_dir=bench_dir)


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers take their numbers from it."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0  # train steps or forecast requests in the window
    latencies_s: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    resident_bytes: int = 0
    spans: dict = dataclasses.field(default_factory=dict)  # span -> host seconds each
    counters: dict = dataclasses.field(default_factory=dict)  # program counter -> change
    trace: object = None  # trace.TraceSummary of a traced run

    @property
    def mode(self) -> str:
        return self.cell.traffic["mode"]

    @property
    def batch(self) -> int:
        return self.cell.traffic["batch"]


class Run:
    """A cell's run in one process: ``setup``, ``window``, ``release``,
    ``check``. ``device`` may be the CPU at tiny sizes (the tests)."""

    def __init__(self, cell: Cell, seed: int, device, t0: float):
        self.cell, self.seed, self.device, self.t0 = cell, seed, torch.device(device), t0
        self.record = Record(cell)
        self.config, self.traffic = cell.config, cell.traffic
        self.outputs: list = []  # forecasts on the host, one per request
        self.requested: list = []  # window ids of each request

    # -------------------------------------------------------------- set-up
    def make_inputs(self) -> Inputs:
        cfg = self.config
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        adjacency = gaussian_adjacency(sensor_coords(cfg["num_nodes"], self.seed), self.device)
        raw = make_series(cfg["entries"], cfg["in_features"], adjacency, self.seed)
        # made on the device, kept on the host: the program places its own copy
        params = to_device(make_params(check.reference_model(cfg).param_specs(cfg), self.seed,
                                       self.device), "cpu")
        splits = window_split(cfg["entries"], cfg["input_len"] + cfg["horizon"])
        return Inputs(adjacency.cpu().numpy(), raw, params, splits)

    def setup(self):
        """Inputs, the program, and the calls that warm it up; a training
        cell's first ``checked_steps`` steps are those the check follows."""
        from bench.program import Program

        t = self.traffic
        self.inputs = self.make_inputs()
        _sync(self.device)
        log(f"inputs made in {time.perf_counter() - self.t0:.1f} s since start")
        if self.device.type == "cuda":
            # the peak is the program's: the benchmark's own input making
            # (graph, series blocks, weights) ends here, and its copy of the
            # initial weights stays on the host
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.program = Program(self.config, t, self.inputs, self.device, self.seed)
        self.record.resident_bytes = self.program.resident_bytes()
        log(f"program set up at {time.perf_counter() - self.t0:.1f} s")
        self.feed = batches(self.inputs.splits[t["split"]], t["batch"], self.seed)
        if t["mode"] == "train":
            self.checked_ids = [next(self.feed) for _ in range(t["checked_steps"])]
            state = self.program.init_state()
            losses, norms = [], []
            for i, ids in enumerate(self.checked_ids):
                state, metrics = self.program.train_step(state, self.program.starts(ids))
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
                if i == 0:
                    first = self.program.first_gradient(state)
            self.checked = {"losses": losses, "grad_norms": norms, "first_gradient": first,
                            "params": {k: v.cpu() for k, v in
                                       leaves(state["params"]).items()}}
            self.state = state
        else:
            for _ in range(t["warmup_requests"]):
                self.program.forecast(self.program.starts(next(self.feed)))
        _sync(self.device)
        self.record.setup_s = time.perf_counter() - self.t0

    # -------------------------------------------------------------- window
    def window(self, seconds: float, tracer=None, requests: int | None = None):
        """Drive the timed path for ``seconds`` (or ``requests`` calls, for
        the calibration); ``tracer`` adds the benchmark's spans."""
        span = _span if tracer is not None else _no_span
        _sync(self.device)
        before = self.program.counters()
        if self.traffic["mode"] == "train":
            self._train_window(seconds, span, requests)
        else:
            self._forecast_window(seconds, span, requests)
        self.record.counters = {k: v - before.get(k, 0)
                                for k, v in self.program.counters().items()}

    def _train_window(self, seconds, span, limit):
        p, rec, log_every = self.program, self.record, self.traffic["log_every"]
        host, losses = [], []
        state = self.state
        self.state = None
        start = time.perf_counter()
        while True:
            ids = next(self.feed)
            t = time.perf_counter()
            with span("train_step"):
                state, metrics = p.train_step(state, p.starts(ids))
            host.append(time.perf_counter() - t)
            rec.steps += 1
            if rec.steps % log_every == 0:
                # read on the host, as train/loop.run_training logs
                with span("loss_read"):
                    losses.append(float(metrics["loss"]))
            if (limit is not None and rec.steps >= limit) or \
                    (limit is None and time.perf_counter() - start >= seconds):
                break
        _sync(self.device)
        rec.window_s = time.perf_counter() - start
        rec.spans["train_step"] = host
        self.failed = sum(not np.isfinite(v) for v in losses)

    def _forecast_window(self, seconds, span, limit):
        p, rec = self.program, self.record
        start = time.perf_counter()
        while True:
            ids = next(self.feed)
            t = time.perf_counter()
            with span("forecast"):
                out = p.forecast(p.starts(ids))
            rec.latencies_s.append(time.perf_counter() - t)
            self.outputs.append(out)
            self.requested.append(ids)
            rec.steps += 1
            if (limit is not None and rec.steps >= limit) or \
                    (limit is None and time.perf_counter() - start >= seconds):
                break
        rec.window_s = time.perf_counter() - start
        self.failed = sum(not bool(torch.isfinite(o).all()) for o in self.outputs)
        ms = sorted(1e3 * v for v in rec.latencies_s)
        log("latency ms: " + ", ".join(f"p{q} {ms[min(len(ms) - 1, len(ms) * q // 100)]:.3f}"
                                       for q in (0, 50, 90, 95, 99, 100)))

    def release(self):
        """Read the peak, then free the program's device state."""
        if self.device.type == "cuda":
            self.record.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        self.program = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def check(self, precision: str = "float32") -> dict:
        """The compared numbers of this run against the reference."""
        cfg, t = self.config, self.traffic
        if t["mode"] == "train":
            want = check.reference_train(cfg, t, self.inputs, self.checked_ids,
                                         self.device, precision)
            start = leaves(self.inputs.params)
            log(f"loss gaps by step {[abs(a - b) / abs(b) for a, b in zip(self.checked['losses'], want['losses'])]}; "
                f"{check.worst_leaves(self.checked, want, start)}")
            return check.train_numbers(self.checked, want, start)
        picked = check.sample(len(self.outputs), t["checked_requests"], self.seed)
        want = check.reference_forecast(cfg, self.inputs,
                                        [self.requested[i] for i in picked], self.device,
                                        precision)
        return check.forecast_numbers([self.outputs[i] for i in picked], want)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _no_span:
    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _span(name):
    from bench.trace import SPAN_PREFIX

    return torch.profiler.record_function(SPAN_PREFIX + name)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run; returns the result line's object."""
    from bench.trace import Tracer

    r = Run(cell, seed, device, t0)
    r.setup()
    if trace:
        with Tracer() as tracer:
            r.window(seconds, tracer=tracer)
        r.record.trace = tracer.summary(r.record.window_s)
        log(r.record.trace.describe_spans())
    else:
        r.window(seconds)
    r.release()
    numbers = r.check()
    limits = cell.limits
    passed = r.failed == 0 and all(numbers[k] <= limits[k] for k in limits)
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        value = cell.reader(m["name"]).read(r.record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if r.device.type == "cuda" else r.device.type,
                   "kind": torch.cuda.get_device_name(r.device) if r.device.type == "cuda"
                   else "cpu",
                   "count": cell.chips, "memory_peak_bytes": r.record.peak_bytes}
    line = {"correct": passed, "attempted": r.record.steps, "failed": r.failed,
            "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = r.record.trace.busy_s
        device_info["window_s"] = r.record.trace.window_s
        line["breakdown"] = r.record.trace.breakdown()
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return line
