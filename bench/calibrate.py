"""The readings that the limits of ``bench/workloads/<cell>.json`` are set
from, at the cell's own size, several seeds in one process (the benchmark's
own runs do not run this):

- ``program``: the program against the reference, as a run checks it (a
  forecast cell over a short window of ``--requests`` requests), with the
  worst leaves of the gradient and of the change, and each step's global
  gradient norms, beside the compared numbers;
- ``control``: the reference in TF32, put in the program's place, against
  the reference in float32 (TF32 off), as the configuration states;
- ``half_batch`` (training cells): the reference with half of each batch
  left out, the mean taken over the rest.

    python3 bench/calibrate.py --workload <name> --seeds 11,12,13 [--requests 16]

Prints one JSON line a reading.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(cell, seed: int, device, requests: int):
    from bench import check, faults
    from bench.harness import Run
    from bench.inputs import leaves

    r = Run(cell, seed, device, time.perf_counter())
    r.setup()
    if cell.traffic["mode"] != "train":
        r.window(0.0, requests=requests)
    r.release()
    if cell.traffic["mode"] == "train":
        ref = lambda precision: check.reference_train(
            cell.config, cell.traffic, r.inputs, r.checked_ids, r.device, precision)
        want = ref("float32")
        start = leaves(r.inputs.params)
        for kind, got in (("program", r.checked), ("control", ref("tf32"))):
            yield kind, {**check.train_numbers(got, want, start),
                         **check.worst_leaves(got, want, start),
                         "grad_norms": got["grad_norms"], "ref_grad_norms": want["grad_norms"]}
        with faults.half_batch_reference(cell.config):
            yield "half_batch", check.train_numbers(ref("float32"), want, start)
    else:
        picked = check.sample(len(r.outputs), cell.traffic["checked_requests"], seed)
        ids = [r.requested[i] for i in picked]
        ref = lambda precision: check.reference_forecast(cell.config, r.inputs, ids,
                                                         r.device, precision)
        want = ref("float32")
        yield "program", check.forecast_numbers([r.outputs[i] for i in picked], want)
        yield "control", check.forecast_numbers(ref("tf32"), want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--requests", type=int, default=16)
    args = ap.parse_args(argv)

    from bench.harness import resolve

    cell = resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for kind, numbers in readings(cell, seed, "cuda:0", args.requests):
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                              **numbers, "s": round(time.perf_counter() - t, 1)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
