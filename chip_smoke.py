#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's ST-GNN main path through its user entry points at the full
width of the registered ``pgt-dcrnn-pems-all-la`` arch (2,716 nodes, 2 input
features, hidden 64, K = 2 hops over 2 supports, 12 in / 12 out):

1. device: card name and power limit; TF32 off for matmuls and cuDNN;
2. build: compiles the hand-written CUDA kernels from ``src/repro_torch``;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   main path gives it (window_gather bit-exact, hop_project within fp32
   tolerance), plus the gather's edge cases;
4. train: ``build_pipeline(..., gather="pallas").fit()`` for 20 steps of 32
   windows, the gather running through the CUDA kernel;
5. forecast: ``evaluate(split="test")`` with ``use_pallas=True`` (every hop
   through the CUDA hop kernel), held against the plain evaluation;
6. times: train step and forecast batch (CUDA events, medians, host
   overhead included) and each kernel's device time (the stream held busy
   while the host enqueues), beside its bound from the H100 datasheet and a
   one-call PyTorch yardstick.

The one cut: the synthetic series has 8,640 entries (30 days of 5-minute
bins) instead of PeMS-All-LA's 105,120; and the train split is cut to the
20 steps' 640 windows.  Weights are random, from a seed.

Prints the kernels' JSON line, then ``{"ok": true, "device": {...}}`` as the
last line; exits non-zero on any failure, and without a card.

Run from the repository root:  python3 chip_smoke.py [--profile]
(``--profile`` adds a torch.profiler breakdown of one train step and one
forecast batch.)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM datasheet peaks (dense, 700 W): HBM3 bandwidth, fp32 on CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

NODES, FEATURES, HIDDEN, K_HOPS, HORIZON = 2_716, 2, 64, 2, 12
ENTRIES = 8_640  # cut from 105,120: 30 days of 5-minute bins
BATCH, TRAIN_STEPS, SEED = 32, 20, 0
HOP_RTOL = HOP_ATOL = 1e-4  # fp32, sums of 2,716 terms in another order
EVAL_RTOL = 1e-4            # MAE through the hop kernel vs the plain hops
SLEEP_CYCLES = 20_000_000   # ~10 ms of device clock: covers the host's enqueueing


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, *, reps: int = 5, inner: int = 1, warmup: int = 1,
              device_only: bool = False) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls.

    ``device_only`` first holds the stream busy (``torch.cuda._sleep``)
    while the host enqueues the timed calls, so the events measure the
    device's time for them and not the host's launch overhead between them.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"nvidia-smi: {smi}")
    log(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    log(f"build: {len(reports)} kernel sources compiled in "
        f"{time.perf_counter() - t0:.1f} s ({', '.join(build.SOURCES)})")
    for name, text in reports.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def graph():
    from repro_torch.data import (gaussian_adjacency, random_sensor_coords,
                                  transition_matrices)

    adj = gaussian_adjacency(random_sensor_coords(NODES, seed=SEED))
    return adj, tuple(torch.as_tensor(s, device="cuda")
                      for s in transition_matrices(adj))


def phase_kernels(supports) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    from repro_torch.kernels.diffusion_conv.kernel import hop_project, hop_project_plain
    from repro_torch.kernels.window_gather.kernel import window_gather
    from repro_torch.kernels.window_gather.ref import window_gather_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    span = 2 * HORIZON
    c = NODES * FEATURES
    series = torch.randn((ENTRIES, c), device="cuda", generator=gen)
    starts = torch.randint(0, ENTRIES - span + 1, (BATCH,), device="cuda",
                           generator=gen, dtype=torch.int32)
    cases = {
        "f32 main path": (series, starts),
        "int32": (torch.randint(-2**31, 2**31 - 1, (ENTRIES, c), device="cuda",
                                generator=gen, dtype=torch.int32), starts),
        "f32 C=130 (8-byte rows)": (series[:, :130].contiguous(), starts),
        "f32 C=7 (4-byte rows)": (series[:, :7].contiguous(), starts),
        "uint8 C=13 (1-byte rows)": (
            torch.randint(0, 255, (ENTRIES, 13), device="cuda", generator=gen,
                          dtype=torch.uint8), starts),
        "out-of-range starts": (series, torch.tensor(
            [-5, 0, ENTRIES - span, ENTRIES - span + 1, ENTRIES + 100, -2**31,
             2**31 - 1], device="cuda", dtype=torch.int32)),
    }
    errs = {}
    for label, (ser, st) in cases.items():
        out = window_gather(ser, st, span=span)
        torch.cuda.synchronize()
        want = window_gather_ref(ser, st, span=span)
        check(torch.equal(out, want),
              f"window_gather {label} differs from its plain version")
        if label == "f32 main path":
            errs["window_gather"] = float((out - want).abs().max())
        log(f"window_gather {label} {tuple(ser.shape)} {ser.dtype}: bit-exact")

    hop_errs = []
    n, cin = NODES, FEATURES + HIDDEN
    s = supports[0]
    for h in (2 * HIDDEN, HIDDEN):
        z = torch.randn((n, BATCH, cin), device="cuda", generator=gen)
        w = torch.randn((cin, h), device="cuda", generator=gen) / cin ** 0.5
        y = torch.randn((n, BATCH, h), device="cuda", generator=gen)
        with torch.no_grad():
            got = hop_project(s, z, w, y)
            torch.cuda.synchronize()
            want = hop_project_plain(s, z, w, y)
        for part, a, b in (("z_next", got[0], want[0]), ("y_next", got[1], want[1])):
            err = float((a - b).abs().max())
            ok = bool(((a - b).abs() <= HOP_ATOL + HOP_RTOL * b.abs()).all())
            log(f"hop_project H={h} {part}: max_abs_err {err:.3e} "
                f"(rtol {HOP_RTOL}, atol {HOP_ATOL}) {'ok' if ok else 'FAIL'}")
            check(ok, f"hop_project H={h} {part} outside tolerance")
            hop_errs.append(err)
    errs["hop_project"] = max(hop_errs)
    return errs


def make_data(adj):
    from repro_torch.data import make_traffic_series

    t0 = time.perf_counter()
    raw = make_traffic_series(ENTRIES, NODES, FEATURES, seed=SEED, adjacency=adj)
    log(f"data: synthetic PeMS-All-LA-shaped series {raw.shape} in "
        f"{time.perf_counter() - t0:.1f} s; CUT: {ENTRIES} entries "
        f"(30 days of 5-minute bins) instead of 105,120")
    return raw


def phase_train(raw, supports):
    from repro_torch.core import IndexDataset, WindowSpec
    from repro_torch.kernels.window_gather.kernel import window_gather
    from repro_torch.models import pgt_dcrnn
    from repro_torch.optim import AdamConfig
    from repro_torch.pipeline import PipelineConfig, build_pipeline
    from repro_torch.train import TrainLoopConfig

    cfg = pgt_dcrnn.PGTDCRNNConfig(num_nodes=NODES, in_features=FEATURES,
                                   out_features=1, hidden=HIDDEN,
                                   max_diffusion_step=K_HOPS,
                                   input_len=HORIZON, horizon=HORIZON)
    spec = WindowSpec(horizon=HORIZON, input_len=HORIZON)
    ds = IndexDataset.from_raw(raw, spec)
    ds = dataclasses.replace(ds, train_windows=ds.train_windows[:TRAIN_STEPS * BATCH])
    log(f"train: {ds.n_windows} windows (train cut to {len(ds.train_windows)} "
        f"= {TRAIN_STEPS} steps of {BATCH}; val {len(ds.val_windows)}, "
        f"test {len(ds.test_windows)})")
    params = pgt_dcrnn.init(torch.Generator().manual_seed(SEED), cfg, device="cuda")

    def loss_fn(p, x, y):
        return pgt_dcrnn.loss_fn(p, cfg, supports, x, y), {}

    pipe = build_pipeline(
        None, spec, loss_fn, params,
        PipelineConfig(batch_per_rank=BATCH, gather="pallas", seed=SEED,
                       device="cuda", adam=AdamConfig(lr=1e-3),
                       loop=TrainLoopConfig(epochs=1, log_every=1)),
        dataset=ds)
    before = window_gather.launches
    t0 = time.perf_counter()
    state, history = pipe.fit(eval_fn=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [r["loss"] for r in history if "epoch_time_s" not in r]
    gathers = window_gather.launches - before
    log(f"train: {len(losses)} steps in {wall:.2f} s (first step included); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; window_gather launches {gathers}")
    check(len(losses) == TRAIN_STEPS, f"expected {TRAIN_STEPS} steps, got {len(losses)}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "training did not lower the loss")
    check(gathers >= TRAIN_STEPS, "train steps did not go through the CUDA gather")
    return cfg, spec, pipe, state


def phase_forecast(cfg, spec, pipe, state, supports):
    from repro_torch.kernels.diffusion_conv.kernel import hop_project
    from repro_torch.models import pgt_dcrnn
    from repro_torch.pipeline import PipelineConfig, build_pipeline

    fcfg = dataclasses.replace(cfg, use_pallas=True)

    def loss_fn(p, x, y):
        return pgt_dcrnn.loss_fn(p, fcfg, supports, x, y), {}

    fpipe = build_pipeline(None, spec, loss_fn, state["params"],
                           PipelineConfig(batch_per_rank=BATCH, gather="pallas",
                                          seed=SEED, device="cuda"),
                           dataset=pipe.dataset)
    rows, tail = fpipe.dataplane.eval_grid("test")
    max_batches = 4
    scored = min(rows.shape[0], max_batches) + int(bool(len(tail)) and rows.shape[0] < max_batches)
    before = hop_project.launches
    t0 = time.perf_counter()
    mae = fpipe.evaluate(state["params"], split="test", max_batches=max_batches)
    wall = time.perf_counter() - t0
    hops = hop_project.launches - before
    per_batch = 2 * 2 * K_HOPS * cfg.input_len
    log(f"forecast: test MAE {mae:.6f} over {scored} batches in {wall:.2f} s; "
        f"hop_project launches {hops} ({per_batch} per batch expected)")
    check(np.isfinite(mae), "non-finite forecast MAE")
    check(hops == per_batch * scored,
          f"hop_project launches {hops} != {per_batch} x {scored} batches")
    return fpipe, mae


def compare_forecast(pipe, state, mae):
    plain = pipe.evaluate(state["params"], split="test", max_batches=4)
    rel = abs(mae - plain) / abs(plain)
    log(f"forecast: plain-hop test MAE {plain:.6f}; relative gap {rel:.3e} "
        f"(rtol {EVAL_RTOL})")
    check(rel <= EVAL_RTOL, "forecast through hop_project disagrees with the plain hops")


def phase_times(pipe, fpipe, state, supports, errs) -> list[dict]:
    from repro_torch.kernels.diffusion_conv.kernel import hop_project, hop_project_plain
    from repro_torch.kernels.window_gather.kernel import window_gather
    from repro_torch.kernels.window_gather.ref import window_gather_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = pipe.dataplane.epoch_global(0)
    batch = pipe.batch_of_starts(rows[0])
    st = {"s": state}

    def step():
        st["s"], _ = pipe.train_step(st["s"], batch)

    step_ms = median_ms(step, reps=5)
    eval_rows, _ = fpipe.dataplane.eval_grid("test")
    ebatch = fpipe.batch_of_starts(eval_rows[0])
    with torch.no_grad():
        fc_ms = median_ms(lambda: fpipe._eval_loss(state["params"], ebatch), reps=5)
        plain_fc_ms = median_ms(lambda: pipe._eval_loss(state["params"], ebatch), reps=5)
    log(f"time: train step {step_ms:.3f} ms (median of 5, batch {BATCH}); "
        f"forecast batch {fc_ms:.3f} ms through hop_project, {plain_fc_ms:.3f} ms "
        f"with plain hops (median of 5)")

    # window_gather at its main-path shape, cycling over 64 batches of starts
    # drawn over the whole series (as full training draws them), so most
    # rows come from device memory and not from L2.
    series = pipe.dataset.series.reshape(pipe.dataset.entries, -1)
    span = 2 * HORIZON
    starts = [torch.randint(0, pipe.dataset.entries - span + 1, (BATCH,),
                            device="cuda", generator=gen, dtype=torch.int32)
              for _ in range(64)]
    it = {"i": 0}

    def cycle(fn):
        def call():
            fn(starts[it["i"] % len(starts)])
            it["i"] += 1
        return call

    offs = torch.arange(span, device="cuda", dtype=torch.int32)
    flat_idx = [(s[:, None] + offs).reshape(-1) for s in starts]
    lib_it = {"i": 0}

    def lib_gather():
        series.index_select(0, flat_idx[lib_it["i"] % len(flat_idx)])
        lib_it["i"] += 1

    g_ms = median_ms(cycle(lambda s: window_gather(series, s, span=span)),
                     inner=20, device_only=True)
    g_plain = median_ms(cycle(lambda s: window_gather_ref(series, s, span=span)),
                        inner=20, device_only=True)
    g_lib = median_ms(lib_gather, inner=20, device_only=True)
    g_bytes = 2 * BATCH * span * series.shape[1] * series.element_size() + BATCH * 4
    g_bound = g_bytes / PEAK_BYTES_PER_S * 1e3

    # hop_project at both main-path shapes (H = 128 for the ru gate, 64 for
    # the c gate: equal launch counts on the path), reported as their mean.
    n, c = NODES, FEATURES + HIDDEN
    s = supports[0]
    h_ms, h_plain, h_lib, h_bound = [], [], [], []
    for h in (2 * HIDDEN, HIDDEN):
        z = torch.randn((n, BATCH, c), device="cuda", generator=gen)
        w = torch.randn((c, h), device="cuda", generator=gen) / c ** 0.5
        y = torch.randn((n, BATCH, h), device="cuda", generator=gen)
        with torch.no_grad():
            h_ms.append(median_ms(lambda: hop_project(s, z, w, y), inner=5,
                                  device_only=True))
            h_plain.append(median_ms(lambda: hop_project_plain(s, z, w, y), inner=5,
                                     device_only=True))
            z2 = z.view(n, BATCH * c)
            h_lib.append(median_ms(lambda: torch.matmul(s, z2), inner=5,
                                   device_only=True))
        flops = 2 * n * n * BATCH * c + 2 * n * BATCH * c * h
        nbytes = 4 * (n * n + 2 * n * BATCH * c + 2 * n * BATCH * h + c * h)
        h_bound.append(max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3)
        log(f"time: hop_project H={h}: {h_ms[-1]:.4f} ms, plain {h_plain[-1]:.4f} ms, "
            f"torch.matmul S@Z {h_lib[-1]:.4f} ms, bound {h_bound[-1]:.4f} ms "
            f"({flops / h_ms[-1] / 1e9:.1f} TFLOP/s)")
    log(f"time: window_gather {g_ms:.4f} ms, plain {g_plain:.4f} ms, "
        f"index_select {g_lib:.4f} ms, bound {g_bound:.4f} ms "
        f"({g_bytes / g_ms / 1e6:.1f} GB/s)")
    mean = statistics.fmean
    return [
        {"name": "window_gather", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/window_gather.cu",
         "replaces": "src/repro/kernels/window_gather/kernel.py:36",
         "launches": None, "max_abs_err": errs["window_gather"],
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": "bytes", "library_ms": g_lib},
        {"name": "hop_project", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hop_project.cu",
         "replaces": "src/repro/kernels/diffusion_conv/kernel.py:58",
         "launches": None, "max_abs_err": errs["hop_project"],
         "ms": mean(h_ms), "plain_ms": mean(h_plain), "bound_ms": mean(h_bound),
         "bound_by": "operations", "library_ms": mean(h_lib)},
    ]


def phase_profile(pipe, fpipe, state) -> None:
    from torch.profiler import ProfilerActivity, profile

    rows = pipe.dataplane.epoch_global(0)
    batch = pipe.batch_of_starts(rows[1])
    eval_rows, _ = fpipe.dataplane.eval_grid("test")
    ebatch = fpipe.batch_of_starts(eval_rows[0])
    for label, fn in (
            ("train step", lambda: pipe.train_step(state, batch)),
            ("forecast batch", lambda: fpipe._eval_loss(state["params"], ebatch))):
        with torch.no_grad() if label == "forecast batch" else torch.enable_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        log(f"profile: {label}")
        log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler breakdown of one train "
                             "step and one forecast batch")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.diffusion_conv.kernel import hop_project
    from repro_torch.kernels.window_gather.kernel import window_gather

    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    adj, supports = graph()
    errs = phase_kernels(supports)
    raw = make_data(adj)

    # The main path: counts from 0, train then forecast, counts read after.
    window_gather.launches = 0
    hop_project.launches = 0
    cfg, spec, pipe, state = phase_train(raw, supports)
    fpipe, mae = phase_forecast(cfg, spec, pipe, state, supports)
    launches = {"window_gather": window_gather.launches,
                "hop_project": hop_project.launches}
    log(f"main path launches: {launches}")
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched on the main path")

    compare_forecast(pipe, state, mae)
    kernels = phase_times(pipe, fpipe, state, supports, errs)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if args.profile:
        phase_profile(pipe, fpipe, state)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
