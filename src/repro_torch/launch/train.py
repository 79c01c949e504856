"""End-to-end training launcher of the port, on one device or under
``torch.distributed.run``.

Runs the paper's workflow — synthetic data gen → index-batching
preprocessing → GPU-index-batching placement → distributed-index-batching
training — through ``repro_torch.pipeline``, with the JAX package
launcher's flags and defaults: the dataset placement (``--placement``
replicated | partitioned | ondemand, ``--no-halo``), step-granular
checkpoints (``--ckpt-dir``,
``--ckpt-every``) that ``--resume`` continues from mid-epoch, bit for bit;
a crash-durable JSONL history (``--history-out``: one fsynced row per line,
duplicates of a resumed epoch tail dropped); and the feed prefetcher
(``--prefetch-depth``, ``--staleness``, ``--prefetch-chunk``).

It runs the ST-GNN archs (``dcrnn-pems``, ``pgt-dcrnn-pems-all-la``) on
``--device`` (``cuda`` unless the caller asks for ``cpu``; no fallback).
With ``--init-distributed`` it joins the process group that
``torch.distributed.run`` describes in the environment: each process is one
rank, takes card ``LOCAL_RANK`` (or shares a card when the host has fewer
cards than processes), and trains its own per-rank feed; ``--batch`` is the
GLOBAL batch and must divide by the world size.  The collective backend
follows the topology — ``nccl`` when every rank has a card of its own,
``gloo`` when ranks share a card or run on the CPU — and is printed at
start.  Process 0 alone writes checkpoints and the history.  What later
slices bring raises ``NotImplementedError`` naming its ``ROADMAP.md`` item:
the LM archs and ``--smoke``; the elastic flags.  Two differences from the
JAX launcher: ``--tuning-dir`` defaults to the port's own cache directory
(``build/tuning``, never ``results/``), and ``--log-every`` sets the
history's step-row cadence (the JAX launcher fixes it at 10, the default
here).

Examples:
  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --init-distributed --device cpu \\
      --arch dcrnn-pems --nodes 9 --entries 300 --batch 8 --placement ondemand
  python -m repro_torch.launch.train --arch dcrnn-pems --entries 100 \\
      --batch 8 --gather pallas --ckpt-dir /tmp/ck --ckpt-every 2 \\
      --history-out /tmp/h.jsonl
  python -m repro_torch.launch.train --arch dcrnn-pems --nodes 9 \\
      --entries 120 --batch 4 --device cpu --ckpt-dir /tmp/ck --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import Placement, WindowSpec
from repro_torch.core.distributed import dp_size, init_from_env, process_info
from repro_torch.data import (gaussian_adjacency, make_traffic_series,
                              random_sensor_coords, transition_matrices)
from repro_torch.device import resolve_device
from repro_torch.distributed import latest_step
from repro_torch.kernels.autotune import DEFAULT_CACHE_DIR, autotuning
from repro_torch.models import dcrnn, pgt_dcrnn
from repro_torch.optim import AdamConfig, warmup_cosine
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.train.loop import JsonlHistorySink, TrainLoopConfig

_ELASTIC = ("ROADMAP.md queue 1, item 4b (elastic restarts, heartbeats and "
            "leader succession)")
_LM = "ROADMAP.md queue 1, item 6 (the rest of the LM family and LM training)"

#: flags of later slices: (argparse dest, its default, where it is queued)
_LATER = (
    ("elastic", False, _ELASTIC),
    ("heartbeat", None, _ELASTIC),
    ("heartbeat_timeout", 60.0, _ELASTIC),
    ("elastic_remesh", "inprocess", _ELASTIC),
    ("target_world", 0, _ELASTIC),
    ("plan_out", None, _ELASTIC),
    ("smoke", False, _LM),
)


def _train_stgnn(arch, args, adam, sched, loop: TrainLoopConfig, sink):
    """The pipeline path: the placement's sampler and resident rows, the
    window gather fused into the step."""
    mcfg = arch.model
    if args.nodes:
        mcfg = dataclasses.replace(mcfg, num_nodes=args.nodes)
    t0 = time.perf_counter()
    coords = random_sensor_coords(mcfg.num_nodes, seed=args.seed)
    adj = gaussian_adjacency(coords)
    # C order: the reverse walk comes out of numpy transposed, and the hop
    # kernel would copy a strided support on every call
    supports = tuple(torch.as_tensor(np.ascontiguousarray(s)).to(args.device)
                     for s in transition_matrices(adj))
    series = make_traffic_series(args.entries, mcfg.num_nodes,
                                 mcfg.in_features, seed=args.seed, adjacency=adj)
    print(f"data: {mcfg.num_nodes} nodes, series {series.shape} and graph built "
          f"in {time.perf_counter() - t0:.1f} s")
    spec = WindowSpec(horizon=mcfg.horizon, input_len=mcfg.input_len)

    mod = dcrnn if isinstance(mcfg, dcrnn.DCRNNConfig) else pgt_dcrnn
    params = mod.init(torch.Generator().manual_seed(args.seed), mcfg,
                      device=args.device)

    def loss_fn(p, x, y):
        return mod.loss_fn(p, mcfg, supports, x, y), {}

    # --batch is the GLOBAL batch; the pipeline takes a per-rank size
    dp = dp_size()
    if args.batch % dp:
        raise SystemExit(f"--batch {args.batch} not divisible by "
                         f"data-parallel size {dp}")
    pipe = build_pipeline(
        series, spec, loss_fn, params,
        PipelineConfig(batch_per_rank=args.batch // dp,
                       placement=Placement(args.placement), gather=args.gather,
                       halo=not args.no_halo, seed=args.seed, adam=adam,
                       schedule=sched, loop=loop, device=args.device))
    del series  # only the resident rows stay, on the device
    d = pipe.describe()
    print(f"placement {d['placement'].value}: rank rows {d['resident_rows']} "
          f"({d['resident_bytes']:,} bytes) on {d['device']}, "
          f"{d['sampler']}, world {d['world']}, global batch {d['global_batch']}")
    if args.resume and loop.ckpt_dir:
        step = latest_step(loop.ckpt_dir)
        if step is not None:
            print(f"resuming from step {step}")
    return pipe.fit(resume=args.resume, history_sink=sink)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--entries", type=int, default=2_000)
    ap.add_argument("--nodes", type=int, default=0, help="override graph nodes")
    ap.add_argument("--seq-len", type=int, default=128, help="LM window")
    ap.add_argument("--batch", type=int, default=32, help="global batch")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=0,
                    help="sizes the LR schedule (warmup_cosine over "
                         "max(steps, 100)); the epochs set the run's length")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a cuda request without a "
                         "card raises, there is no fallback")
    ap.add_argument("--smoke", action="store_true", help="reduced LM config")
    ap.add_argument("--placement", default=Placement.REPLICATED.value,
                    choices=[p.value for p in Placement],
                    help="ST-GNN dataset placement: every row on every rank, "
                         "time shards with shard-aligned feeds, or time "
                         "shards with global feeds (rows exchanged each step)")
    ap.add_argument("--gather", default="slice",
                    choices=["slice", "take", "fused", "pallas", "auto"],
                    help="window-gather lowering fused into the train step; "
                         "'pallas' is the CUDA window_gather kernel, 'auto' "
                         "dispatches through the measured tuning cache")
    ap.add_argument("--autotune", default="load", choices=["off", "load", "tune"],
                    help="kernel autotune policy for 'auto' dispatch")
    ap.add_argument("--tuning-dir", default=DEFAULT_CACHE_DIR,
                    help="directory holding TUNING_<backend>.json")
    ap.add_argument("--shuffle", default="global", choices=["global", "local-batch"],
                    help="LM sampler (ST-GNN samplers follow --placement)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=1,
                    help="epoch-end eval cadence over the val split (0 disables)")
    ap.add_argument("--log-every", type=int, default=10,
                    help="history step-row cadence (the JAX launcher's fixed 10)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="feed rows materialized this many chunks ahead on a "
                         "background thread (0 = the synchronous path)")
    ap.add_argument("--staleness", type=int, default=0,
                    help="0: host->device copy at consume, on the step "
                         "thread (bit-identical); s >= 1: the copy for step "
                         "k+s runs on a side stream while step k computes")
    ap.add_argument("--prefetch-chunk", type=int, default=8,
                    help="feed rows per prefetched block")
    ap.add_argument("--no-halo", action="store_true",
                    help="PARTITIONED: keep windows strictly interior to each "
                         "rank's shard, so no rank keeps the next shard's "
                         "first span-1 rows")
    ap.add_argument("--elastic", action="store_true", help="not ported")
    ap.add_argument("--heartbeat", default=None, help="not ported")
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0, help="not ported")
    ap.add_argument("--elastic-remesh", default="inprocess",
                    choices=["inprocess", "relaunch"], help="not ported")
    ap.add_argument("--target-world", type=int, default=0, help="not ported")
    ap.add_argument("--plan-out", default=None, help="not ported")
    ap.add_argument("--init-distributed", action="store_true",
                    help="join the torch.distributed process group described "
                         "by torch.distributed.run's environment; each "
                         "process trains its own per-rank feed")
    ap.add_argument("--history-out", default=None,
                    help="crash-durable history: every logged row appended as "
                         "one JSON line and fsynced as it lands; rows a resume "
                         "re-runs are not written twice.  Process 0 writes it")
    return ap


def main(argv: list[str] | None = None):
    """Parse ``argv`` (default ``sys.argv[1:]``), train, print the closing
    line; returns ``(state, history)``."""
    args = _parser().parse_args(argv)
    for dest, default, item in _LATER:
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: {item}")
    resolve_device(args.device)
    arch = get_arch(args.arch)
    if arch.family != "stgnn":
        raise NotImplementedError(
            f"training the LM arch {arch.id!r} is not ported yet: {_LM}")
    if args.init_distributed:
        device, backend = init_from_env(args.device)
        args.device = str(device)
        rank, size = process_info()
        print(f"torch.distributed: process {rank} of {size}, backend {backend} "
              f"on {device} (per-rank feed selection active)", flush=True)
    try:
        return _run(arch, args)
    finally:
        if args.init_distributed:
            torch.distributed.destroy_process_group()


def _run(arch, args):
    adam = AdamConfig(lr=args.lr)
    total = max(args.steps, 100)

    def sched(s):
        return warmup_cosine(s, base_lr=args.lr, warmup_steps=total // 10,
                             total_steps=total)

    loop = TrainLoopConfig(epochs=args.epochs, log_every=args.log_every,
                           ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                           eval_every=args.eval_every,
                           prefetch_depth=args.prefetch_depth,
                           staleness=args.staleness,
                           prefetch_chunk=args.prefetch_chunk)
    t0 = time.perf_counter()
    # process 0 alone writes the history file
    sink = (JsonlHistorySink(args.history_out)
            if args.history_out and process_info()[0] == 0 else [])
    try:
        with autotuning(mode=args.autotune, cache_dir=args.tuning_dir):
            state, history = _train_stgnn(arch, args, adam, sched, loop, sink)
    finally:
        if isinstance(sink, JsonlHistorySink):
            sink.close()
    wall = time.perf_counter() - t0
    final = [h for h in history if "loss" in h]
    if final:
        print(f"done: {len(final)} logs, wall {wall:.1f}s, "
              f"loss {final[0]['loss']:.4f} -> {final[-1]['loss']:.4f}")
    else:
        print(f"done: nothing to train (resumed past requested epochs), "
              f"wall {wall:.1f}s")
    return state, history


if __name__ == "__main__":
    main()
