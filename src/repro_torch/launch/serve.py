"""Serving launcher of the port: replay an arrival trace through the stack.

Drives the serving engine (``repro_torch.serve``): planes of
continuous-batching lanes, batched prefill, per-request deadlines, and
prints what it served.  On one device, or, under ``torch.distributed.run``,
over the host mesh (data over every rank, ``model`` 1, as the JAX launcher's
``make_host_mesh()``): every rank joins the process group and serves its
shards of the same engine, and rank 0 prints the report, ``mesh=`` as the
JAX launcher prints it.  ``--trace batch`` submits everything up front;
``--trace poisson`` replays independent arrivals at ``--rate`` req/s against
the wall clock, so backpressure and deadline expiry fire.

``--block-size`` switches the KV cache to PAGED mode: cache lines come from
a shared pool of fixed-size blocks (``--pool-blocks`` usable blocks; default
= contiguous capacity at block granularity, so size it DOWN to the expected
live tokens for the memory win) and admission accounts blocks, raising clean
backpressure instead of running the device out of memory.
``--temperature`` / ``--top-k`` / ``--top-p`` set the default sampling
contract; draws are request-keyed (``--sample-seed``), so the tokens do not
depend on ``--planes`` or on the cache layout.

``--role`` picks the process's job in an ELASTIC FLEET:

- ``engine`` (default): everything in one process;
- ``fleet``: coordinator; spawns ``--planes`` worker processes
  (re-invoking this module with ``--role worker``), assigns requests over
  file mailboxes, tracks liveness through heartbeats, and re-prefills a
  dead worker's in-flight requests on the survivors;
- ``worker``: one serving process, a single-plane engine pumping the file
  mailboxes under ``--fleet-dir`` and beating ``hb/hb_<id>.json``; it
  writes its pid to ``w<id>_a<attempt>/pid``.

The flags are the JAX launcher's, plus three of the port's own: ``--device``
(``cuda`` unless the caller asks for ``cpu``; no fallback; a fleet's
workers all take that device, so on one card they share ``cuda:0``),
``--smoke`` (the arch's reduced same-family config, float32; the JAX
launcher always serves it, the port serves the registered widths unless
asked) and ``--prompt-lens`` (prompt lengths to draw from; default the JAX
launcher's 4..16 tokens).
Weights are random from ``--seed``, drawn on the device straight into the
compute dtype.

  python -m repro_torch.launch.serve --arch qwen1.5-4b --requests 16 --slots 8 \\
      --max-len 1024 --max-new-tokens 32 --prompt-lens 128,256,512
  python -m repro_torch.launch.serve --block-size 16 --pool-blocks 272 ...
  python -m repro_torch.launch.serve --temperature 0.7 --top-k 50 --top-p 0.9 ...
  python -m repro_torch.launch.serve --role fleet --planes 2 --hb-timeout 15 ...
  python -m repro_torch.launch.serve --smoke --device cpu --requests 6 --slots 4
  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.serve --smoke --device cpu --requests 6 --slots 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.distributed import init_from_env
from repro_torch.device import resolve_device
from repro_torch.distributed.transport import FileHeartbeatTransport
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import model as lm
from repro_torch.serve import (Backpressure, FileMailbox, FleetEngine, ServeConfig,
                               ServeEngine, ServeWorker)


def _serve_config(args: argparse.Namespace) -> ServeConfig:
    # 0 is the argv-safe "off" sentinel for the filters (workers are
    # re-spawned with string argv, so None can't ride through)
    return ServeConfig(slots=args.slots, max_len=args.max_len,
                       max_new_tokens=args.max_new_tokens,
                       temperature=args.temperature,
                       sample_seed=args.sample_seed,
                       top_k=args.top_k or None,
                       top_p=args.top_p or None,
                       block_size=args.block_size or None,
                       pool_blocks=args.pool_blocks or None)


def _model_config(args: argparse.Namespace):
    arch = get_arch(args.arch)
    if arch.lm is None:
        raise SystemExit(f"{args.arch} is not an LM arch")
    return arch.smoke_config() if args.smoke else arch.lm


def _params(args: argparse.Namespace, cfg):
    """Random weights from ``--seed``, drawn on the device leaf by leaf
    straight into the compute dtype (the float32 leaves the layers read stay
    float32): the values ``compute_copy`` would give of a float32 draw."""
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    return lm.init(gen, dataclasses.replace(cfg, param_dtype=cfg.dtype),
                   device=args.device)


def _prompts(args: argparse.Namespace, vocab: int) -> list:
    rng = np.random.default_rng(args.seed)
    if not args.prompt_lens:
        return [rng.integers(0, vocab, size=int(rng.integers(4, 17)))
                for _ in range(args.requests)]
    lens = rng.choice([int(n) for n in args.prompt_lens.split(",")],
                      size=args.requests)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def _report(done: dict, out: dict, wall: float, rejects: int, extra: str) -> None:
    ok = [r for r in done.values() if r.status == "ok"]
    timed_out = sum(1 for r in done.values() if r.status == "timeout")
    truncated = sum(1 for r in done.values() if r.status == "truncated")
    toks = sum(len(r.out) for r in done.values() if r.status != "timeout")
    print(f"served {len(ok)}/{len(done)} requests "
          f"({timed_out} timeout, {truncated} truncated, "
          f"{rejects} backpressure-shed), "
          f"{toks} tokens in {wall:.2f}s ({toks / wall:.1f} tok/s, {extra})",
          flush=True)
    for rid in sorted(out):
        tag = "" if done[rid].status == "ok" else f" [{done[rid].status}]"
        print(f"  req {rid}{tag}: {out[rid][:8]}"
              f"{'...' if len(out[rid]) > 8 else ''}")


# ------------------------------------------------------------ single process
def _join_mesh(args: argparse.Namespace):
    """Under ``torch.distributed.run`` (``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` in the environment): join its process group
    (``core/distributed.init_from_env``: NCCL when every local rank has a
    card, else gloo), take this rank's device, and return the host mesh,
    data over every rank and ``model`` 1, as the JAX launcher serves over
    ``make_host_mesh()``.  Otherwise None: one device."""
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        return None
    dev, _ = init_from_env(args.device)
    args.device = str(dev)
    return make_host_mesh(devices=torch.distributed.get_world_size())


def _run_engine(args: argparse.Namespace) -> dict:
    mesh = _join_mesh(args)
    try:
        return _serve_engine(args, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _serve_engine(args: argparse.Namespace, mesh) -> dict:
    cfg = _model_config(args)
    engine = ServeEngine(_params(args, cfg), cfg, _serve_config(args),
                         planes=args.planes, mesh=mesh, device=args.device)
    prompts = _prompts(args, cfg.vocab)

    rejects = 0
    t0 = time.perf_counter()
    if args.trace == "batch":
        for p in prompts:
            engine.submit(p, deadline_s=args.deadline)
        out = engine.run()
    else:
        rng = np.random.default_rng(args.seed)
        arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
        i = 0
        while i < len(arrivals) or engine.active_lanes() or len(engine.router.queue):
            now = time.perf_counter() - t0
            while i < len(arrivals) and arrivals[i] <= now:
                try:
                    engine.submit(prompts[i], deadline_s=args.deadline)
                    i += 1
                except Backpressure:
                    rejects += 1  # shed; retried on the next tick
                    break
            if not engine.step() and i < len(arrivals):
                time.sleep(0.001)
        out = engine.router.results()
    wall = time.perf_counter() - t0

    plane = engine.planes[0]
    extra = (f"planes={args.planes} slots={args.slots} "
             f"mesh={(plane.mesh or make_host_mesh()).shape} device={plane.device} "
             f"cache={plane.cache_bytes() / 1e6:.1f}MB/plane")
    if args.block_size:
        extra += f" paged[bs={args.block_size} blocks={plane.pool.num_blocks}]"
    if mesh is None or torch.distributed.get_rank() == 0:
        _report(engine.router.done, out, wall, rejects, extra)
    return {"engine": engine, "results": out, "wall": wall, "rejects": rejects}


# ------------------------------------------------------------------- worker
def _run_worker(args: argparse.Namespace) -> None:
    """One serving process of an elastic fleet (see ``ServeWorker``).  It
    beats from before the weights are drawn, so the coordinator's heartbeat
    timeout only has to cover the interpreter's start."""
    hb = FileHeartbeatTransport(os.path.join(args.fleet_dir, "hb"))
    spool = os.path.join(args.fleet_dir, f"w{args.worker_id}_a{args.attempt}")
    os.makedirs(spool, exist_ok=True)
    with open(os.path.join(spool, "pid"), "w") as f:
        f.write(str(os.getpid()))
    starting = threading.Event()

    def beat_while_starting():
        while not starting.is_set():
            hb.emit(args.worker_id, 0)
            time.sleep(0.25)

    beats = threading.Thread(target=beat_while_starting, daemon=True)
    beats.start()
    cfg = _model_config(args)
    worker = ServeWorker(
        _params(args, cfg), cfg, _serve_config(args),
        worker_id=args.worker_id, attempt=args.attempt,
        inbox=FileMailbox(os.path.join(spool, "in")),
        outbox=FileMailbox(os.path.join(spool, "out")),
        heartbeat=hb, device=args.device)
    starting.set()
    beats.join()  # one emitter at a time: run() beats from here on
    worker.run()


# -------------------------------------------------------------- coordinator
def _worker_argv(args: argparse.Namespace, fleet_dir: str, wid: int) -> list[str]:
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--role", "worker",
            "--fleet-dir", fleet_dir, "--worker-id", str(wid),
            "--arch", args.arch, "--slots", str(args.slots),
            "--max-len", str(args.max_len),
            "--max-new-tokens", str(args.max_new_tokens),
            "--temperature", str(args.temperature),
            "--sample-seed", str(args.sample_seed),
            "--top-k", str(args.top_k),
            "--top-p", str(args.top_p),
            "--block-size", str(args.block_size),
            "--pool-blocks", str(args.pool_blocks),
            "--seed", str(args.seed), "--device", args.device]
    if args.smoke:
        argv.append("--smoke")
    return argv


def _run_fleet(args: argparse.Namespace) -> dict:
    """Coordinator: spawn the workers, drive the fleet, shut it down."""
    cfg = _model_config(args)
    fleet_dir = args.fleet_dir or tempfile.mkdtemp(prefix="serve-fleet-")
    hb = FileHeartbeatTransport(os.path.join(fleet_dir, "hb"))
    fleet = FleetEngine(_serve_config(args), world=args.planes,
                        hb_timeout=args.hb_timeout,
                        step_feed=lambda: hb.step_feed(0, args.planes))

    # the workers import this package from the same source tree
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    for wid in range(args.planes):
        spool = os.path.join(fleet_dir, f"w{wid}_a0")
        fleet.attach(wid, attempt=0,
                     send=FileMailbox(os.path.join(spool, "in")),
                     recv=FileMailbox(os.path.join(spool, "out")))
        procs.append(subprocess.Popen(_worker_argv(args, fleet_dir, wid), env=env))
    print(f"# fleet: {args.planes} workers on {args.device}, mailboxes under "
          f"{fleet_dir}", flush=True)

    prompts = _prompts(args, cfg.vocab)
    t0 = time.perf_counter()
    for p in prompts:
        fleet.submit(p, deadline_s=args.deadline)
    dead: dict[int, float] = {}  # worker -> monotonic time its verdict landed
    try:
        while fleet.pending():
            if all(p.poll() is not None for p in procs):
                raise RuntimeError(
                    f"every worker exited with {fleet.pending()} requests pending "
                    f"(exit codes {[p.returncode for p in procs]})")
            fleet.tick()
            for wid, w in fleet.workers.items():
                if not w.live_prev and wid not in dead:
                    dead[wid] = time.monotonic()
                    print(f"# fleet: worker {wid} timed out; its in-flight "
                          f"requests re-queued", flush=True)
            time.sleep(0.02)
    finally:
        fleet.stop_workers()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    served = {wid: w.served for wid, w in fleet.workers.items()}
    _report(fleet.router.done, fleet.results(), wall, 0,
            f"workers={args.planes} slots/worker={args.slots} "
            f"served-per-worker={served}")
    return {"fleet": fleet, "results": fleet.results(), "wall": wall,
            "dead_at": dead, "fleet_dir": fleet_dir,
            "exit_codes": [p.returncode for p in procs]}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--role", choices=("engine", "fleet", "worker"),
                    default="engine",
                    help="engine: in-process planes (default); fleet: spawn "
                         "worker processes and coordinate them; worker: one "
                         "serving process (spawned by --role fleet)")
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode lanes per plane")
    ap.add_argument("--planes", type=int, default=1,
                    help="inference planes (engine: in-process slot pools; "
                         "fleet: worker PROCESSES, one plane each)")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="default sampling temperature (0 = greedy); draws "
                         "are request-keyed, so output is identical across "
                         "--planes counts for the same seeds")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="default per-request base sampling seed")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k largest logits before sampling "
                         "(0 = off)")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling mass in (0, 1] (0 = off)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged-KV block size in tokens (0 = contiguous "
                         "per-slot cache lines)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="usable blocks in the paged pool (0 = contiguous "
                         "capacity, slots*ceil(max_len/block_size); size it "
                         "to expected LIVE tokens for the memory win)")
    ap.add_argument("--trace", choices=("batch", "poisson"), default="batch",
                    help="batch: submit all up front; poisson: timed arrivals")
    ap.add_argument("--rate", type=float, default=30.0,
                    help="poisson arrival rate, requests/second")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds (default: none)")
    ap.add_argument("--fleet-dir", default=None,
                    help="shared mailbox/heartbeat dir for --role "
                         "fleet/worker (fleet default: a fresh tempdir)")
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--attempt", type=int, default=0,
                    help="worker mailbox incarnation (bumped on relaunch)")
    ap.add_argument("--hb-timeout", type=float, default=10.0,
                    help="seconds of beat silence before a worker is "
                         "declared dead and its work re-prefilled")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced same-family config")
    ap.add_argument("--prompt-lens", default="",
                    help="comma-separated prompt lengths to draw from "
                         "(default: 4..16 tokens, as the JAX launcher)")
    return ap


def main(argv: list[str] | None = None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the role.  Returns
    the engine role's ``{"engine", "results", "wall", "rejects"}``, the fleet
    role's ``{"fleet", "results", "wall", "dead_at", "fleet_dir",
    "exit_codes"}``, or None for a worker."""
    args = _parser().parse_args(argv)
    resolve_device(args.device)
    if args.role == "worker":
        if args.fleet_dir is None:
            raise SystemExit("--role worker requires --fleet-dir")
        return _run_worker(args)
    if args.role == "fleet":
        return _run_fleet(args)
    return _run_engine(args)


if __name__ == "__main__":
    main()
