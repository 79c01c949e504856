"""End-to-end training launcher of the port, on one device or as one rank of
a ``torch.distributed`` group.

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

It runs every arch of the registry on ``--device`` (``cuda`` unless the
caller asks for ``cpu``; no fallback): the ST-GNN archs (``dcrnn-pems``,
``pgt-dcrnn-pems-all-la``, and ST-LLM on DeepSeek-V2-Lite's block,
``stllm-ds2lite-pems-all-la``) on a synthetic traffic series and sensor graph,
and the ten LM archs (``--smoke`` for the reduced same-family config) on a
synthetic int32 token stream of ``--entries`` tokens, windows of
``--seq-len`` tokens through the pipeline's ``lm`` gather (labels are the
inputs shifted by one).  ``--shuffle global`` draws global batches over the
whole stream (``REPLICATED``), ``local-batch`` the fixed count-split
partitions over time shards (``PARTITIONED``); each epoch ends with
``val_loss`` and ``val_ppl`` (the perplexity, ``exp(min(val_loss, 30))``).
With ``--init-distributed`` it joins the process group that the environment
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, as ``torch.distributed.run`` sets them):
each process is one rank, takes card ``LOCAL_RANK`` (or shares a card when
the host has fewer cards than processes), and trains its own per-rank feed;
``--batch`` is the GLOBAL batch and must divide by the world size.  The
collective backend follows the topology — ``nccl`` when every rank has a
card of its own, ``gloo`` when ranks share a card or run on the CPU — and is
printed at start.  The leader (process 0 unless a heartbeat transport hands
the role on) writes checkpoints and the history.

``--elastic`` attaches the heartbeat → re-mesh policy (needs
``--ckpt-dir``): worker loss shrinks the world and resumes from the latest
checkpoint instead of ending the run, and a returned worker is grown back
in.  Without ``--heartbeat`` the fleet is simulated all-healthy.
``--heartbeat file:<dir>|tcp://a:p[,b:p,...]`` is a real transport: every
process emits its ranks' beats each step, every process that can collect
polls them, and only the LEADER (the lowest live rank,
``repro_torch.distributed.leader``) acts on a verdict.  One process re-meshes
in place.  A group of processes cannot (a dead peer's rows are gone and its
collectives fail), so under ``--init-distributed`` it takes
``--elastic-remesh relaunch``: on a plan the leader checkpoints, writes the
plan to ``--plan-out`` atomically and exits 75 (EX_TEMPFAIL), and the
external launcher relaunches the fleet into the planned world with the SAME
``--batch`` (``--target-world`` caps a grow).  A peer's death surfaces as a
failed collective: the survivors attribute it from the transport's
snapshot (whose beats went silent), the lowest surviving rank takes over
the leader's duties (it writes its warm-standby checkpoint of the failure
step, the shrink plan and the history rows it buffered) and every survivor
exits 75.  Such a launcher spawns each rank itself (as ``chip_smoke.py`` and
``tests/test_torch_multihost.py`` do) rather than under
``torch.distributed.run``, whose agent stops the surviving workers when one
dies; it also hosts the rendezvous store (``TORCHELASTIC_USE_AGENT_STORE=True``
makes every rank a client), so that rank 0's death does not take the store
with it.  The elastic path's process group times out a collective after
``max(5 × --heartbeat-timeout, 60)`` seconds (torch's default is 30
minutes).

Two differences from the JAX launcher:
``--tuning-dir`` defaults to the port's own cache directory
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
  python -m repro_torch.launch.train --arch dcrnn-pems --nodes 9 \\
      --entries 120 --batch 4 --device cpu --elastic --ckpt-dir /tmp/ck \\
      --heartbeat file:/tmp/hb
  python -m repro_torch.launch.train --arch rwkv6-1.6b --smoke --device cpu \\
      --entries 3000 --seq-len 32 --batch 8 --history-out /tmp/lm.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import IndexDataset, Placement, WindowSpec
from repro_torch.core.distributed import dp_size, init_from_env, process_info
from repro_torch.data import (gaussian_adjacency, make_token_stream,
                              make_traffic_series, random_sensor_coords,
                              transition_matrices)
from repro_torch.device import resolve_device
from repro_torch.distributed import (LeaderHistorySink, LeaderTracker,
                                     checkpoint_meta, latest_step, make_transport)
from repro_torch.distributed.transport import tcp_addresses
from repro_torch.kernels.autotune import DEFAULT_CACHE_DIR, autotuning
from repro_torch.models import dcrnn, pgt_dcrnn, stllm
from repro_torch.models.lm import model as lm
from repro_torch.optim import AdamConfig, warmup_cosine
from repro_torch.pipeline import ElasticConfig, PipelineConfig, build_pipeline
from repro_torch.train.loop import RestartSignal, TrainLoopConfig
from repro_torch.tree import tree_leaves

#: Exit code for "re-mesh requested" in relaunch mode (EX_TEMPFAIL: the run
#: is not broken, it wants to be relaunched into the planned world).
EX_REMESH = 75


def _group_timeout(args) -> datetime.timedelta:
    """How long the elastic path's collectives wait for a peer: long enough
    for any lock-step pause (a first step, an evaluation), short enough that
    a missed failure does not block for torch's default 30 minutes."""
    return datetime.timedelta(seconds=max(5 * args.heartbeat_timeout, 60.0))


def _train_stgnn(arch, args, adam, sched, loop: TrainLoopConfig, sink):
    """The pipeline path: the placement's sampler and resident rows, the
    window gather fused into the step."""
    mcfg = arch.model
    if args.nodes:
        mcfg = dataclasses.replace(mcfg, num_nodes=args.nodes)
    t0 = time.perf_counter()
    coords = random_sensor_coords(mcfg.num_nodes, seed=args.seed)
    adj = gaussian_adjacency(coords)
    series = make_traffic_series(args.entries, mcfg.num_nodes,
                                 mcfg.in_features, seed=args.seed, adjacency=adj)
    print(f"data: {mcfg.num_nodes} nodes, series {series.shape} and graph built "
          f"in {time.perf_counter() - t0:.1f} s")
    spec = WindowSpec(horizon=mcfg.horizon, input_len=mcfg.input_len)

    if isinstance(mcfg, stllm.STLLMConfig):
        # node tokens in node order: no graph operator
        params = stllm.init(torch.Generator().manual_seed(args.seed), mcfg,
                            device=args.device)

        def loss_fn(p, x, y):
            return stllm.loss_fn(p, mcfg, x, y), {}
    else:
        # C order: the reverse walk comes out of numpy transposed, and the
        # hop kernel would copy a strided support on every call
        supports = tuple(torch.as_tensor(np.ascontiguousarray(s)).to(args.device)
                         for s in transition_matrices(adj))
        mod = dcrnn if isinstance(mcfg, dcrnn.DCRNNConfig) else pgt_dcrnn
        params = mod.init(torch.Generator().manual_seed(args.seed), mcfg,
                          device=args.device)

        def loss_fn(p, x, y):
            return mod.loss_fn(p, mcfg, supports, x, y), {}

    pipe = build_pipeline(
        series, spec, loss_fn, params,
        PipelineConfig(batch_per_rank=_batch_per_rank(args),
                       placement=Placement(args.placement), gather=args.gather,
                       halo=not args.no_halo, seed=args.seed, adam=adam,
                       schedule=sched, loop=loop, device=args.device),
        elastic=_elastic_config(args))
    del series  # only the resident rows stay, on the device
    return _fit(pipe, args, loop, sink)


def _train_lm(arch, args, adam, sched, loop: TrainLoopConfig, sink):
    """Token-stream windows (the nodes==1 case) through the same pipeline:
    the ``lm`` gather builds (tokens, shifted labels) on the device."""
    cfg = arch.smoke_config() if args.smoke else arch.lm
    stream = make_token_stream(args.entries, cfg.vocab, seed=args.seed)
    spec = WindowSpec(horizon=1, input_len=args.seq_len)
    ds = IndexDataset.from_raw(stream, spec, scale_feature=None)
    ds = dataclasses.replace(ds, series=stream)  # tokens: no standardisation
    t0 = time.perf_counter()
    params = lm.init(torch.Generator().manual_seed(args.seed), cfg, device=args.device)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {arch.id}{' (smoke config)' if args.smoke else ''}, "
          f"{cfg.layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{n:,} parameters ({cfg.param_dtype}; compute {cfg.dtype}) drawn in "
          f"{time.perf_counter() - t0:.1f} s; stream of {args.entries:,} tokens, "
          f"windows of {args.seq_len}", flush=True)

    def loss_fn(p, toks, labels):
        return lm.loss_fn(p, cfg, toks, labels)

    # --shuffle selects the sampler through the placement: global draws over
    # the replicated stream, or the fixed count-split partitions (local batch
    # shuffling) over a time-sharded stream.
    placement = (Placement.REPLICATED if args.shuffle == "global"
                 else Placement.PARTITIONED)
    pipe = build_pipeline(
        stream, spec, loss_fn, params,
        PipelineConfig(batch_per_rank=_batch_per_rank(args), placement=placement,
                       partition="count", gather="lm", seed=args.seed,
                       adam=adam, schedule=sched, loop=loop, device=args.device),
        dataset=ds, elastic=_elastic_config(args))

    # Held-out evaluation through the same eval feeds as the ST-GNN path: the
    # mean token cross-entropy of the val split and its perplexity.
    eval_fn = None
    if len(ds.val_windows) > 0:
        def eval_fn(st):
            val_loss = pipe.evaluate(st["params"], split="val")
            return {"val_loss": val_loss,
                    "val_ppl": float(np.exp(np.minimum(val_loss, 30.0)))}
    return _fit(pipe, args, loop, sink, eval_fn=eval_fn)


def _batch_per_rank(args) -> int:
    """--batch is the GLOBAL batch; the pipeline takes a per-rank size."""
    dp = dp_size()
    if args.batch % dp:
        raise SystemExit(f"--batch {args.batch} not divisible by "
                         f"data-parallel size {dp}")
    return args.batch // dp


def _fit(pipe, args, loop: TrainLoopConfig, sink, eval_fn="auto"):
    """Report the placement, wire the heartbeat, fit; a failed collective
    under a process group goes to leader succession."""
    d = pipe.describe()
    print(f"placement {d['placement'].value}: rank rows {d['resident_rows']} "
          f"({d['resident_bytes']:,} bytes) on {d['device']}, "
          f"{d['sampler']}, world {d['world']}, global batch {d['global_batch']}")
    if args.resume and loop.ckpt_dir:
        step = latest_step(loop.ckpt_dir)
        if step is not None:
            print(f"resuming from step {step}", flush=True)
    transport = _wire_heartbeat(pipe, args, sink)
    try:
        return pipe.fit(resume=args.resume, eval_fn=eval_fn, history_sink=sink)
    except RuntimeError as err:  # what a collective raises when a peer is gone
        if transport is not None and pipe.dataplane.processes > 1:
            _succeed(pipe, transport, args, sink, err)  # exits 75 if a peer went silent
        raise
    finally:
        if transport is not None:
            transport.close()


def _elastic_config(args) -> ElasticConfig | None:
    if not args.elastic:
        return None
    return ElasticConfig(heartbeat_timeout=args.heartbeat_timeout,
                         remesh=args.elastic_remesh,
                         target_world=args.target_world or None)


def _wire_heartbeat(pipe, args, sink):
    """Attach a real transport to an elastic pipeline: every process emits
    beats for the feed ranks it owns; every process that CAN collect polls
    them, but only the current LEADER — the lowest live rank, tracked by a
    ``LeaderTracker`` over the same beat stream — acts on a verdict.  One
    decider at a time, yet the role survives the death of process 0: the
    successor's monitor state is already primed when it takes over.
    Returns the transport (the caller closes it) or None."""
    if not args.heartbeat or pipe.elastic is None:
        return None
    process = pipe.dataplane.process
    addrs = tcp_addresses(args.heartbeat)
    if addrs is not None:
        # Address k of the failover list is served by process k; processes
        # beyond the list emit only, so the list's length bounds the
        # succession depth.
        serve = process < len(addrs)
        transport = make_transport(args.heartbeat, serve=serve, serve_index=process)
    else:
        serve = True  # the file transport is symmetric: every process polls
        transport = make_transport(args.heartbeat)

    def emitter(step: int) -> None:
        # Re-read the world every step: an in-process re-mesh changes it,
        # and beating for a rank outside the world reads as a returned one.
        ranks = pipe.dataplane.process_ranks
        for r in (ranks if ranks is not None else range(pipe.world)):
            transport.emit(r, step)

    tracker = None
    if serve:
        # Only collecting processes can lead (a process that polls nothing
        # would decide on the simulated all-healthy feed).  The rest keep
        # the process-0 gate — false for them — and never buffer history
        # rows they could not flush.
        tracker = LeaderTracker(pipe.world, timeout=args.heartbeat_timeout)
        ranks = pipe.dataplane.process_ranks
        tracker.bind(ranks if ranks is not None else range(pipe.world))
        if isinstance(sink, LeaderHistorySink):
            sink.bind(tracker.is_leader, buffer_standby=True)
    pipe.elastic = dataclasses.replace(
        pipe.elastic, emitter=emitter, leader=tracker,
        step_feed=(transport.step_feed if serve and hasattr(transport, "step_feed")
                   else pipe.elastic.step_feed))
    return transport


def _succeed(pipe, transport, args, sink, err: RuntimeError):
    """A collective failed under a process group: a peer is gone.  Attribute
    the death through the transport (whose beats went silent, waiting up to
    four heartbeat timeouts for a stale peer to age past the timeout), run
    leader succession — if the dead peer was the leader, the lowest
    surviving rank takes over: it writes its warm-standby checkpoint of the
    failure step, decides the shrink plan and lands its buffered history
    rows — and exit 75 for the external launcher to relaunch the survivors.  Returns
    when no peer went silent: the failure is not a peer's death."""
    ranks = pipe.dataplane.process_ranks or []
    others = [r for r in range(pipe.world) if r not in ranks]
    t0 = time.monotonic()
    while True:
        snap = transport.snapshot()
        dead = [r for r in others
                if r not in snap or snap[r]["age"] > args.heartbeat_timeout]
        if dead:
            break
        if time.monotonic() - t0 > 4 * args.heartbeat_timeout:
            return
        time.sleep(min(0.1, args.heartbeat_timeout / 20))
    print(f"peer failure ({type(err).__name__}: {str(err)[:200]}); ranks "
          f"{dead} silent, attributed in {time.monotonic() - t0:.3f} s", flush=True)
    succession = pipe.succeed_as_leader(dead)
    flushed = sink.flush_as_leader() if isinstance(sink, LeaderHistorySink) else 0
    if succession is not None:
        step = succession["ckpt_step"]
        if step is None:
            step = latest_step(args.ckpt_dir)
        meta = checkpoint_meta(args.ckpt_dir, step=step) if step is not None else {}
        print(f"leader {succession['leader']}: checkpoint of step {step} "
              f"{'written on takeover' if succession['ckpt_step'] is not None else 'on disk'}"
              f", {flushed} buffered history rows landed", flush=True)
        _write_plan(args, succession["plan"], reason=str(err)[:300],
                    epoch=meta.get("epoch"), step=step)
    raise SystemExit(EX_REMESH)


def _write_plan(args, plan, *, reason: str, epoch, step) -> None:
    """Relaunch mode: persist the re-mesh plan for the external launcher,
    written atomically so it can never read a torn plan.  The caller is the
    leader: the decider and checkpoint writer, whose (epoch, step) match the
    durable checkpoint."""
    out = {
        "kind": plan.kind if plan is not None else "unknown",
        "reason": str(plan.reason) if plan is not None else reason,
        "dropped_workers": list(plan.dropped_workers) if plan else [],
        "readmitted_workers": list(plan.readmitted_workers) if plan else [],
        "mesh_shape": list(plan.mesh_shape) if plan else [],
        "decided_by": plan.decided_by if plan else None,
        "epoch": epoch, "step": step,
    }
    payload = json.dumps(out, indent=1)
    if args.plan_out:
        fd, tmp = tempfile.mkstemp(prefix=".plan-",
                                   dir=os.path.dirname(args.plan_out) or ".")
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, args.plan_out)
    print(f"re-mesh requested (exit {EX_REMESH}): {payload}", flush=True)


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
    ap.add_argument("--elastic", action="store_true",
                    help="attach the heartbeat -> plan_remesh -> re-mesh-and-"
                         "resume policy (needs --ckpt-dir).  Without "
                         "--heartbeat the fleet is simulated all-healthy")
    ap.add_argument("--heartbeat", default=None,
                    help="real heartbeat transport: file:<shared-dir> (the "
                         "processes of one host; every process polls) or "
                         "tcp://a:p[,b:p,...], an ordered failover list in "
                         "leader-succession order (process k binds address "
                         "k; collectors mirror beats to each other)")
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0,
                    help="seconds without a beat before a worker is dead")
    ap.add_argument("--elastic-remesh", default="inprocess",
                    choices=["inprocess", "relaunch"],
                    help="who executes a re-mesh plan: this process (one "
                         "process only) or an external launcher: the leader then "
                         f"checkpoints, writes --plan-out and exits {EX_REMESH}")
    ap.add_argument("--target-world", type=int, default=0,
                    help="grow ceiling: re-admit returned workers up to this "
                         "world.  0 = the world THIS process started with — "
                         "after a relaunch that is the shrunk world, so a "
                         "relaunching controller passes the original size")
    ap.add_argument("--plan-out", default=None,
                    help="relaunch mode: path of the re-mesh plan JSON")
    ap.add_argument("--init-distributed", action="store_true",
                    help="join the torch.distributed process group described "
                         "by the environment (RANK, WORLD_SIZE, LOCAL_RANK, "
                         "MASTER_ADDR, MASTER_PORT); each process trains its "
                         "own per-rank feed")
    ap.add_argument("--history-out", default=None,
                    help="crash-durable history: every logged row appended as "
                         "one JSON line and fsynced as it lands; rows a resume "
                         "re-runs are not written twice.  The leader writes it")
    return ap


def main(argv: list[str] | None = None):
    """Parse ``argv`` (default ``sys.argv[1:]``), train, print the closing
    line; returns ``(state, history)``."""
    args = _parser().parse_args(argv)
    if args.heartbeat and not args.elastic:
        # Ignoring the transport would leave the operator believing health
        # monitoring is on when nothing emits or collects beats.
        raise SystemExit("--heartbeat requires --elastic: the transport only "
                         "feeds the elastic heartbeat monitor")
    if args.init_distributed and args.elastic and args.elastic_remesh != "relaunch":
        # The in-process re-mesh places the whole series again, which only
        # one process holds.
        raise SystemExit("--elastic with --init-distributed needs "
                         "--elastic-remesh relaunch: a fleet re-meshes by "
                         "relaunching into the planned world")
    if args.elastic and args.elastic_remesh == "relaunch" and not args.target_world:
        print("warning: --elastic-remesh relaunch without --target-world — "
              "growth is capped at this process's starting world; a "
              "relaunching controller should pass the original fleet size", flush=True)
    resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.init_distributed:
        device, backend = init_from_env(
            args.device, timeout=_group_timeout(args) if args.elastic else None)
        args.device = str(device)
        rank, size = process_info()
        print(f"torch.distributed: process {rank} of {size}, backend {backend} "
              f"on {device} (per-rank feed selection active)", flush=True)
    # No collective on a failure path (a peer may be gone): only a run that
    # returns destroys its group; an exception leaves it to the exit.
    out = _run(arch, args)
    if args.init_distributed:
        torch.distributed.destroy_process_group()
    return out


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
    # Every process carries the leader-gated sink: the leader's rows land
    # durably; a standby buffers only once _wire_heartbeat binds it to a
    # succession tracker (without one it could never flush).
    sink = (LeaderHistorySink(args.history_out, lambda: process_info()[0] == 0,
                              buffer_standby=False)
            if args.history_out else [])
    try:
        with autotuning(mode=args.autotune, cache_dir=args.tuning_dir):
            train = _train_stgnn if arch.family == "stgnn" else _train_lm
            state, history = train(arch, args, adam, sched, loop, sink)
    except RestartSignal as sig:
        # relaunch mode: the state is checkpointed with its (epoch,
        # done_in_epoch) coordinates; the leader hands the plan to the external launcher
        if getattr(sig, "leader", process_info()[0] == 0):
            _write_plan(args, sig.plan, reason=str(sig), epoch=sig.epoch,
                        step=sig.step)
        raise SystemExit(EX_REMESH)
    finally:
        if isinstance(sink, LeaderHistorySink):
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
