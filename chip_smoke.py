#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's thirteen main paths through their user entry points, each at
the full width of a registered arch, with every kernel count set to 0 just
before a path and read just after it:

- the ST-GNN path at ``pgt-dcrnn-pems-all-la`` width (2,716 nodes, 2 input
  features, hidden 64, K = 2 hops over 2 supports, 12 in / 12 out):
  ``build_pipeline(..., gather="pallas").fit()`` for 20 steps of 32 windows
  (the gather through the CUDA ``window_gather``, every hop through the CUDA
  ``hop_gemm``, forward and backward), then
  ``evaluate(split="test")`` with ``use_pallas=True`` (every hop through the
  CUDA ``hop_project``), held against the plain evaluation; then the same
  20 steps through the feed prefetcher (depth 2) at staleness 0 and 1, each
  bit-equal to the synchronous run;
- ``dcrnn-pems`` through the training launcher,
  ``repro_torch.launch.train.main([...])``, at its full width (11,160
  nodes, 2 -> 1 features, hidden 64, 2 + 2 DCGRU layers, K = 2 over 2
  dense supports, 12 in / 12 out), batch 8, ``--gather pallas``,
  checkpoints every 2 steps, a JSONL history and prefetch depth 2: run A
  trains one epoch; a fresh directory holding A's oldest retained mid-epoch
  checkpoint resumes with ``--resume``, and its history rows and final
  checkpoint must equal A's bit for bit; A's final checkpoint then
  forecasts one test batch through ``dcrnn.loss_fn`` with every hop
  through the CUDA ``hop_project`` (384 launches), held against the plain
  hops;
- the serving path at ``recurrentgemma-2b`` width (26 layers as
  8 x (rec, rec, swa) + (rec, rec), d_model 2,560, 10 heads, 1 kv head,
  head_dim 256, d_ff 7,680, vocab 256,000, lru_width 2,560, window 2,048,
  bf16 compute, f32 params; 3.55 B parameters, random from a seed):
  ``ServeEngine(..., ServeConfig(slots=8, max_len=1024, max_new_tokens=32))``
  serves 16 greedy requests with ``use_pallas_scan=True``, every RG-LRU scan
  through the CUDA ``linear_scan`` (18 launches per prefill group and per
  decode step); one prefill group is run again through the plain sequential
  scan (the reference's branch with a cache: bit-equal) and, as a forward,
  through the associative scan (its branch without one: within atol
  0.125), and its RG-LRU scans are timed by the three routes; then
  the same 16 requests through paged planes (block 16, the pool sized to the
  live tokens; recurrentgemma's rec and swa state stays per lane), every odd
  request sampled (temperature 0.7, top-k 50, top-p 0.9): the greedy lanes'
  tokens must equal the contiguous run's, and the scan's launches again 18
  per group and step;
- the keyed sampler on the card: request keys, random bits and uniforms
  bit-equal to the CPU's, and the tokens of [8, 151,936] rows (float32 and
  bf16 logits; greedy, sampled and filtered lanes) equal to the CPU's;
- qwen1.5-4b at full width (40 layers, d_model 2,560, 20 MHA heads of 128,
  vocab 151,936, bf16; weights random from a seed, drawn into bf16) through
  the serving launcher, ``repro_torch.launch.serve.main([...])``, 8 slots,
  max_len 1,024, 16 requests of 32 new tokens: contiguous and paged
  (``--block-size 16 --pool-blocks 272``, the live tokens), greedy and
  sampled on the same seeds; paged tokens must equal contiguous in both
  modes and the paged cache be at most 0.55 of the contiguous one;
- the serving fleet: recurrentgemma-2b's smoke config (float32) at
  temperature 0.7, ``--role fleet --planes 2`` (two worker processes the
  launcher spawns, sharing ``cuda:0``, file mailboxes and heartbeats under
  ``build/``); worker 1 is SIGKILLed once every request it holds has 8
  tokens, the coordinator declares it dead after ``--hb-timeout 15`` and
  re-prefills its requests on worker 0, and every request's tokens must
  equal the launcher's single-engine run at the same seeds; the drill then
  runs again at full width in the arch's bf16, its count of equal requests
  (restored and not) recorded;
- serving over a (data x model) mesh, in a child process with a one-rank
  NCCL group of its own and a 1x1 mesh over it (one card holds one rank:
  NCCL refuses two on one device): qwen1.5-4b at full width, contiguous
  and paged (block 16), and recurrentgemma-2b at full width with
  ``use_pallas_scan=True``, each through ``ServeEngine(mesh=...)`` and
  through the unsharded engine on the same weights (drawn into bf16) and
  the same 8 requests (8 slots, max_len 1,024, 32 new tokens, prompts of
  128, 256 and 512, odd requests sampled): the sharded tokens must equal
  the unsharded ones, the cache leaves must be DTensors of the unsharded
  cache's bytes, and the sharded recurrentgemma-2b run must launch
  ``linear_scan`` on the RG-LRU's local shards (no other kernel on this
  path); it prints each sharded and unsharded decode step ms and peak;
- the measured-dispatch path: ``build_pipeline(..., gather="auto").fit()``
  for 5 steps at the ST-GNN width (its losses equal a ``gather="pallas"``
  run's on the same feed), ``diffusion_conv(impl="auto")`` at the forecast
  shape, ``linear_scan(impl="auto")`` at the decode and prefill shapes and
  ``flash_attention(impl="auto")`` at recurrentgemma-2b's prompt group
  [2, 512, 10 x 256] in bf16.  It runs twice.  First under
  ``set_autotune(mode="tune")`` with a fresh cache: on the card the tuner
  measures the kernel's launch shapes at the power-of-two envelopes, with
  the plain version as the admission oracle only; each verdict's candidate
  table is printed, every verdict must be the kernel and no candidate may
  be rejected.  Then, counts from 0, under a fresh ``mode="load"`` policy:
  every verdict must read back from the cache file, every kernel must be
  launched by the dispatched calls, and each result is held against its
  plain version.

- distributed-index-batching at ``pgt-dcrnn-pems-all-la`` width over
  PeMS-All-LA's uncut series of 105,120 entries (2,284,047,360 bytes): two
  ranks spawned here share ``cuda:0`` over gloo (the backend the topology
  gives: NCCL refuses two ranks on one card) and run
  ``build_pipeline(..., gather="pallas").fit()`` for 5 steps of global
  batch 32, then ``evaluate(split="val")``, under ``REPLICATED``,
  ``PARTITIONED`` with and without halo, and ``ONDEMAND``; each rank holds
  only its placement's resident rows, and per rank and placement the
  phase prints rows and bytes, peak device memory, step ms, exchange bytes
  a step and ``window_gather`` launches.  It fails unless ``ONDEMAND``'s
  losses equal ``REPLICATED``'s bit for bit, every rank's first batch
  equals the plain gather over the full host series at the global starts,
  the ranks' val losses are one number and each time-sharded rank keeps at
  most 0.51 of the series.  Then world 1 over NCCL:
  ``python -m torch.distributed.run --nproc-per-node 1 -m
  repro_torch.launch.train --init-distributed --placement partitioned
  --gather pallas`` at 600 entries.

- elastic training at ``pgt-dcrnn-pems-all-la`` width, global batch 32:
  (a) in one process, ``build_pipeline(..., gather="pallas",
  PipelineConfig(world=4, batch_per_rank=8), elastic=ElasticConfig(...))``
  for 2 epochs of the ST-GNN cut (20 steps an epoch), with a fake clock and
  heartbeat feed in which ranks 1 and 2 go silent at step 6 and announce
  from outside the world at step 12: the restarts must be a shrink to world
  2 (16 a rank) and a grow back to 4 (8 a rank), and losses, val MAE and
  the final state must equal an uninterrupted world-4 run's bit for bit,
  with a peak below the uninterrupted peak plus half the series (the
  re-mesh frees the old series first); it prints each re-mesh's wall ms,
  the median step ms of each world and both peaks.  (b), (c) the launcher
  (``--elastic --elastic-remesh relaunch --heartbeat file:<dir>
  --target-world 2 --ckpt-every 1 --history-out ... --entries 2000``) as
  two ranks that this script spawns (not under ``torch.distributed.run``,
  whose agent stops the survivors) on ``cuda:0`` over gloo, with the
  rendezvous store hosted here: (b) rank 1 is SIGKILLed at its step-5
  beat, rank 0 must exit 75 with a shrink plan dropping [1]; relaunched
  alone with ``--resume`` while an announcer beats rank 1, it must exit 75
  with a grow plan; the relaunched pair must finish with exit 0.  (c) rank
  0, the leader, runs ``--ckpt-every 0`` and is SIGKILLed; rank 1 must take
  over (the takeover checkpoint is then the only one), write the plan and
  exit 75, and a world-1 relaunch must resume from the takeover step and
  finish.  Each cycle's one history file must hold steps 1..n once each.
  It prints the ms from each kill to the survivor's exit and the seconds
  from each relaunch to its first step.

- the §5.5 models (the paper's Table 6 path) over a PeMS-Bay-shaped graph
  (325 nodes, 2 features, the uncut 52,105 entries, batch 32, 12 in / 12
  out): (a) A3T-GCN (hidden 32) for 20 steps at lr 5e-3 through
  ``build_pipeline(..., gather="pallas")`` ("index") and the same 20
  batches of window ids through ``make_train_step`` over every window
  materialised on the card ("base", 3,249,916,800 bytes): losses, final
  parameters and the test MSE of 64 windows must be equal bit for bit; it
  prints each arm's peak memory and step ms (timed in turns) and the bytes
  of the resident series and starts against the materialised windows.
  (b) ST-LLM at ``STLLMConfig``'s width (d_model 256, 6 layers, 8 heads,
  d_ff 1,024; the 325 node tokens through the LM ``backbone``) for 20
  steps at lr 1e-3, then ``evaluate(split="test")``: losses finite, and
  ``embed``, ``lm_head`` and ``tod``, which no loss reads, unchanged.
  (c) ``window_gather`` at [52105, 650]: the vector route (2,600-byte
  rows), bit-exact against its plain version, timed in turns with
  ``index_select``.

- the rest of the LM family, trained through the launcher's LM path and
  served through ``ServeEngine``: (a) ``repro_torch.launch.train.main(
  ["--arch", "rwkv6-1.6b", "--seq-len", "128", "--batch", "8", ...])`` at
  full width (24 layers, d_model 2,048, vocab 65,536; 1.58 B parameters,
  f32 master weights, bf16 compute) for one epoch of 6 steps (the ``lm``
  gather over an int32 token stream), with ``val_loss`` and ``val_ppl`` in
  the epoch row, the WKV scan through its own backward; it prints each
  step's host ms around a synchronised step and the peak memory, which must
  be at most 1.05 x the 50.14 GiB of the WKV loop under autograd.  (b) deepseek-v2-lite-16b at full width (MLA with
  kv_lora_rank 512; MoE 64 routed experts top-6 + 2 shared; 15.7 B
  parameters drawn on the card straight into bf16) serves 16 greedy
  requests (8 slots, max_len 1,024, 32 new tokens): every request ``ok``,
  every MoE dispatch's dropped assignments counted (none at decode), and
  every lane replayed dropless (capacity factor E / k: which assignments a
  prefill group drops depends on the group), lanes of one prompt length
  as one batch, each prompt prefilled and its generated tokens decoded
  teacher-forced.  In float32 the router probabilities of every MoE
  layer at every position must agree with a float32 ``forward``'s over the
  same tokens within 2e-5 up to any change of expert choice (a near tie),
  at most half the lanes may have such a change, and every other lane's
  last logits must be within 1e-4 of the forward's; in bf16 the lanes'
  summed distance from the float32 forward must be at most twice a bf16
  ``forward``'s.  (c) all nine new archs at their smoke
  configs, float32: 3 launcher steps each, then prefill + 4 decode steps
  within 1e-4 of a teacher-forced forward.  The deepseek requests are then
  served again through a paged plane (MLA latent pools of block 16, the
  pool sized to the live tokens): every request ``ok``, 0 drops at decode,
  its tokens against the contiguous run's (and where they differ, a second
  contiguous run against the first: the bf16 MoE combine adds in no fixed
  order), and one full-width MLA layer's paged decode bit-equal to its
  contiguous decode.  No kernel runs on this path, nor on the sampler,
  qwen1.5-4b and fleet paths (the launcher serves with the plain scan, as
  the JAX launcher does; the fleet's workers are other processes): the four
  counts are set to 0 before each and must read 0 after it.
- the launch tooling (``repro_torch.launch.{specs,dryrun,costs,roofline}``):
  (a) ``python -m repro_torch.launch.dryrun --device cuda`` in one process
  a cell, eight at a time, on fake CUDA meshes of 256 (16x16) and 512
  (2x16x16) ranks: both ST-GNN cells under each placement, qwen1.5-4b's
  ``train_4k``, ``prefill_32k`` and ``decode_32k``,
  deepseek-v2-lite-16b's ``train_4k``, ``prefill_32k`` and ``decode_32k``,
  h2o-danube-3-4b's ``prefill_32k``, musicgen-large's ``train_4k`` and
  ``decode_32k``, rwkv6-1.6b's ``train_4k``, ``prefill_32k`` and
  ``decode_32k`` and recurrentgemma-2b's ``train_4k`` and ``prefill_32k``
  (RG-LRU's associative scan in training; its sequential scan and the WKV
  scan's forward and backward loops rolled); each record's per-device memory,
  FLOPs, bytes and collectives by kind, and its roofline row (a cell past
  240 s is recorded as failed); then ``--halo-evidence`` on a fake mesh of
  8, which must show 0 data-collective bytes at ``halo=False`` and more at
  ``halo=True``.  (b) Over a one-rank NCCL group, three cells at a 1x1
  mesh at the sizes the paths above run (PGT-DCRNN batch 32 on 8,640
  entries, dcrnn-pems batch 8 on 104, qwen1.5-4b decode of 8 lanes at
  ``max_len`` 1,024): each is dry-run, then its args are drawn on
  ``cuda:0`` and the same program runs for real; the predicted FLOPs must
  equal the cost counter's over the real step, and the predicted peak must
  be within 10 % of ``max_memory_allocated`` above the args' start; the
  roofline bound is printed beside the measured CUDA-event step.  The
  cells use the plain gather and hops, as the JAX package's do: no kernel
  runs on this path.

Phases: device (card name and power limit; TF32 off for matmuls and cuDNN);
build (the CUDA kernels compiled from ``src/repro_torch``, one nvcc per
source in parallel, and each library's count of tensor-core ``HMMA``
instructions from ``cuobjdump -sass``: flash_attention's bf16 kernel and
hop_project run on the tensor cores, so both counts must be above zero);
kernels (each kernel against its plain PyTorch version at the shapes its
path gives it: window_gather and linear_scan bit-exact, with the gather's
route (bulk or vector) logged, hop_project (3xTF32) held to float64 as hop_gemm is,
flash_attention within f32 atol 5e-5 and bf16 atol 3e-2, plus edge cases);
the four paths; the ``hop_project`` cases of the DCRNN path (N 11,160, B
8, C 65/66/128, H 64/128) and past C = 128 (130 and 192 as column tiles,
N 2,716) held to float64 likewise, ``window_gather`` at its 89,280-byte rows
bit-exact; times (CUDA events, medians; each kernel's device time
beside its bound from the H100 datasheet, its plain version and a one-call
PyTorch yardstick where one exists: window_gather and index_select in
turns; linear_scan at every prefill group shape and at decode beside its
launch floor, the same launch at [1, 1, 32]).

Cuts: the LM training run's token stream is 196 tokens (68 windows of 129:
one epoch of 6 steps of 8, 7 val windows); the deepseek, qwen1.5-4b and
fleet serving cells cut traffic only (16 requests, prompts of 128, 256 and
512 tokens; 8 requests on the sharded serving path); the checked fleet drill serves the smoke config, whose float32
is what makes it checkable: a restore computes the next token's logits by a
prefill instead of a decode step, and in bf16 that other order of roundings
can flip a near-tie draw (in the JAX package as in the port); the
full-width bf16 drill beside it records how often.  The
distributed phase trains on a pool of 160 train windows (every
k-th one strictly inside each rank's shard, 5 batches of 16 a rank); the
world-1 launcher run on 600 entries; the elastic processes on the
launcher's default 2,000 entries (43 steps).  The ST-GNN series has 8,640 entries (30 days of 5-minute bins)
instead of PeMS-All-LA's 105,120, and the train split is cut to the 20
steps' 640 windows (5 steps' 160 on the dispatch path; 640 in both
§5.5 models).  The dcrnn-pems
series has 104 entries instead of the 105,120 of a year: 81 windows, so one
epoch is 7 steps of 8 (8 val, 16 test windows).  The serving cell
cuts traffic only (16 requests, prompt lengths drawn from 128, 256 and 512
tokens); no width or depth is cut.

Prints the kernels' JSON line, then ``{"ok": true, "device": {...}}`` as the
last line; exits non-zero on any failure, and without a card.

Run from the repository root:  python3 chip_smoke.py [--profile]
(``--profile`` adds a torch.profiler breakdown of one train step and one
forecast batch of each ST-GNN model, of one decode step, of one train
step of each A3T-GCN arm and of ST-LLM, of one rwkv6-1.6b train step and
of one deepseek-v2-lite-16b decode step.)
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM datasheet peaks (dense, 700 W): HBM3 bandwidth, fp32 on CUDA
# cores, TF32 and bf16 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
# The libraries whose kernels must run on the tensor cores.
TENSOR_CORE_LIBS = ("flash_attention", "hop_project", "hop_gemm")

NODES, FEATURES, HIDDEN, K_HOPS, HORIZON = 2_716, 2, 64, 2, 12
ENTRIES = 8_640  # cut from 105,120: 30 days of 5-minute bins
BATCH, TRAIN_STEPS, SEED = 32, 20, 0
# The train cells' hops (N, B, C): dcrnn-pems's B·C 520, 528 and 1,024, and
# PeMS-All-LA's 2,112.  3xTF32 keeps fp32's accuracy, so hop_gemm's largest
# error from the float64 product may be at most HOP_GEMM_FP32_FACTOR times
# the fp32 plain product's on the same inputs, plus HOP_GEMM_FLOOR of the
# product's largest magnitude (for a product that fp32 computes exactly).
# hop_project's Z_next and Y_next are held to the same rule.
# At these shapes a sound kernel reads 0.4-0.7 of fp32's error; a kernel
# whose tensor-core accumulator truncates over K, and one-pass TF32, read
# 30 times it and more, and fail (PERF.md section 2.1).
HOP_GEMM_SHAPES = ((11_160, 8, 65), (11_160, 8, 66), (11_160, 8, 128), (2_716, 32, 66))
HOP_GEMM_FP32_FACTOR = 4
HOP_GEMM_FLOOR = 2.0 ** -20
EVAL_RTOL = 1e-4            # MAE through the hop kernel vs the plain hops
SLEEP_CYCLES = 20_000_000   # ~10 ms of device clock: covers the host's enqueueing

RG_ARCH = "recurrentgemma-2b"
RG_SLOTS, RG_MAX_LEN, RG_NEW_TOKENS = 8, 1024, 32
RG_REQUESTS, RG_PROMPT_LENS = 16, (128, 256, 512)  # the traffic cuts
RG_AGREE_STEPS = 8  # greedy decode steps compared between the two scans
# Logits of one prefill group through the scan kernel vs the plain
# sequential scan (the reference's branch with a cache).  The kernel is
# bit-exact to its plain version and every other op is the same, so the two
# should agree exactly; the bound allows a few bf16 ulps at the logits'
# magnitude in case a library op is not deterministic.
RG_LOGIT_ATOL = 0.125
# The associative scan (the reference's branch without a cache) at the
# group's shape: in float32 its h against the kernel's within these (the LM
# parity tests' tolerance; the two differ by float32 roundings only).  End
# to end in bf16 another association flips roundings through 26 layers
# (0.159 from the kernel's prefill logits at the [2, 512] group on an
# H100), so there the forward through the associative scan must be at most
# RG_ASSOC_RATIO times as far from a float32 forward as the kernel's prefill
# is; a wrong scan would put it at the logits' own scale.
RG_SCAN_TOL = 1e-5
RG_ASSOC_RATIO = 2.0

# flash_attention against its plain version (tests/test_flash_attention.py's
# tolerances): f32 sums in another order; bf16 outputs, and the kernel rounds
# p to bf16 before P·V as the JAX kernel does.
FLASH_ATOL = {torch.float32: 5e-5, torch.bfloat16: 3e-2}
FLASH_SHAPE = (2, 512)  # [B, S] of the timed recurrentgemma-2b prompt group
DISPATCH_STEPS = 5      # train steps of each fit on the dispatch path


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


def in_turns(fns: dict, *, rounds: int = 2, **kw) -> dict:
    """Each of two callables timed in turns (first, second, second, first),
    ``rounds`` times, by :func:`median_ms` with ``kw``: the median of each
    one's turns, so that both see the same clocks and neighbours."""
    (na, fa), (nb, fb) = fns.items()
    times = {na: [], nb: []}
    for _ in range(rounds):
        for name, fn in ((na, fa), (nb, fb), (nb, fb), (na, fa)):
            times[name].append(median_ms(fn, **kw))
    return {name: statistics.median(t) for name, t in times.items()}


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


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy Triton's package carries."""
    paths = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        paths.append(os.path.join(os.path.dirname(spec.origin), "backends", "nvidia",
                                  "bin", "cuobjdump"))
    for path in paths:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(f"cuobjdump not found (tried {paths})")


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
    tool = cuobjdump()
    for name in build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        hmma = sum("HMMA" in line or "HGMMA" in line for line in sass.splitlines())
        log(f"build: {name}: {hmma} HMMA (tensor-core) instructions in its SASS")
        if name in TENSOR_CORE_LIBS:
            check(hmma > 0, f"{name} has no tensor-core instruction")


def graph():
    from repro_torch.data import (gaussian_adjacency, random_sensor_coords,
                                  transition_matrices)

    adj = gaussian_adjacency(random_sensor_coords(NODES, seed=SEED))
    return adj, tuple(torch.as_tensor(s, device="cuda")
                      for s in transition_matrices(adj))


def phase_kernels(supports) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.window_gather.kernel import launch_shape, window_gather
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
        "f32 C=48 (192-byte rows)": (series[:, :48].contiguous(), starts),
        "f32 C=10,000 (pieces cut rows)": (
            torch.randn((300, 10_000), device="cuda", generator=gen), starts % (300 - span)),
        "f32 unaligned base": (series.view(-1)[1:1 + 500 * 48].view(500, 48),
                               starts % (500 - span)),
        "64 windows (the ring wraps)": (series, torch.randint(
            0, ENTRIES - span + 1, (2 * BATCH,), device="cuda", generator=gen,
            dtype=torch.int32)),
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
        row_bytes = ser.shape[1] * ser.element_size()
        route, blocks = launch_shape(
            len(st), span, row_bytes, aligned=(ser.data_ptr() | out.data_ptr()) % 16 == 0,
            sms=sm_count(ser.device))
        log(f"window_gather {label} {tuple(ser.shape)} {ser.dtype}, {len(st)} windows: "
            f"bit-exact ({route} route, {blocks} blocks)")

    hop_errs = []
    n, cin = NODES, FEATURES + HIDDEN
    s = supports[0]
    for h in (2 * HIDDEN, HIDDEN):
        z = torch.randn((n, BATCH, cin), device="cuda", generator=gen)
        w = torch.randn((cin, h), device="cuda", generator=gen) / cin ** 0.5
        y = torch.randn((n, BATCH, h), device="cuda", generator=gen)
        hop_errs.append(check_hop_project(f"[{n}, {BATCH}, {cin} -> {h}]", s, z, w, y))
    errs["hop_project"] = max(hop_errs)
    return errs


def hop_gemm_bound_ms(n, cols) -> float:
    """3xTF32 operations of one hop at the TF32 peak, or its bytes (S and Z
    read once, the product written once)."""
    flops = 2 * n * n * cols
    nbytes = 4 * (n * n + 2 * n * cols)
    return max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def hop_gemm_limit(fp32_err: float, want) -> float:
    """hop_gemm's largest allowed error from the float64 product ``want``,
    given the fp32 plain product's largest error on the same inputs."""
    return HOP_GEMM_FP32_FACTOR * fp32_err + HOP_GEMM_FLOOR * float(want.abs().max())


def tf32_error(s, z, want, transpose: bool) -> float:
    """The largest error of the one-pass TF32 product (cuBLAS with TF32
    allowed): the control that hop_gemm_limit must refuse."""
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm_plain

    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = hop_gemm_plain(s, z, transpose=transpose)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    return float((got.double() - want).abs().max())


def check_hop_project(label: str, s, z, w, y) -> float:
    """One hop_project call against its plain version in float64: Z_next and
    Y_next each within hop_gemm_limit of the fp32 plain version's error, which
    the one-pass TF32 Z_next must exceed.  Returns the largest error."""
    from repro_torch.kernels.diffusion_conv.kernel import hop_project, hop_project_plain

    with torch.no_grad():
        got = hop_project(s, z, w, y)
        torch.cuda.synchronize()
        want = hop_project_plain(s.double(), z.double(), w.double(), y.double())
        fp32 = hop_project_plain(s, z, w, y)
    worst, parts = 0.0, []
    for part, g, e, f in zip(("z_next", "y_next"), got, want, fp32):
        err = float((g.double() - e).abs().max())
        f_err = float((f.double() - e).abs().max())
        limit = hop_gemm_limit(f_err, e)
        check(err <= limit, f"hop_project {label} {part}: max_abs_err {err:.3e} above its "
                            f"limit {limit:.3e} (fp32's {f_err:.3e})")
        parts.append(f"{part} {err:.3e} (fp32 {f_err:.3e}, limit {limit:.3e})")
        worst = max(worst, err)
        if part == "z_next":
            tf32 = tf32_error(s, z, e, False)
            check(tf32 > limit, f"hop_project {label}: one-pass TF32's {tf32:.3e} is within "
                                f"the limit {limit:.3e}, which then cannot tell a sound kernel")
    log(f"hop_project {label}: max_abs_err {'; '.join(parts)}; one-pass TF32 z_next "
        f"{tf32:.3e}: ok")
    return worst


def hop_gemm_host_us(reps: int = 200) -> dict:
    """Host microseconds a call to enqueue hop_gemm, and torch.matmul on the
    same small hop, with the device kept ahead of neither: a 64-node hop
    runs in a few microseconds, so the time is the host's."""
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    s = torch.rand((64, 64), device="cuda", generator=gen)
    z = torch.randn((64, 8, 66), device="cuda", generator=gen)
    z2 = z.view(64, -1)
    out = {}
    for label, fn in (("kernel", lambda: hop_gemm(s, z)),
                      ("library", lambda: torch.matmul(s, z2))):
        times = []
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
        out[label] = statistics.median(times)
    log(f"hop_gemm host cost: {out['kernel']:.1f} us a call to enqueue (checks, two "
        f"allocations, the split pass and the GEMM), torch.matmul {out['library']:.1f} us "
        f"(median of 5 x {reps} calls at [64² x 528])")
    return out


def phase_hop_gemm() -> list[dict]:
    """hop_gemm, forward (S @ Z) and backward (Sᵀ @ G), against its plain
    version in float64 at the train cells' hop shapes (within hop_gemm_limit,
    which the one-pass TF32 product must fail), then timed beside its 3xTF32
    bound, its plain version and torch.matmul (the library yardstick, in
    turns with the kernel)."""
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm, hop_gemm_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    rows = []
    for n, b, c in HOP_GEMM_SHAPES:
        adj = torch.rand((n, n), device="cuda", generator=gen)
        s = adj / adj.sum(1, keepdim=True)  # a dense random walk
        del adj
        z = torch.randn((n, b, c), device="cuda", generator=gen)
        for transpose in (False, True):
            label = f"hop_gemm [{n}² x {b * c}] {'Sᵀ @ G' if transpose else 'S @ Z'}"
            counts = (hop_gemm.launches_fwd, hop_gemm.launches_bwd)
            got = hop_gemm(s, z, transpose=transpose)
            torch.cuda.synchronize()
            launched = (hop_gemm.launches_fwd - counts[0], hop_gemm.launches_bwd - counts[1])
            want = hop_gemm_plain(s.double(), z.double(), transpose=transpose)
            err = float((got.double() - want).abs().max())
            fp32 = float((hop_gemm_plain(s, z, transpose=transpose).double() - want).abs().max())
            limit = hop_gemm_limit(fp32, want)
            tf32 = tf32_error(s, z, want, transpose)
            del got, want
            check(err <= limit, f"{label}: max_abs_err {err:.3e} above its limit {limit:.3e} "
                                f"(fp32's {fp32:.3e})")
            check(tf32 > limit, f"{label}: one-pass TF32's {tf32:.3e} is within the limit "
                                f"{limit:.3e}, which then cannot tell a sound kernel")
            check(launched == ((0, 1) if transpose else (1, 0)),
                  f"{label}: launches {launched}")
            a, z2 = (s.T if transpose else s), z.view(n, b * c)
            ms = in_turns({"kernel": lambda: hop_gemm(s, z, transpose=transpose),
                           "library": lambda: torch.matmul(a, z2)},
                          inner=5, device_only=True)
            plain = median_ms(lambda: hop_gemm_plain(s, z, transpose=transpose), inner=5,
                              device_only=True)
            bound = hop_gemm_bound_ms(n, b * c)
            log(f"{label}: max_abs_err {err:.3e} (the fp32 plain product {fp32:.3e}, "
                f"one-pass TF32 {tf32:.3e}; limit {limit:.3e}) ok; {ms['kernel']:.4f} ms, "
                f"3xTF32 bound {bound:.4f} ms ({100 * bound / ms['kernel']:.1f} %), plain "
                f"{plain:.4f} ms, torch.matmul {ms['library']:.4f} ms "
                f"({ms['library'] / ms['kernel']:.2f}x the kernel)")
            rows.append({"shape": [n, b * c], "transpose": transpose, "ms": ms["kernel"],
                         "bound_ms": bound, "plain_ms": plain, "library_ms": ms["library"],
                         "max_abs_err": err, "fp32_err": fp32, "tf32_err": tf32,
                         "limit": limit})
        del s, z
        torch.cuda.empty_cache()
    return rows


def hop_gemm_row(rows: list[dict], host_us: dict) -> dict:
    """hop_gemm's entry of the ``kernels`` line: the means over the train
    shapes and both directions of phase_hop_gemm's times, its largest error,
    and its host cost a call."""
    mean = statistics.fmean
    return {"name": "hop_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hop_gemm.cu",
            "replaces": None,  # the JAX package differentiates XLA's products
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": mean(r["ms"] for r in rows), "plain_ms": mean(r["plain_ms"] for r in rows),
            "bound_ms": mean(r["bound_ms"] for r in rows), "bound_by": "operations",
            "library_ms": mean(r["library_ms"] for r in rows),
            "host_us": host_us["kernel"], "library_host_us": host_us["library"]}


def make_data(adj):
    from repro_torch.data import make_traffic_series

    t0 = time.perf_counter()
    raw = make_traffic_series(ENTRIES, NODES, FEATURES, seed=SEED, adjacency=adj)
    log(f"data: synthetic PeMS-All-LA-shaped series {raw.shape} in "
        f"{time.perf_counter() - t0:.1f} s; CUT: {ENTRIES} entries "
        f"(30 days of 5-minute bins) instead of 105,120")
    return raw


def stgnn_pipeline(raw, supports, gather: str, steps: int, *, world: int = 1,
                   elastic=None, **loop_kw):
    """The ST-GNN trainer at full width: ``steps`` train steps of BATCH
    windows an epoch (over ``world`` logical ranks of BATCH // world), params
    drawn from SEED, the window gather named ``gather``, ``loop_kw`` passed
    to the TrainLoopConfig (one epoch unless it says otherwise)."""
    from repro_torch.core import IndexDataset, WindowSpec
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
    ds = dataclasses.replace(ds, train_windows=ds.train_windows[:steps * BATCH])
    params = pgt_dcrnn.init(torch.Generator().manual_seed(SEED), cfg, device="cuda")

    def loss_fn(p, x, y):
        return pgt_dcrnn.loss_fn(p, cfg, supports, x, y), {}

    loop_kw = {"epochs": 1, **loop_kw}
    pipe = build_pipeline(
        None, spec, loss_fn, params,
        PipelineConfig(batch_per_rank=BATCH // world, world=world if world > 1 else None,
                       gather=gather, seed=SEED, device="cuda", adam=AdamConfig(lr=1e-3),
                       loop=TrainLoopConfig(log_every=1, **loop_kw)),
        dataset=ds, elastic=elastic)
    return cfg, spec, pipe


def fit_losses(pipe) -> list[float]:
    _, history = pipe.fit(eval_fn=None)
    torch.cuda.synchronize()
    return [r["loss"] for r in history if "epoch_time_s" not in r]


def train_hops(steps_per_window: int, layers: int, train_steps: int) -> tuple[int, int]:
    """hop_gemm's (forward, backward) launches over ``train_steps`` steps of
    a DCGRU stack: each cell runs 2 dconvs x 2 supports x K hops forward;
    all but the first cell's gate hops (its input, the data beside a zero
    state, takes no gradient) run backward."""
    per_step = steps_per_window * layers * 2 * 2 * K_HOPS
    return per_step * train_steps, (per_step - 2 * K_HOPS) * train_steps


def phase_train(raw, supports):
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm
    from repro_torch.kernels.window_gather.kernel import window_gather

    cfg, spec, pipe = stgnn_pipeline(raw, supports, "pallas", TRAIN_STEPS)
    ds = pipe.dataset
    log(f"train: {ds.n_windows} windows (train cut to {len(ds.train_windows)} "
        f"= {TRAIN_STEPS} steps of {BATCH}; val {len(ds.val_windows)}, "
        f"test {len(ds.test_windows)})")
    before = (window_gather.launches, hop_gemm.launches_fwd, hop_gemm.launches_bwd)
    t0 = time.perf_counter()
    state, history = pipe.fit(eval_fn=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [r["loss"] for r in history if "epoch_time_s" not in r]
    gathers = window_gather.launches - before[0]
    hops = (hop_gemm.launches_fwd - before[1], hop_gemm.launches_bwd - before[2])
    want = train_hops(cfg.input_len, 1, len(losses))
    log(f"train: {len(losses)} steps in {wall:.2f} s (first step included); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; window_gather launches {gathers}; "
        f"hop_gemm launches {hops[0]} forward, {hops[1]} backward ({want[0]} and "
        f"{want[1]} expected)")
    check(hops == want, f"hop_gemm launches {hops}, expected {want}")
    check(len(losses) == TRAIN_STEPS, f"expected {TRAIN_STEPS} steps, got {len(losses)}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "training did not lower the loss")
    check(gathers >= TRAIN_STEPS, "train steps did not go through the CUDA gather")
    return cfg, spec, pipe, state, losses


def eval_pipeline(cfg, spec, pipe, state, supports, use_pallas: bool):
    """An evaluation pipeline over ``pipe``'s dataset whose hops run on the
    kernels (``use_pallas``) or as the plain oracle."""
    from repro_torch.models import pgt_dcrnn
    from repro_torch.pipeline import PipelineConfig, build_pipeline

    fcfg = dataclasses.replace(cfg, use_pallas=use_pallas)

    def loss_fn(p, x, y):
        return pgt_dcrnn.loss_fn(p, fcfg, supports, x, y), {}

    return build_pipeline(None, spec, loss_fn, state["params"],
                          PipelineConfig(batch_per_rank=BATCH, gather="pallas",
                                         seed=SEED, device="cuda"),
                          dataset=pipe.dataset)


def phase_forecast(cfg, spec, pipe, state, supports):
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm, hop_project

    fpipe = eval_pipeline(cfg, spec, pipe, state, supports, True)
    rows, tail = fpipe.dataplane.eval_grid("test")
    max_batches = 4
    scored = min(rows.shape[0], max_batches) + int(bool(len(tail)) and rows.shape[0] < max_batches)
    before = (hop_project.launches, hop_gemm.launches_fwd + hop_gemm.launches_bwd)
    t0 = time.perf_counter()
    mae = fpipe.evaluate(state["params"], split="test", max_batches=max_batches)
    wall = time.perf_counter() - t0
    hops = hop_project.launches - before[0]
    gemms = hop_gemm.launches_fwd + hop_gemm.launches_bwd - before[1]
    per_batch = 2 * 2 * K_HOPS * cfg.input_len
    log(f"forecast: test MAE {mae:.6f} over {scored} batches in {wall:.2f} s; "
        f"hop_project launches {hops} ({per_batch} per batch expected), hop_gemm {gemms} "
        f"(0 expected: no gradients)")
    check(np.isfinite(mae), "non-finite forecast MAE")
    check(gemms == 0, f"hop_gemm launched {gemms} times in a forecast")
    check(hops == per_batch * scored,
          f"hop_project launches {hops} != {per_batch} x {scored} batches")
    return fpipe, mae


def compare_forecast(ppipe, state, mae):
    plain = ppipe.evaluate(state["params"], split="test", max_batches=4)
    rel = abs(mae - plain) / abs(plain)
    log(f"forecast: plain-hop test MAE {plain:.6f}; relative gap {rel:.3e} "
        f"(rtol {EVAL_RTOL})")
    check(rel <= EVAL_RTOL, "forecast through hop_project disagrees with the plain hops")


def gather_times(series, gen, span: int = 2 * HORIZON) -> dict:
    """``window_gather`` of BATCH windows of ``span`` rows from ``series``
    ([T, C]), cycling over 64 batches of starts drawn over the whole series
    (as full training draws them), so most rows come from device memory and
    not from L2: the kernel and ``index_select`` in turns (index_select,
    kernel, kernel, index_select, twice; each turn a median of 5 means of 20
    calls), the plain version, the bytes bound and the launch shape."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.window_gather.kernel import launch_shape, window_gather
    from repro_torch.kernels.window_gather.ref import window_gather_ref

    starts = [torch.randint(0, series.shape[0] - span + 1, (BATCH,),
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

    turns = in_turns({"index_select": lib_gather,
                      "kernel": cycle(lambda s: window_gather(series, s, span=span))},
                     inner=20, device_only=True)
    plain = median_ms(cycle(lambda s: window_gather_ref(series, s, span=span)),
                      inner=20, device_only=True)
    row_bytes = series.shape[1] * series.element_size()
    nbytes = 2 * BATCH * span * row_bytes + BATCH * 4
    route, blocks = launch_shape(BATCH, span, row_bytes, aligned=series.data_ptr() % 16 == 0,
                                 sms=sm_count(series.device))
    return {"ms": turns["kernel"], "library_ms": turns["index_select"], "plain_ms": plain,
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bytes": nbytes,
            "row_bytes": row_bytes, "route": route, "blocks": blocks}


def log_gather_times(label: str, g: dict) -> None:
    log(f"{label} ({g['route']} route, {g['blocks']} blocks, {g['row_bytes']}-byte "
        f"rows) {g['ms']:.5f} ms, plain {g['plain_ms']:.5f} ms, index_select "
        f"{g['library_ms']:.5f} ms (kernel and index_select in turns: "
        f"{g['ms'] / g['library_ms']:.3f}x), bound {g['bound_ms']:.5f} ms "
        f"({g['bytes'] / g['ms'] / 1e6:.1f} GB/s, {g['bound_ms'] / g['ms']:.1%} of the bound)")


def phase_times(pipe, fpipe, ppipe, state, supports, errs) -> list[dict]:
    from repro_torch.kernels.diffusion_conv.kernel import hop_project, hop_project_plain

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
        plain_fc_ms = median_ms(lambda: ppipe._eval_loss(state["params"], ebatch), reps=5)
    log(f"time: train step {step_ms:.3f} ms (median of 5, batch {BATCH}); "
        f"forecast batch {fc_ms:.3f} ms through hop_project, {plain_fc_ms:.3f} ms "
        f"with plain hops (median of 5)")

    g = gather_times(pipe.dataset.series.reshape(pipe.dataset.entries, -1), gen)

    # hop_project at both main-path shapes (H = 128 for the ru gate, 64 for
    # the c gate: equal launch counts on the path), reported as their mean.
    # Its bound: three TF32 products per fp32 product (the fastest route on
    # this card that keeps fp32 accuracy) at the TF32 peak, or the bytes.
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
        h_bound.append(max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3)
        fp32_bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        log(f"time: hop_project H={h}: {h_ms[-1]:.4f} ms, plain {h_plain[-1]:.4f} ms, "
            f"torch.matmul S@Z {h_lib[-1]:.4f} ms, bound {h_bound[-1]:.4f} ms (3xTF32 operations; {fp32_bound:.4f} ms by fp32 "
            f"on CUDA cores) ({flops / h_ms[-1] / 1e9:.1f} fp32-equivalent TFLOP/s)")
    log_gather_times("time: window_gather", g)
    mean = statistics.fmean
    return [
        {"name": "window_gather", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/window_gather.cu",
         "replaces": "src/repro/kernels/window_gather/kernel.py:36",
         "launches": None, "max_abs_err": errs["window_gather"],
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": "bytes", "library_ms": g["library_ms"]},
        {"name": "hop_project", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hop_project.cu",
         "replaces": "src/repro/kernels/diffusion_conv/kernel.py:58",
         "launches": None, "max_abs_err": errs["hop_project"],
         "ms": mean(h_ms), "plain_ms": mean(h_plain), "bound_ms": mean(h_bound),
         "bound_by": "operations", "library_ms": mean(h_lib)},
    ]


def profile_step(label: str, fn) -> None:
    """torch.profiler over one call of ``fn`` after a warm-up: the kernels
    by device time, and the device's busy time against the host's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the kernels' own events, as the table's "Self CUDA time total" sums them:
    # not the device-timeline shadows of record_function ranges (the
    # program's spans among them)
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    log(f"profile: {label}: device busy {busy:.3f} ms of {wall:.3f} ms wall "
        f"({1 - busy / wall:.1%} idle)")
    log(events.table(sort_by="self_cuda_time_total", row_limit=12))


def phase_profile(pipe, fpipe, state) -> None:
    rows = pipe.dataplane.epoch_global(0)
    batch = pipe.batch_of_starts(rows[1])
    eval_rows, _ = fpipe.dataplane.eval_grid("test")
    ebatch = fpipe.batch_of_starts(eval_rows[0])
    for label, fn in (
            ("train step", lambda: pipe.train_step(state, batch)),
            ("forecast batch", lambda: fpipe._eval_loss(state["params"], ebatch))):
        with torch.no_grad() if label == "forecast batch" else torch.enable_grad():
            profile_step(label, fn)


def phase_prefetch(raw, supports, sync_losses) -> None:
    """The feed prefetcher on the ST-GNN train path: prefetch depth 2 at
    staleness 0 (copies at consume, on the step thread) and at staleness 1
    (copies from pinned buffers on a side stream, a step ahead), each
    bit-equal to the synchronous run, timed beside a synchronous run."""
    runs = {}
    for label, kw in (("synchronous", {}),
                      ("staleness 0", dict(prefetch_depth=2, staleness=0)),
                      ("staleness 1", dict(prefetch_depth=2, staleness=1))):
        _, _, pipe = stgnn_pipeline(raw, supports, "pallas", TRAIN_STEPS, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = fit_losses(pipe)
        runs[label] = (time.perf_counter() - t0) * 1e3 / len(losses)
        check(losses == sync_losses, f"prefetch {label}: losses differ from the "
                                     f"synchronous run's")
        del pipe
    log(f"prefetch: {TRAIN_STEPS} steps at each setting, losses bit-equal to the "
        f"synchronous run; host ms a step (wall of the fit / steps, log_every 1): "
        + ", ".join(f"{k} {v:.3f}" for k, v in runs.items()))


# ------------------------------------------- dcrnn-pems through the launcher
DC_ARCH = "dcrnn-pems"
DC_ENTRIES = 104   # 81 windows: 7 train steps of 8, 8 val, 16 test
DC_BATCH = 8       # the paper's per-GPU share: global batch 1,024 over 128 GPUs
DC_CKPT_EVERY = 2


class StepTimer:
    """Host start and end of every train step the engine runs while
    installed (the step ends in a synchronize), by wrapping the step handed
    to ``run_training``; ``ms`` is each step's duration.  With
    ``keep_last``, ``last`` holds the last step function and batch (for a
    profile of one more step); it pins that step's series, so a run that
    re-meshes must not keep it."""

    def __init__(self, keep_last: bool = False):
        self.spans: list[tuple[float, float]] = []
        self.keep_last = keep_last
        self.last = None

    @property
    def ms(self) -> list[float]:
        return [(b - a) * 1e3 for a, b in self.spans]

    def __enter__(self):
        from repro_torch.pipeline import engine

        self._engine, self._run = engine, engine.run_training

        def run(**kw):
            step = kw["train_step"]

            def timed(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                self.spans.append((t0, time.perf_counter()))
                if self.keep_last:
                    self.last = (step, batch)
                return out

            # the state moves into run_training, so no frame here keeps the
            # first state alive for the whole run
            return self._run(**{**kw, "train_step": timed, "state": kw.pop("state")})

        engine.run_training = run
        return self

    def __exit__(self, *exc):
        self._engine.run_training = self._run


def dc_rows(path) -> list[dict]:
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "epoch_time_s"}
                for line in f]


def phase_dcrnn_train(work) -> dict:
    """Run A through the launcher, then a resume from one of its
    mid-epoch checkpoints, held bit for bit against run A."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import Checkpointer
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm
    from repro_torch.launch.train import main as launch
    from repro_torch.kernels.window_gather.kernel import window_gather

    flags = ["--arch", DC_ARCH, "--entries", str(DC_ENTRIES), "--batch", str(DC_BATCH),
             "--seed", str(SEED), "--gather", "pallas", "--ckpt-every", str(DC_CKPT_EVERY),
             "--prefetch-depth", "2", "--staleness", "0", "--log-every", "1"]
    a_dir, a_hist = os.path.join(work, "A"), os.path.join(work, "A.jsonl")
    before = window_gather.launches
    hops_before = (hop_gemm.launches_fwd, hop_gemm.launches_bwd)
    t0 = time.perf_counter()
    with StepTimer() as timer:
        launch([*flags, "--ckpt-dir", a_dir, "--history-out", a_hist])
    wall_a = time.perf_counter() - t0
    rows_a = dc_rows(a_hist)
    steps = [r for r in rows_a if "lr" in r]
    losses = [r["loss"] for r in steps]
    n = len(steps)
    gathers = window_gather.launches - before
    hops = (hop_gemm.launches_fwd - hops_before[0], hop_gemm.launches_bwd - hops_before[1])
    model = get_arch(DC_ARCH).model
    want_hops = train_hops(model.input_len + model.horizon, model.layers, n)
    kept = Checkpointer(a_dir).steps()
    saved = [s for s in range(DC_CKPT_EVERY, n + 1, DC_CKPT_EVERY)] + [n]
    expect = sorted(set(saved))[-3:]  # keep=3, the Checkpointer's retention
    step_ms = statistics.median(timer.ms[1:])
    log(f"dcrnn: run A: {n} steps in {wall_a:.1f} s (data and eval included); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; val MAE {rows_a[-1].get('val_mae')}; "
        f"train step {step_ms:.3f} ms (median of steps 2..{n}; all: "
        f"{', '.join(f'{t:.1f}' for t in timer.ms)}); window_gather launches {gathers}; "
        f"hop_gemm launches {hops} ({want_hops} expected); checkpoints {kept}")
    check(n >= 6 and all(np.isfinite(losses)), f"run A: {n} steps, losses {losses}")
    check(hops == want_hops, f"run A: hop_gemm launches {hops}, expected {want_hops}")
    check(gathers >= n, "run A's steps did not go through the CUDA gather")
    check(kept == expect, f"checkpoints {kept}, expected {expect} (every "
                          f"{DC_CKPT_EVERY} steps and at the end, newest 3 kept)")

    # Resume from the oldest retained mid-epoch checkpoint, in a fresh
    # directory, with a fresh history.
    mid = kept[0]
    b_dir, b_hist = os.path.join(work, "B"), os.path.join(work, "B.jsonl")
    os.makedirs(b_dir)
    shutil.copytree(os.path.join(a_dir, f"step_{mid:010d}"),
                    os.path.join(b_dir, f"step_{mid:010d}"))
    hops_before = (hop_gemm.launches_fwd, hop_gemm.launches_bwd)
    launch([*flags, "--ckpt-dir", b_dir, "--history-out", b_hist, "--resume"])
    hops = (hop_gemm.launches_fwd - hops_before[0], hop_gemm.launches_bwd - hops_before[1])
    want_hops = train_hops(model.input_len + model.horizon, model.layers, n - mid)
    check(hops == want_hops, f"resume: hop_gemm launches {hops}, expected {want_hops}")
    rows_b = dc_rows(b_hist)
    want = [r for r in rows_a if r["step"] > mid]
    with np.load(os.path.join(a_dir, f"step_{n:010d}", "arrays.npz")) as za, \
            np.load(os.path.join(b_dir, f"step_{n:010d}", "arrays.npz")) as zb:
        same_state = sorted(za.files) == sorted(zb.files) and all(
            np.array_equal(za[k], zb[k]) for k in za.files)
    log(f"dcrnn: resume from step {mid}: {len(rows_b)} rows (steps {mid + 1}..{n} and "
        f"the epoch summary) {'equal' if rows_b == want else 'DIFFER from'} run A's bit "
        f"for bit; final checkpoint {'identical' if same_state else 'DIFFERS'}; hop_gemm "
        f"launches {hops}")
    check(rows_b == want and len(rows_b) == n - mid + 1,
          f"resumed rows {rows_b} differ from run A's {want}")
    check(same_state, "the resumed run's final state differs from run A's")
    return {"dir": a_dir, "steps": n, "step_ms": step_ms, "wall_a": wall_a}


def dc_graph_and_data():
    """The launcher's own graph and series for dcrnn-pems (same seed)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import (gaussian_adjacency, make_traffic_series,
                                  random_sensor_coords, transition_matrices)

    cfg = get_arch(DC_ARCH).model
    t0 = time.perf_counter()
    adj = gaussian_adjacency(random_sensor_coords(cfg.num_nodes, seed=SEED))
    supports = tuple(torch.as_tensor(np.ascontiguousarray(s), device="cuda")
                     for s in transition_matrices(adj))  # as the launcher places them
    raw = make_traffic_series(DC_ENTRIES, cfg.num_nodes, cfg.in_features, seed=SEED,
                              adjacency=adj)
    log(f"dcrnn: graph ({cfg.num_nodes:,} nodes: float64 adjacency temporaries of "
        f"{cfg.num_nodes ** 2 * 8 / 1e9:.2f} GB on the host, two dense supports of "
        f"{2 * cfg.num_nodes ** 2 * 4 / 1e9:.2f} GB on the card) and series {raw.shape} "
        f"in {time.perf_counter() - t0:.1f} s; CUT: {DC_ENTRIES} entries instead of "
        f"the 105,120 of a year")
    return cfg, supports, raw


def phase_dcrnn_forecast(run, cfg, supports, raw):
    """Run A's final checkpoint forecasts one test batch through
    ``dcrnn.loss_fn`` with every hop through hop_project, and with the
    plain hops."""
    from repro_torch.core import WindowSpec
    from repro_torch.distributed import restore
    from repro_torch.kernels.diffusion_conv.kernel import hop_project
    from repro_torch.models import dcrnn
    from repro_torch.optim import AdamConfig
    from repro_torch.pipeline import PipelineConfig, build_pipeline
    from repro_torch.train.loop import init_train_state

    template = init_train_state(dcrnn.init(torch.Generator().manual_seed(SEED), cfg,
                                           device="cuda"), AdamConfig())
    state, step = restore(run["dir"], template)
    check(step == run["steps"], f"restored step {step}, expected {run['steps']}")
    params = state["params"]
    spec = WindowSpec(horizon=cfg.horizon, input_len=cfg.input_len)
    pipes = {}
    for use in (True, False):
        c = dataclasses.replace(cfg, use_pallas=use)
        pipes[use] = build_pipeline(
            raw, spec, lambda p, x, y, c=c: (dcrnn.loss_fn(p, c, supports, x, y), {}),
            params, PipelineConfig(batch_per_rank=DC_BATCH, gather="pallas", seed=SEED,
                                   device="cuda"))
    rows, _ = pipes[True].dataplane.eval_grid("test")
    batch = pipes[True].batch_of_starts(rows[0])
    with torch.no_grad():
        before = hop_project.launches
        mae = float(pipes[True]._eval_loss(params, batch)[0])
        hops = hop_project.launches - before
        plain = float(pipes[False]._eval_loss(params, batch)[0])
        rel = abs(mae - plain) / abs(plain)
        per_batch = 2 * cfg.layers * 2 * 2 * cfg.max_diffusion_step * cfg.input_len
        log(f"dcrnn: forecast of {DC_BATCH} test windows from the step-{step} "
            f"checkpoint: MAE {mae:.6f} through hop_project ({hops} launches; "
            f"{per_batch} expected), {plain:.6f} with the plain hops; relative gap "
            f"{rel:.3e} (rtol {EVAL_RTOL})")
        check(np.isfinite(mae), "non-finite forecast MAE")
        check(hops == per_batch, f"hop_project launches {hops} != {per_batch}")
        check(rel <= EVAL_RTOL, "the forecast through hop_project disagrees with "
                                "the plain hops")
    return pipes, params, batch


def dcrnn_forecast_times(pipes, params, batch):
    with torch.no_grad():
        fc_ms = median_ms(lambda: pipes[True]._eval_loss(params, batch), reps=3)
        plain_ms = median_ms(lambda: pipes[False]._eval_loss(params, batch), reps=3)
    log(f"time: dcrnn forecast batch {fc_ms:.3f} ms through hop_project, {plain_ms:.3f} "
        f"ms with the plain hops (CUDA events, median of 3)")
    return fc_ms, plain_ms


def hop_bound_ms(n, b, c, h) -> float:
    """3xTF32 operations at the TF32 peak, or the bytes (S, Z and Y read
    once, Z_next and Y_next written once, W read once)."""
    flops = 2 * n * n * b * c + 2 * n * b * c * h
    nbytes = 4 * (n * n + 2 * n * b * c + 2 * n * b * h + c * h)
    return max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def phase_dcrnn_kernels(supports, small_support, raw) -> None:
    """hop_project at the DCRNN path's shapes and past C = 128 (column
    tiles), and window_gather at its 89,280-byte rows."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.diffusion_conv.kernel import (column_tiles, hop_project,
                                                           hop_project_plain)
    from repro_torch.kernels.window_gather.kernel import launch_shape, window_gather
    from repro_torch.kernels.window_gather.ref import window_gather_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    n_big = supports[0].shape[0]
    cases = [(supports[0], c, h) for c in (65, 66, 128) for h in (64, 128)]
    cases += [(small_support, 128, 128), (small_support, 130, 64), (small_support, 192, 128)]
    for s, c, h in cases:
        n = s.shape[0]
        z = torch.randn((n, DC_BATCH, c), device="cuda", generator=gen)
        w = torch.randn((c, h), device="cuda", generator=gen) / c ** 0.5
        y = torch.randn((n, DC_BATCH, h), device="cuda", generator=gen)
        label = f"[{n}, {DC_BATCH}, {c} -> {h}] ({len(column_tiles(c))} column tiles)"
        check_hop_project(label, s, z, w, y)
        if (n, c, h) == (n_big, 128, 128) or n != n_big:
            with torch.no_grad():
                ms = median_ms(lambda: hop_project(s, z, w, y), inner=5, device_only=True)
                plain = median_ms(lambda: hop_project_plain(s, z, w, y), inner=5,
                                  device_only=True)
                z2 = z.view(n, DC_BATCH * c)
                lib = median_ms(lambda: torch.matmul(s, z2), inner=5, device_only=True)
            log(f"time: hop_project {label}: {ms:.4f} ms, plain {plain:.4f} ms, torch.matmul "
                f"S@Z {lib:.4f} ms, 3xTF32 bound {hop_bound_ms(n, DC_BATCH, c, h):.4f} ms")

    series = torch.as_tensor(raw.reshape(raw.shape[0], -1), device="cuda")
    span = 2 * HORIZON
    starts = torch.randint(0, series.shape[0] - span + 1, (DC_BATCH,), device="cuda",
                           generator=gen, dtype=torch.int32)
    out = window_gather(series, starts, span=span)
    torch.cuda.synchronize()
    row_bytes = series.shape[1] * series.element_size()
    route, blocks = launch_shape(DC_BATCH, span, row_bytes,
                                 aligned=(series.data_ptr() | out.data_ptr()) % 16 == 0,
                                 sms=sm_count(series.device))
    exact = torch.equal(out, window_gather_ref(series, starts, span=span))
    log(f"window_gather {tuple(series.shape)} f32, {DC_BATCH} windows of {span} "
        f"({row_bytes:,}-byte rows): {'bit-exact' if exact else 'DIFFERS'} ({route} "
        f"route, {blocks} blocks)")
    check(exact, "window_gather at the dcrnn-pems rows differs from its plain version")


def profile_dcrnn(pipes, params, batch) -> None:
    from repro_torch.optim import AdamConfig
    from repro_torch.train.loop import init_train_state

    state = init_train_state(params, AdamConfig())
    for label, fn in (("dcrnn train step",
                       lambda: pipes[False].train_step(state, batch)),
                      ("dcrnn forecast batch",
                       lambda: pipes[True]._eval_loss(params, batch))):
        with torch.no_grad() if "forecast" in label else torch.enable_grad():
            profile_step(label, fn)


def phase_dcrnn(work) -> tuple:
    """dcrnn-pems at full width through the launcher: train, resume from a
    mid-epoch checkpoint, forecast one test batch from the final one."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = phase_dcrnn_train(work)
    cfg, supports, raw = dc_graph_and_data()
    pipes, params, batch = phase_dcrnn_forecast(run, cfg, supports, raw)
    log(f"dcrnn: peak device memory of the phase {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (training without remat, batch {DC_BATCH}); path wall "
        f"{time.perf_counter() - t0:.1f} s")
    return run, cfg, supports, raw, pipes, params, batch


def phase_dcrnn_times(dc, small_support, profile: bool) -> None:
    """The dcrnn-pems path's times, its kernel cases and, with --profile,
    its breakdowns."""
    run, cfg, supports, raw, pipes, params, batch = dc
    fc_ms, plain_ms = dcrnn_forecast_times(pipes, params, batch)
    if profile:
        profile_dcrnn(pipes, params, batch)
    phase_dcrnn_kernels(supports, small_support, raw)
    log(f"dcrnn: {cfg.num_nodes:,} nodes, hidden {cfg.hidden}, {cfg.layers} + "
        f"{cfg.layers} DCGRU layers, K = {cfg.max_diffusion_step}; train step "
        f"{run['step_ms']:.3f} ms, forecast batch {fc_ms:.3f} ms ({plain_ms:.3f} plain)")


# --------------------------------------------------------- the serving path
def rg_model():
    """recurrentgemma-2b at its registered widths, random f32 params drawn
    on the card from a seeded generator."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as lm
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_arch(RG_ARCH).lm, use_pallas_scan=True)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                     device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"serve: {RG_ARCH} at full width: {cfg.layers} layers "
        f"({[(len(sp), r) for sp, r in lm.stage_plan(cfg)]} stage plan), "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, lru_width "
        f"{cfg.lru_width}, window {cfg.window}, compute {cfg.dtype}, params "
        f"{cfg.param_dtype}: {n:,} parameters ({n * 4 / 1e9:.2f} GB f32), "
        f"random from seed {SEED}, drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def rg_prompts():
    rng = np.random.default_rng(SEED)
    lens = rng.choice(RG_PROMPT_LENS, size=RG_REQUESTS)
    return [rng.integers(0, 256_000, int(n)).astype(np.int32) for n in lens]


class ServeTimer:
    """Host-clock ms of every prefill group and decode step of every plane
    while installed, each to its one device pull (class-level wraps, so the
    planes of an engine the launcher builds are timed too); ``base`` is the
    memory allocated at the first prefill: the weights and the cache."""

    def __enter__(self):
        from repro_torch.serve import plane

        self.groups, self.steps, self._saved = [], [], []
        for cls in (plane.InferencePlane, plane.PagedInferencePlane):
            for name, timed in (("prefill_into", self._prefill), ("decode", self._decode)):
                self._saved.append((cls, name, cls.__dict__[name]))
                setattr(cls, name, timed(cls.__dict__[name]))
        return self

    def _prefill(self, fn):
        def run(plane, slots, prompts, *a, **kw):
            if not self.groups:
                self.base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = fn(plane, slots, prompts, *a, **kw)
            self.groups.append((prompts.shape, (time.perf_counter() - t0) * 1e3))
            return out
        return run

    def _decode(self, fn):
        def run(plane):
            t0 = time.perf_counter()
            out = fn(plane)
            self.steps.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def serve_timed(eng, prompts, submit=None):
    """Submit ``prompts`` (``submit[i]``: request i's keyword overrides) and
    run the engine to the end under a ``ServeTimer``.
    Returns (rids, out, groups [(shape, ms)], steps [ms], wall s)."""
    with ServeTimer() as timer:
        rids = [eng.submit(p, **(submit[i] if submit else {}))
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        wall = time.perf_counter() - t0
    return rids, out, timer.groups, timer.steps, wall


def phase_serve(cfg, params):
    """The serving main path: 16 greedy requests through ServeEngine."""
    from repro_torch.serve import ServeConfig, ServeEngine

    prompts = rg_prompts()
    log(f"serve: CUTS (traffic only): {RG_REQUESTS} requests, prompt lengths "
        f"{sorted(p.size for p in prompts)} drawn from {RG_PROMPT_LENS}, "
        f"{RG_NEW_TOKENS} new tokens each; no width or depth cut")
    eng = ServeEngine(params, cfg, ServeConfig(slots=RG_SLOTS, max_len=RG_MAX_LEN,
                                               max_new_tokens=RG_NEW_TOKENS),
                      planes=1)
    log(f"serve: slot-pool cache {eng.planes[0].cache_bytes() / 2**20:.1f} MiB "
        f"({RG_SLOTS} lanes x {RG_MAX_LEN} tokens)")
    rids, out, groups, steps, wall = serve_timed(eng, prompts)
    statuses = [eng.router.done[r].status for r in rids]
    n_tok = sum(len(out[r]) for r in rids)
    log(f"serve: {len(rids)} requests in {wall:.3f} s: {len(groups)} prefill "
        f"groups {[tuple(g) for g, _ in groups]}, {len(steps)} decode steps, "
        f"{n_tok} tokens ({n_tok / wall:.1f} tokens/s over the run)")
    check(statuses == ["ok"] * RG_REQUESTS, f"request statuses {statuses}")
    check(all(len(out[r]) == RG_NEW_TOKENS for r in rids),
          "a request did not get its 32 tokens")
    check(all(0 <= t < cfg.vocab for r in rids for t in out[r]),
          "a token outside the vocabulary")
    return eng, out, groups, steps, wall, n_tok


def rg_compare_plain(cfg, eng, groups) -> None:
    """One prefill group again, through the scan kernel and through the
    plain sequential scan, on the same (compute-dtype) params, with a short
    greedy decode from each; the associative scan (a forward over the group)
    against them and a float32 forward.  Then the group's RG-LRU scans by
    each route, the kernel, the associative scan and the sequential scan:
    checked in float32 and timed in bf16."""
    from repro_torch.models.lm import model as lm
    from repro_torch.models.lm.rglru import rglru_scan
    from repro_torch.tree import tree_map

    params = eng.planes[0].params
    prompts = rg_prompts()
    (k, plen), _ = groups[0]
    batch = torch.as_tensor(np.stack([p for p in prompts if p.size == plen][:k]),
                            dtype=torch.long, device="cuda")
    runs = {}
    with torch.no_grad():
        for use in (True, False):
            c = dataclasses.replace(cfg, use_pallas_scan=use)
            cache = lm.init_cache(c, k, RG_MAX_LEN)
            logits, cache, lengths = lm.prefill(params, c, batch, cache)
            toks, tok = [], torch.argmax(logits, -1)[:, None]
            for _ in range(RG_AGREE_STEPS):
                toks.append(tok[:, 0].cpu())
                step_logits, cache = lm.decode_step(params, c, tok, cache, lengths)
                check(bool(torch.isfinite(step_logits).all()), "non-finite decode logits")
                tok, lengths = torch.argmax(step_logits, -1)[:, None], lengths + 1
            runs[use] = (logits.float(), torch.stack(toks))
        del cache
        fwd = {use: lm.forward(params, dataclasses.replace(cfg, use_pallas_scan=use),
                               batch)[0][:, -1].float() for use in (True, False)}
        p32 = tree_map(lambda t: t.float(), params)
        ref = lm.forward(p32, dataclasses.replace(cfg, dtype="float32",
                                                  use_pallas_scan=False), batch)[0][:, -1]
        del p32
    diff = lambda a, b: float((a - b).abs().max())
    err = diff(runs[True][0], runs[False][0])
    agree = float((runs[True][1] == runs[False][1]).float().mean())
    far_kernel, far_assoc = diff(runs[True][0], ref), diff(fwd[False], ref)
    log(f"serve: prefill group [{k}, {plen}] logits through linear_scan vs the "
        f"plain sequential scan: max_abs_diff {err:.3e} (atol {RG_LOGIT_ATOL}); greedy "
        f"tokens agreeing over {RG_AGREE_STEPS} decode steps: {agree:.3f}; bf16 "
        f"forwards (no cache) at the last position: through the associative scan vs "
        f"the kernel's prefill {diff(fwd[False], runs[True][0]):.3e}, through the "
        f"kernel vs its prefill {diff(fwd[True], runs[True][0]):.3e}, the two "
        f"forwards {diff(fwd[False], fwd[True]):.3e}; from a float32 forward: the "
        f"kernel's prefill {far_kernel:.3e}, the associative forward {far_assoc:.3e} "
        f"(at most {RG_ASSOC_RATIO}x)")
    check(bool(torch.isfinite(runs[True][0]).all()), "non-finite prefill logits")
    check(err <= RG_LOGIT_ATOL, "prefill logits through linear_scan disagree "
                                "with the plain sequential scan")
    check(far_assoc <= RG_ASSOC_RATIO * far_kernel,
          "the associative scan's forward is further from float32 than allowed")

    # the group's RG-LRU scans by each route, at one layer's weights
    layer = tree_map(lambda t: t[0], params["stages"][0]["sub0"]["rec"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x = torch.randn((k, plen, cfg.lru_width), device="cuda", generator=gen)
    routes = {"kernel": dict(use_pallas=True), "associative": {},
              "sequential": dict(use_assoc=False)}
    with torch.no_grad():
        h32 = {name: rglru_scan(layer, x, **kw)[0] for name, kw in routes.items()}
        gap = float(((h32["associative"] - h32["kernel"]).abs()
                     - RG_SCAN_TOL * h32["kernel"].abs()).max())
        x = x.to(torch.bfloat16)
        ms = {name: median_ms(lambda kw=kw: rglru_scan(layer, x, **kw), reps=3)
              for name, kw in routes.items()}
    n_rec = sum(kind == "rec" for kind in cfg.block_types())
    log(f"serve: RG-LRU scan [{k}, {plen}, {cfg.lru_width}] float32, associative vs "
        f"kernel: max_abs_diff {diff(h32['associative'], h32['kernel']):.3e} (atol = "
        f"rtol = {RG_SCAN_TOL}); sequential vs kernel "
        f"{diff(h32['sequential'], h32['kernel']):.3e}")
    check(torch.equal(h32["kernel"], h32["sequential"]),
          "the kernel's RG-LRU scan differs from the sequential scan")
    check(gap <= RG_SCAN_TOL, "the associative RG-LRU scan disagrees with the kernel's")
    log(f"time: prefill group [{k}, {plen}]'s RG-LRU scan (gates included, bf16 x, "
        f"CUDA events, median of 3) a layer: " + ", ".join(
            f"{name} {t:.3f} ms ({n_rec} layers {n_rec * t:.2f} ms)"
            for name, t in ms.items()))


def scan_inputs(gen, b, s, d, dtype=torch.float32, decay=None):
    a = (torch.full((b, s, d), decay, device="cuda") if decay is not None else
         0.7 + 0.3 * torch.rand((b, s, d), device="cuda", generator=gen))
    x = torch.randn((b, s, d), device="cuda", generator=gen)
    return a.to(dtype).contiguous(), x.to(dtype)


def phase_scan_kernel(cfg, groups) -> float:
    """linear_scan against its plain version, bit-exact, at the path's shapes
    and edge cases.  Returns the max abs error (0 when bit-exact)."""
    from repro_torch.kernels.linear_scan.kernel import linear_scan
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    w = cfg.lru_width
    cases = [("decode, bf16 h0", (RG_SLOTS, 1, w), torch.float32, torch.bfloat16, None),
             ("decode", (RG_SLOTS, 1, w), torch.float32, torch.float32, None)]
    cases += [("prefill group", (k, plen, w), torch.float32, torch.float32, None)
              for (k, plen) in sorted({g for g, _ in groups})]
    cases += [("bf16 a and b", (4, 100, w), torch.bfloat16, torch.bfloat16, None),
              ("D = 33, ragged S", (3, 37, 33), torch.float32, None, None),
              ("S = 1, no h0", (2, 1, w), torch.bfloat16, None, None),
              ("decay 0", (5, 64, 129), torch.float32, torch.float32, 0.0),
              ("decay 1", (5, 64, 129), torch.float32, torch.float32, 1.0)]
    worst = 0.0
    for label, (b, s, d), dtype, h_dtype, decay in cases:
        a, x = scan_inputs(gen, b, s, d, dtype, decay)
        h0 = None if h_dtype is None else torch.randn(
            (b, d), device="cuda", generator=gen).to(h_dtype)
        got = linear_scan(a, x, h0)
        torch.cuda.synchronize()
        want = linear_scan_ref(a, x, h0)
        exact = all(torch.equal(g, e) for g, e in zip(got, want))
        worst = max(worst, max(float((g.float() - e.float()).abs().max())
                               for g, e in zip(got, want)))
        log(f"linear_scan {label} [{b}, {s}, {d}] {dtype} h0 {h_dtype}: "
            f"{'bit-exact' if exact else 'DIFFERS'}")
        check(exact, f"linear_scan {label} differs from its plain version")
    return worst


def scan_bound_ms(b, s, d, itemsize=4) -> float:
    """a and b read, h_seq written, h0 read and h_last written, once each."""
    return (3 * b * s * d + 2 * b * d) * itemsize / PEAK_BYTES_PER_S * 1e3


def phase_serve_times(cfg, eng, groups, steps, wall, n_tok, launches, err) -> dict:
    from repro_torch.kernels.linear_scan.kernel import linear_scan
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref
    from repro_torch.models.lm import model as lm

    params = eng.planes[0].params
    per_len = {}
    with torch.no_grad():
        for (k, plen) in sorted({g for g, _ in groups}):
            tokens = torch.randint(0, cfg.vocab, (k, plen), device="cuda")
            cache = lm.init_cache(cfg, k, RG_MAX_LEN)
            per_len[(k, plen)] = median_ms(
                lambda: lm.prefill(params, cfg, tokens, cache), reps=3)
    for (k, plen), ms in per_len.items():
        log(f"time: prefill group [{k}, {plen}]: {ms:.3f} ms (CUDA events, "
            f"median of 3)")
    dec = statistics.median(steps)
    log(f"time: decode step (8 lanes, host clock to the token pull, median of "
        f"{len(steps)} in the run): {dec:.3f} ms; tokens/s over the run "
        f"{n_tok / wall:.1f}; peak device memory of the serving phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # linear_scan at each shape of the path, weighted by its launches there
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    w = cfg.lru_width
    shapes = {(RG_SLOTS, 1, w): len(steps)}
    for (k, plen), _ in groups:
        shapes[(k, plen, w)] = shapes.get((k, plen, w), 0) + 1
    # The launch floor: the same ctypes launch path at [1, 1, 32], where the
    # kernel moves 384 bytes.
    a, x = scan_inputs(gen, 1, 1, 32)
    h0 = torch.randn((1, 32), device="cuda", generator=gen)
    floor = median_ms(lambda: linear_scan(a, x, h0), inner=20, device_only=True)
    rows = []
    for (b, s, d), n in shapes.items():
        a, x = scan_inputs(gen, b, s, d)
        h0 = torch.randn((b, d), device="cuda", generator=gen)
        ms = median_ms(lambda: linear_scan(a, x, h0), inner=20, device_only=True)
        plain = median_ms(lambda: linear_scan_ref(a, x, h0), inner=2 if s > 1 else 20,
                          device_only=True)
        bound = scan_bound_ms(b, s, d)
        rows.append((n * 18, ms, plain, bound))
        beside = (f"; launch floor [1, 1, 32] {floor:.5f} ms, {ms / floor:.2f}x of it"
                  if s == 1 else "")
        log(f"time: linear_scan [{b}, {s}, {d}] f32: {ms:.5f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.5f} ms (bytes; {ms / bound:.2f}x the bound; "
            f"{(3 * b * s * d + 2 * b * d) * 4 / ms / 1e6:.1f} GB/s){beside}; "
            f"{n * 18} launches on the path")
    total = sum(r[0] for r in rows)

    def weighted(i):
        return sum(r[0] * r[i] for r in rows) / total

    return {"name": "linear_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
            "replaces": "src/repro/kernels/linear_scan/kernel.py:54",
            "launches": launches, "max_abs_err": err,
            "ms": weighted(1), "plain_ms": weighted(2), "bound_ms": weighted(3),
            "bound_by": "bytes", "library_ms": None}


def profile_decode(eng) -> None:
    profile_step("decode step", eng.planes[0].decode)


# ------------------------------------------------ paged and sampled serving
RG_BLOCK = 16
# the sampled lanes' contract: temperature, top-k, top-p (the launcher's flags)
SAMPLED = {"temperature": 0.7, "top_k": 50, "top_p": 0.9}


def pool_for(slots: int, longest_prompt: int, new_tokens: int, block: int) -> int:
    """Usable blocks for ``slots`` live lanes of the longest request: the
    pool sized to the live tokens, not to ``max_len``."""
    return slots * -(-(longest_prompt + new_tokens) // block)


def phase_serve_paged(cfg, eng, greedy_out, greedy_rids):
    """(b) the same 16 prompts through paged planes (block 16, the pool sized
    to the live tokens; recurrentgemma has no paged leaves, so the pool
    holds only its per-lane rec and swa state), every odd request sampled
    (temperature 0.7, top-k 50, top-p 0.9): the greedy lanes' tokens must
    equal the contiguous greedy run's.  Returns (groups, steps)."""
    from repro_torch.serve import ServeConfig, ServeEngine

    prompts = rg_prompts()
    pool = pool_for(RG_SLOTS, max(RG_PROMPT_LENS), RG_NEW_TOKENS, RG_BLOCK)
    peng = ServeEngine(eng.planes[0].params, cfg, ServeConfig(
        slots=RG_SLOTS, max_len=RG_MAX_LEN, max_new_tokens=RG_NEW_TOKENS,
        block_size=RG_BLOCK, pool_blocks=pool), planes=1)
    submit = [dict(SAMPLED, seed=SEED + i) if i % 2 else {} for i in range(len(prompts))]
    rids, out, groups, steps, wall = serve_timed(peng, prompts, submit)
    statuses = [peng.router.done[r].status for r in rids]
    greedy_same = [out[r] == greedy_out[g] for i, (r, g) in
                   enumerate(zip(rids, greedy_rids)) if i % 2 == 0]
    sampled_moved = [out[r] != greedy_out[g] for i, (r, g) in
                     enumerate(zip(rids, greedy_rids)) if i % 2]
    log(f"serve paged: block {RG_BLOCK}, pool {pool} blocks; cache "
        f"{peng.planes[0].cache_bytes():,} B against {eng.planes[0].cache_bytes():,} B "
        f"contiguous (no paged leaves: rec and swa state stay per lane); "
        f"{len(groups)} prefill groups, {len(steps)} decode steps, decode step "
        f"{statistics.median(steps):.3f} ms (median); greedy lanes equal to the "
        f"contiguous greedy run: {sum(greedy_same)}/{len(greedy_same)}; sampled lanes "
        f"(temperature {SAMPLED['temperature']}, top-k {SAMPLED['top_k']}, top-p "
        f"{SAMPLED['top_p']}) that left the greedy tokens: "
        f"{sum(sampled_moved)}/{len(sampled_moved)}")
    check(statuses == ["ok"] * RG_REQUESTS, f"paged request statuses {statuses}")
    check(all(greedy_same), "a greedy lane of the paged run differs from the "
                            "contiguous greedy run")
    check(any(sampled_moved), "no sampled lane left the greedy tokens")
    check(all(0 <= t < cfg.vocab for r in rids for t in out[r]),
          "a token outside the vocabulary")
    check(peng.planes[0].pool.available == pool, "blocks left allocated after the run")
    del peng
    return groups, steps


QW_ARCH = "qwen1.5-4b"
QW_SLOTS, QW_MAX_LEN, QW_NEW_TOKENS, QW_REQUESTS = 8, 1024, 32, 16
QW_PROMPT_LENS = (128, 256, 512)
PAGED_MAX_SHARE = 0.55  # paged cache bytes at most this share of contiguous


def phase_qwen() -> None:
    """(a) qwen1.5-4b at full width through ``repro_torch.launch.serve``:
    contiguous and paged (block 16, the pool sized to the live tokens),
    greedy and sampled on the same seeds; paged tokens must equal the
    contiguous ones in both modes."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import main as serve

    cfg = get_arch(QW_ARCH).lm
    pool = pool_for(QW_SLOTS, max(QW_PROMPT_LENS), QW_NEW_TOKENS, RG_BLOCK)
    base = ["--arch", QW_ARCH, "--requests", str(QW_REQUESTS), "--slots", str(QW_SLOTS),
            "--max-len", str(QW_MAX_LEN), "--max-new-tokens", str(QW_NEW_TOKENS),
            "--prompt-lens", ",".join(map(str, QW_PROMPT_LENS)), "--seed", str(SEED)]
    sampled = ["--temperature", str(SAMPLED["temperature"]), "--top-k",
               str(SAMPLED["top_k"]), "--top-p", str(SAMPLED["top_p"]),
               "--sample-seed", str(SEED + 7)]
    paged = ["--block-size", str(RG_BLOCK), "--pool-blocks", str(pool)]
    log(f"qwen serve: {QW_ARCH} at full width: {cfg.layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} MHA heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}; weights random from seed {SEED} drawn into "
        f"{cfg.dtype}; CUTS (traffic only): {QW_REQUESTS} requests, prompts from "
        f"{QW_PROMPT_LENS}, {QW_NEW_TOKENS} new tokens; flags {' '.join(base)}")
    runs = {}
    for mode, mflags in (("greedy", []), ("sampled", sampled)):
        for layout, lflags in (("contiguous", []), ("paged", paged)):
            flags = base + mflags + lflags
            torch.cuda.reset_peak_memory_stats()
            with ServeTimer() as timer:
                res = serve(flags)
            eng = res["engine"]
            peak = torch.cuda.max_memory_allocated()
            statuses = [r.status for r in eng.router.done.values()]
            n_tok = sum(len(v) for v in res["results"].values())
            runs[mode, layout] = dict(out=res["results"], bytes=eng.planes[0].cache_bytes())
            log(f"qwen serve {mode} {layout}: cache {runs[mode, layout]['bytes']:,} B; "
                f"{len(timer.groups)} prefill groups (median "
                f"{statistics.median(ms for _, ms in timer.groups):.1f} ms), "
                f"{len(timer.steps)} decode steps, decode step "
                f"{statistics.median(timer.steps):.3f} ms (median; host clock to the "
                f"token pull); {n_tok} tokens in {res['wall']:.3f} s "
                f"({n_tok / res['wall']:.1f} tokens/s); peak {peak / 2**30:.2f} GiB "
                f"from the draw on ({timer.base / 2**30:.2f} GiB allocated at the "
                f"first prefill: weights and cache)")
            check(statuses == ["ok"] * QW_REQUESTS, f"qwen {mode} {layout}: {statuses}")
            check(all(len(v) == QW_NEW_TOKENS and all(0 <= t < cfg.vocab for t in v)
                      for v in res["results"].values()), f"qwen {mode} {layout} tokens")
            del res, eng
            torch.cuda.empty_cache()
    share = runs["greedy", "paged"]["bytes"] / runs["greedy", "contiguous"]["bytes"]
    same = {m: runs[m, "paged"]["out"] == runs[m, "contiguous"]["out"]
            for m in ("greedy", "sampled")}
    moved = sum(runs["sampled", "contiguous"]["out"][r] != v
                for r, v in runs["greedy", "contiguous"]["out"].items())
    log(f"qwen serve: paged cache {share:.4f} of contiguous (at most "
        f"{PAGED_MAX_SHARE}; {pool} blocks of {RG_BLOCK} + the null block); paged "
        f"tokens equal to contiguous: greedy {same['greedy']}, sampled "
        f"{same['sampled']}; sampled requests that left the greedy tokens: "
        f"{moved}/{QW_REQUESTS}")
    check(same["greedy"] and same["sampled"], "qwen paged tokens differ from contiguous")
    check(share <= PAGED_MAX_SHARE, f"paged cache share {share:.4f}")
    check(moved > 0, "the sampled run reproduced the greedy tokens")


FL_PLANES, FL_HB_TIMEOUT = 2, 15.0  # the coordinator's heartbeat timeout, s
FL_KILL_TOKENS = 8       # SIGKILL worker 1 once a request it holds has this many
FL_TIMEOUT_S = 600       # the whole fleet run


def fleet_drill(work: str, smoke: bool) -> dict:
    """One drill of (c), on recurrentgemma-2b's smoke config (float32, the
    JAX launcher's traffic: prompts of 4 to 16 tokens, 16 new tokens) or at
    full width (the arch's bf16, the serving cell's traffic): the launcher's
    single-engine run, then ``--role fleet --planes 2`` (two worker
    processes sharing ``cuda:0``) with worker 1 SIGKILLed once a request it
    holds has ``FL_KILL_TOKENS`` tokens.  Returns each request's equality
    with the single engine's tokens."""
    import signal
    import threading

    from repro_torch.launch.serve import main as serve
    from repro_torch.serve import FleetEngine

    label = "smoke, float32" if smoke else "full width, bf16"
    flags = ["--arch", RG_ARCH, "--requests", str(RG_REQUESTS), "--slots", str(RG_SLOTS),
             "--temperature", str(SAMPLED["temperature"]), "--sample-seed",
             str(SEED + 11), "--seed", str(SEED)]
    flags += ["--smoke"] if smoke else [
        "--max-len", str(RG_MAX_LEN), "--max-new-tokens", str(RG_NEW_TOKENS),
        "--prompt-lens", ",".join(map(str, RG_PROMPT_LENS))]
    log(f"fleet ({label}): {RG_ARCH}, {FL_PLANES} worker processes sharing cuda:0; "
        f"flags {' '.join(flags)}")
    ref = serve(flags)
    want = ref["results"]
    log(f"fleet ({label}): the single-engine run: {sum(map(len, want.values()))} tokens "
        f"in {ref['wall']:.3f} s")
    del ref
    torch.cuda.empty_cache()

    fleet_dir = os.path.join(work, "fleet-smoke" if smoke else "fleet")
    box: dict = {}
    restored: list[int] = []
    restore, tick = FleetEngine._restore, FleetEngine.tick

    def recording(fleet, w):  # the requests a dead worker held
        restored.extend(w.inflight)
        return restore(fleet, w)

    def seen(fleet):  # the coordinator, for the kill trigger below
        box["fleet"] = fleet
        return tick(fleet)

    def run():
        try:
            box["res"] = serve(flags + ["--role", "fleet", "--planes", str(FL_PLANES),
                                        "--fleet-dir", fleet_dir,
                                        "--hb-timeout", str(FL_HB_TIMEOUT)])
        except BaseException as e:  # re-raised by the main thread below
            box["error"] = e
        box["done_at"] = time.monotonic()

    def held() -> list[int]:  # token counts of worker 1's requests, as reported
        try:
            return [len(req.out) for req, _ in
                    list(box["fleet"].workers[1].inflight.values())]
        except (KeyError, RuntimeError):  # not started, or changed mid-read
            return []

    FleetEngine._restore, FleetEngine.tick = recording, seen
    coordinator = threading.Thread(target=run, daemon=True)
    coordinator.start()
    deadline = time.monotonic() + FL_TIMEOUT_S
    counts: list[int] = []
    try:
        while coordinator.is_alive() and time.monotonic() < deadline:
            counts = held()
            if counts and max(counts) >= FL_KILL_TOKENS:
                break
            time.sleep(0.002)
        check(counts and max(counts) >= FL_KILL_TOKENS,
              f"worker 1 never held a request of {FL_KILL_TOKENS} tokens "
              f"({box.get('error')})")
        with open(os.path.join(fleet_dir, "w1_a0", "pid")) as f:
            pid = int(f.read())
        killed_at = time.monotonic()
        os.kill(pid, signal.SIGKILL)
        coordinator.join(timeout=FL_TIMEOUT_S)
        check(not coordinator.is_alive(), "the fleet run did not finish")
    finally:
        FleetEngine._restore, FleetEngine.tick = restore, tick
        if coordinator.is_alive():  # a failed drill: stop the workers it left
            for wid in range(FL_PLANES):
                try:
                    with open(os.path.join(fleet_dir, f"w{wid}_a0", "pid")) as f:
                        os.kill(int(f.read()), signal.SIGKILL)
                except (OSError, ValueError):
                    pass
    if "error" in box:
        raise box["error"]
    res = box["res"]
    fleet = res["fleet"]
    verdict = res["dead_at"].get(1)
    same = {r: res["results"][r] == want[r] for r in sorted(want)}
    kept = [r for r in same if r not in restored]
    log(f"fleet ({label}): worker 1 (pid {pid}) SIGKILLed holding {len(counts)} "
        f"requests of {min(counts)}..{max(counts)} reported tokens; verdict "
        f"{'%.3f s' % (verdict - killed_at) if verdict else 'never'} after the "
        f"kill (heartbeat timeout {FL_HB_TIMEOUT} s); last restored request done "
        f"{box['done_at'] - killed_at:.3f} s after the kill; served per worker "
        f"{ {w: h.served for w, h in fleet.workers.items()} }; exit codes "
        f"{res['exit_codes']}; requests equal to the single-engine run: "
        f"{sum(same.values())}/{len(same)} (restored {sum(same[r] for r in restored)}/"
        f"{len(restored)}, not restored {sum(same[r] for r in kept)}/{len(kept)}); "
        f"fleet wall {res['wall']:.3f} s")
    check(verdict is not None, "the coordinator never declared worker 1 dead")
    check(restored, "worker 1 held no request when it died")
    check([r.status for r in fleet.router.done.values()] == ["ok"] * RG_REQUESTS,
          f"fleet statuses {[r.status for r in fleet.router.done.values()]}")
    check(res["exit_codes"][0] == 0, f"worker 0 exit code {res['exit_codes'][0]}")
    return same


def phase_fleet(work: str) -> None:
    """(c) the fleet drill on recurrentgemma-2b at temperature 0.7: on its
    smoke config, float32, where every request's tokens must equal the
    single engine's; then at full width in the arch's bf16, recorded: a
    restore computes the next token's logits by a prefill instead of a
    decode step, another order of bf16 roundings (up to a tenth on the
    smoke config in bf16, in the JAX package as in the port:
    tests/test_torch_serve_fleet.py::test_restored_logits_round_like_jax),
    which can flip a near-tie draw (the count of equal requests, restored
    and not, is logged, not checked)."""
    t0 = time.perf_counter()
    same = fleet_drill(work, smoke=True)
    check(all(same.values()), "a request's tokens after the kill differ from the "
                              "single engine's")
    fleet_drill(work, smoke=False)
    log(f"fleet: phase {time.perf_counter() - t0:.1f} s")


def phase_sampler_card() -> None:
    """(e) the keyed sampler on the card against the CPU: keys, bits and
    uniforms bit-equal; the tokens of [8, 151,936] rows (qwen1.5-4b's
    vocabulary) equal, float32 and bf16 logits, greedy, sampled and filtered
    lanes; the sampler's time for a row of 8 sampled lanes."""
    from repro_torch.serve import keyed_sample, sampling, threefry

    rng = np.random.default_rng(SEED + 13)
    n = 4096
    idx = [rng.integers(0, 2**32, n), rng.integers(0, 2**31, n), rng.integers(0, 4096, n)]
    idx[0][:2] = (2**32 - 1, 2**32 - 2)
    keys = {d: sampling.request_key(*(torch.as_tensor(a, device=d) for a in idx))
            for d in ("cpu", "cuda")}
    keys_equal = all(torch.equal(a, b.cpu()) for a, b in zip(keys["cpu"], keys["cuda"]))
    sub = tuple(k[:64] for k in keys["cuda"]), tuple(k[:64] for k in keys["cpu"])
    bits_equal = torch.equal(threefry.random_bits(sub[0], 151_936).cpu(),
                             threefry.random_bits(sub[1], 151_936))
    unif_equal = torch.equal(threefry.uniform(sub[0], 151_936).cpu(),
                             threefry.uniform(sub[1], 151_936))
    rows = (rng.integers(0, 1000, 8).astype(np.int32),
            rng.integers(0, 2**32, 8, dtype=np.uint32),
            rng.integers(1, 1024, 8).astype(np.int32),
            np.array([0, 0.7, 0.7, 1.3, 0.7, 0.2, 1.0, 0.7], np.float32),
            np.array([0, 0, 50, 0, 50, 10, 0, 1], np.int32),
            np.array([1, 1, 0.9, 0.9, 1, 0.5, 0.95, 1], np.float32))
    toks_equal = {}
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.as_tensor(rng.standard_normal((8, 151_936)).astype(np.float32)
                                 * 3).to(dtype)
        toks_equal[str(dtype)] = torch.equal(keyed_sample(logits.cuda(), *rows).cpu(),
                                             keyed_sample(logits, *rows))
    sampled = rows[:3] + (np.full(8, 0.7, np.float32),) + rows[4:]
    logits = logits.cuda()
    ms = median_ms(lambda: keyed_sample(logits, *sampled), reps=5)
    greedy_ms = median_ms(lambda: keyed_sample(logits, *rows[:3], np.zeros(8, np.float32),
                                               *rows[4:]), reps=5)
    log(f"sampler: {n} request keys CUDA vs CPU bit-equal {keys_equal}; random bits and "
        f"uniforms of 64 x 151,936 bit-equal {bits_equal} / {unif_equal}; tokens of "
        f"[8, 151,936] rows equal {toks_equal}; keyed_sample of 8 sampled lanes "
        f"{ms:.3f} ms, of 8 greedy lanes {greedy_ms:.3f} ms (CUDA events, median of 5)")
    check(keys_equal and bits_equal and unif_equal, "threefry differs between CUDA and CPU")
    check(all(toks_equal.values()), f"sampled tokens differ between CUDA and CPU {toks_equal}")


# ------------------------------------------------------- flash attention
SH_REQUESTS = 8         # sharded serving: 8 requests a run, 8 slots, 32 new tokens
SH_TIMEOUT_S = 900      # the child's whole run


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_child(port: int, out_path: str) -> None:
    """The sharded serving phase's process: a one-rank NCCL group of its own
    and a 1x1 (data x model) mesh over it.  qwen1.5-4b (contiguous, and
    paged at block 16) and recurrentgemma-2b (``use_pallas_scan=True``) at
    full width, each served by ``ServeEngine(mesh=...)`` and by the
    unsharded engine on the same weights and requests (odd requests
    sampled); tokens, decode step ms, peak memory and the sharded runs'
    kernel launches go to ``out_path`` as JSON."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels.diffusion_conv.kernel import hop_project
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.linear_scan.kernel import linear_scan
    from repro_torch.kernels.window_gather.kernel import window_gather
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.lm import model as lm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.tree import tree_leaves

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=device)
    counters = (window_gather, hop_project, linear_scan, flash_attention)
    mesh = MeshSpec(("data", "model"), (1, 1))
    runs = []
    try:
        for arch in (QW_ARCH, RG_ARCH):
            cfg = get_arch(arch).lm
            if arch == RG_ARCH:
                cfg = dataclasses.replace(cfg, use_pallas_scan=True)
            # drawn on the card straight into the compute dtype, as the
            # serving launcher draws them
            params = lm.init(torch.Generator(device="cuda").manual_seed(SEED),
                             dataclasses.replace(cfg, param_dtype=cfg.dtype), device="cuda")
            rng = np.random.default_rng(SEED)
            prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
                       for n in rng.choice(QW_PROMPT_LENS, size=SH_REQUESTS)]
            submit = [dict(SAMPLED, seed=SEED + i) if i % 2 else {}
                      for i in range(SH_REQUESTS)]
            layouts = (("contiguous", None), ("paged", RG_BLOCK)) if arch == QW_ARCH \
                else (("contiguous", None),)
            for layout, block in layouts:
                sc = ServeConfig(slots=QW_SLOTS, max_len=QW_MAX_LEN,
                                 max_new_tokens=QW_NEW_TOKENS, block_size=block,
                                 pool_blocks=pool_for(QW_SLOTS, max(QW_PROMPT_LENS),
                                                      QW_NEW_TOKENS, block) if block else None)
                for sharded in (False, True):
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    eng = ServeEngine(params, cfg, sc, mesh=mesh if sharded else None,
                                      device="cuda")
                    for k in counters:
                        k.launches = 0
                    rids, out, groups, steps, wall = serve_timed(eng, prompts, submit)
                    plane = eng.planes[0]
                    leaves = tree_leaves(plane.cache)
                    runs.append({
                        "arch": arch, "layout": layout, "sharded": sharded,
                        "tokens": [list(map(int, out[r])) for r in rids],
                        "statuses": [eng.router.done[r].status for r in rids],
                        "decode_ms": statistics.median(steps), "steps": len(steps),
                        "groups": len(groups),
                        "prefill_ms": statistics.median(ms for _, ms in groups),
                        "wall": wall, "peak": torch.cuda.max_memory_allocated(),
                        "cache_bytes": plane.cache_bytes(),
                        "dtensor_cache": all(hasattr(t, "placements") for t in leaves),
                        "mesh": plane.mesh.shape if sharded else None,
                        "launches": {k.__name__: k.launches for k in counters}})
                    del eng, plane, leaves
            del params
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"runs": runs, "device": torch.cuda.get_device_name(0)}, f)


def phase_sharded_serving(work) -> int:
    """Serving over a (data x model) mesh: a child process with a one-rank
    NCCL group (``sharded_child``); the sharded tokens must equal the
    unsharded engine's, and recurrentgemma-2b's sharded runs must launch
    ``linear_scan`` on the RG-LRU's local shards.  Returns those launches."""
    import multiprocessing

    t0 = time.perf_counter()
    out_path = os.path.join(work, "sharded.json")
    proc = multiprocessing.get_context("spawn").Process(
        target=sharded_child, args=(free_port(), out_path))
    proc.start()
    proc.join(SH_TIMEOUT_S)
    if proc.is_alive():
        proc.terminate()
        proc.join(10)
    check(proc.exitcode == 0, f"the sharded serving child exited with {proc.exitcode}")
    with open(out_path) as f:
        runs = json.load(f)["runs"]
    log(f"sharded serving: {QW_ARCH} and {RG_ARCH} at full width, {QW_SLOTS} slots, "
        f"max_len {QW_MAX_LEN}; CUTS (traffic only): {SH_REQUESTS} requests (prompts "
        f"from {QW_PROMPT_LENS}, {QW_NEW_TOKENS} new tokens, odd ones sampled "
        f"{SAMPLED}); the mesh is (data 1 x model 1) over a one-rank NCCL group (one "
        f"card: every placement is whole, so the DTensor plane runs the same ops)")
    scan = 0
    for arch, layout in dict.fromkeys((r["arch"], r["layout"]) for r in runs):
        plain, shard = (next(r for r in runs if (r["arch"], r["layout"], r["sharded"])
                             == (arch, layout, s)) for s in (False, True))
        same = plain["tokens"] == shard["tokens"]
        log(f"sharded serving {arch} {layout}: decode step {shard['decode_ms']:.3f} ms "
            f"sharded against {plain['decode_ms']:.3f} ms unsharded (medians of "
            f"{shard['steps']} and {plain['steps']} steps, host clock to the token pull; "
            f"{shard['decode_ms'] / plain['decode_ms']:.2f}x); prefill group "
            f"{shard['prefill_ms']:.1f} against {plain['prefill_ms']:.1f} ms; peak "
            f"{shard['peak'] / 2**30:.2f} against {plain['peak'] / 2**30:.2f} GiB; cache "
            f"{shard['cache_bytes']:,} B (DTensor leaves: {shard['dtensor_cache']}); "
            f"mesh {shard['mesh']}; tokens equal: {same}; sharded launches "
            f"{shard['launches']}")
        check(shard["statuses"] == ["ok"] * SH_REQUESTS == plain["statuses"],
              f"sharded serving {arch} {layout}: statuses")
        check(shard["dtensor_cache"] and shard["cache_bytes"] == plain["cache_bytes"],
              f"sharded serving {arch} {layout}: cache not placed")
        check(same, f"sharded serving {arch} {layout}: tokens differ from the unsharded plane")
        expect_scan = arch == RG_ARCH
        check((shard["launches"]["linear_scan"] > 0) == expect_scan,
              f"sharded serving {arch} {layout}: linear_scan launches "
              f"{shard['launches']['linear_scan']}")
        check(not any(v for k, v in shard["launches"].items() if k != "linear_scan"),
              f"sharded serving {arch} {layout}: another kernel launched")
        scan += shard["launches"]["linear_scan"]
    log(f"sharded serving: phase wall {time.perf_counter() - t0:.1f} s")
    return scan


def flash_inputs(gen, b, s, h, hkv, d, dtype):
    """Random q, k, v in the model layout [B, S, heads, D]."""
    return tuple(torch.randn((b, s, n, d), device="cuda", generator=gen).to(dtype)
                 for n in (h, hkv, hkv))


def phase_flash_kernel(rg_cfg) -> float:
    """flash_attention against its plain version and the port's
    full_attention at recurrentgemma-2b's attention width (bf16, causal)
    over the served prompt-group shapes and the arch's 2,048 window, at the
    JAX kernels bench's GQA shape, and at edge cases.  Returns the max abs
    error at the timed shape."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm.attention import full_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    h, hkv, d = rg_cfg.n_heads, rg_cfg.n_kv_heads, rg_cfg.hd
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"recurrentgemma-2b [{b}, {s}]", (b, s, h, hkv, d), bf16, True)
             for b, s in (FLASH_SHAPE, (4, 256), (4, 128), (1, rg_cfg.window))]
    cases += [("kernels bench GQA 8:2", (1, 512, 8, 2, 64), f32, True),
              ("non-causal, ragged S=100", (2, 100, 4, 2, 64), f32, False),
              ("non-causal, ragged S=300", (1, 300, 4, 2, 64), f32, False),
              ("non-causal, ragged S=300, bf16", (1, 300, h, hkv, d), bf16, False),
              ("MQA", (1, 256, 8, 1, 128), f32, True),
              ("H = Hkv", (2, 128, 6, 6, 32), f32, True)]
    cases += [(f"D = {dd}", (2, 200, 4, 2, dd), f32, True) for dd in (16, 64, 128, 256)]
    # The bf16 tensor-core kernel's edges: GQA, MQA, H = Hkv, ragged S, one
    # token, and head dims that pad (120), swizzle narrowly (16, 32) or take
    # the element loads (33).
    cases += [("bf16 GQA 8:2", (1, 512, 8, 2, 64), bf16, True),
              ("bf16 GQA 8:2, non-causal", (1, 512, 8, 2, 64), bf16, False),
              ("bf16 non-causal, ragged S=100", (2, 100, 4, 2, 128), bf16, False),
              ("bf16 ragged S=33, MQA", (3, 33, 2, 1, 64), bf16, True),
              ("bf16 MQA", (1, 300, 4, 1, 256), bf16, True),
              ("bf16 H = Hkv", (2, 128, 6, 6, 128), bf16, True),
              ("bf16 one token", (1, 1, 4, 2, 64), bf16, True)]
    cases += [(f"bf16 D = {dd}", (2, 200, 4, 2, dd), bf16, dd != 32)
              for dd in (16, 32, 33, 64, 120, 128, 256)]
    err_main = None
    for label, (b, s, nh, nkv, dd), dtype, causal in cases:
        q, k, v = flash_inputs(gen, b, s, nh, nkv, dd, dtype)
        with torch.no_grad():
            got = flash_attention(q, k, v, causal=causal, use_pallas=True)
            torch.cuda.synchronize()
            want = flash_attention(q, k, v, causal=causal)
            full = full_attention(q, k, v, causal=causal)
        err = float((got.float() - want.float()).abs().max())
        err_full = float((got.float() - full.float()).abs().max())
        atol = FLASH_ATOL[dtype]
        ok = err <= atol and err_full <= atol and got.dtype == dtype
        log(f"flash_attention {label} [{b}, {s}, {nh}/{nkv} x {dd}] {dtype} "
            f"causal={causal}: max_abs_err {err:.3e} vs plain, {err_full:.3e} vs "
            f"full_attention (atol {atol}) {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention {label} outside tolerance")
        if err_main is None:
            err_main = err
    return err_main


def flash_bound_ms(b, s, h, hkv, d, itemsize=2) -> tuple[float, str]:
    """q, k, v read once and o written once against 4·D operations per
    visible (query, key) pair of a causal mask, at the bf16 tensor-core peak."""
    nbytes = (2 * b * h * s + 2 * b * hkv * s) * d * itemsize
    flops = 4 * d * b * h * s * (s + 1) // 2
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_flash_times(rg_cfg, launches, err) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    b, s = FLASH_SHAPE
    h, hkv, d = rg_cfg.n_heads, rg_cfg.n_kv_heads, rg_cfg.hd
    q, k, v = flash_inputs(gen, b, s, h, hkv, d, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        ms = median_ms(lambda: flash_attention(q, k, v, use_pallas=True), inner=10,
                       device_only=True)
        plain = median_ms(lambda: flash_attention(q, k, v), inner=5, device_only=True)
        lib = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), inner=20, device_only=True)
    bound, by = flash_bound_ms(b, s, h, hkv, d)
    flops = 4 * d * b * h * s * (s + 1) // 2
    log(f"time: flash_attention [{b}, {s}, {h}/{hkv} x {d}] bf16 causal: {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, "
        f"scaled_dot_product_attention {lib:.4f} ms, bound {bound:.5f} ms ({by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:66",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


# ------------------------------------------------- the measured-dispatch path
def print_verdicts(cache_dir) -> None:
    """Each verdict's candidate table; fails unless the verdict is the
    kernel and no candidate was rejected (on the card only the kernel's
    launch shapes compete)."""
    from repro_torch.kernels.autotune import cache_path, load_cache

    entries = load_cache(cache_path("cuda", cache_dir), "cuda")
    for key, e in sorted(entries.items()):
        rows = []
        for c, r in sorted(e["candidates"].items()):
            row = f"{c} {r['us']} us" if r.get("us") is not None else \
                f"{c} REJECTED ({r['rejected']})"
            if "of_allowance" in r:
                row += (f" [max_abs_err {r['max_abs_err']:.3e}: {r['of_allowance']} of "
                        f"the allowance, {r['of_jax_tol']} of the JAX tolerance]")
            rows.append(row)
        log(f"verdict {key}: dims {e['dims']} -> {e['variant']} {e['params']} "
            f"({e['us']} us); candidates: {', '.join(rows)}")
        check(e["variant"] == "pallas", f"{key}: the verdict is not the kernel")
        for c, r in e["candidates"].items():
            check(c.startswith("pallas"), f"{key}: {c} competed on the card")
            check("rejected" not in r, f"{key}: kernel candidate {c} rejected: {r}")


def dispatch_run(raw, supports, inputs, mode, cache_dir):
    """One run of the measured-dispatch path under ``mode``."""
    from repro_torch.kernels import autotuning, diffusion_conv, flash_attention, linear_scan

    x, w, bias, scans, (q, k, v) = inputs
    with autotuning(mode=mode, cache_dir=cache_dir), torch.no_grad():
        with torch.enable_grad():
            _, _, pipe = stgnn_pipeline(raw, supports, "auto", DISPATCH_STEPS)
            losses = fit_losses(pipe)
        y = diffusion_conv(x, supports, w, bias, k_hops=K_HOPS, impl="auto")
        hs = [linear_scan(a, bb, impl="auto") for a, bb in scans]
        o = flash_attention(q, k, v, impl="auto")
        torch.cuda.synchronize()
    return pipe, losses, y, hs, o


def phase_dispatch(raw, supports, rg_cfg, counters) -> dict:
    """The measured-dispatch path, tuned and then dispatched from the cache;
    returns each kernel's launches by the dispatched calls."""
    from repro_torch.kernels import (autotuning, diffusion_conv, flash_attention,
                                     linear_scan, verdict_for)

    # The reference run: gather="pallas" on the same feed.
    _, _, ref_pipe = stgnn_pipeline(raw, supports, "pallas", DISPATCH_STEPS)
    ref_losses = fit_losses(ref_pipe)
    del ref_pipe

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    n, c = NODES, FEATURES + HIDDEN
    x = torch.randn((BATCH, n, c), device="cuda", generator=gen)
    w = torch.randn(((1 + 2 * K_HOPS) * c, 2 * HIDDEN), device="cuda", generator=gen) / c ** 0.5
    bias = torch.zeros(2 * HIDDEN, device="cuda")
    scans = [scan_inputs(gen, bb, ss, rg_cfg.lru_width) for bb, ss in
             ((RG_SLOTS, 1), FLASH_SHAPE)]
    q, k, v = flash_inputs(gen, *FLASH_SHAPE, rg_cfg.n_heads, rg_cfg.n_kv_heads,
                           rg_cfg.hd, torch.bfloat16)
    inputs = (x, w, bias, scans, (q, k, v))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="tuning-", dir=os.path.join(ROOT, "build"))
    cache_dir = tmp.name

    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    _, losses, *_ = dispatch_run(raw, supports, inputs, "tune", cache_dir)
    tuning = {fn.__name__: fn.launches for fn in counters}
    log(f"dispatch path, tuning run: {time.perf_counter() - t0:.1f} s; launches "
        f"{tuning} (tuning and dispatched calls)")
    check(losses == ref_losses, f"gather='auto' losses {losses} differ from "
                                f"gather='pallas' losses {ref_losses}")
    print_verdicts(cache_dir)

    # The dispatched run: counts from 0, every verdict from the cache file.
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    pipe, losses, y, hs, o = dispatch_run(raw, supports, inputs, "load", cache_dir)
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"dispatch path, from the cache: {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")
    for fn in counters:
        check(launches[fn.__name__] > 0, f"{fn.__name__} was not launched by the "
                                         f"dispatched calls")
    check(losses == ref_losses, f"gather='auto' losses {losses} differ from "
                                f"gather='pallas' losses {ref_losses}")
    log(f"dispatch: gather='auto' losses equal gather='pallas' bit for bit over "
        f"{len(losses)} steps in both runs ({losses[0]:.6f} -> {losses[-1]:.6f})")
    for name, got, want, atol in (
            ("diffusion_conv", y, diffusion_conv(x, supports, w, bias, k_hops=K_HOPS), 1e-4),
            ("linear_scan decode", hs[0][0], linear_scan(*scans[0])[0], 0.0),
            ("linear_scan prefill", hs[1][0], linear_scan(*scans[1])[0], 0.0),
            ("flash_attention", o, flash_attention(q, k, v), FLASH_ATOL[torch.bfloat16])):
        err = float((got.float() - want.float()).abs().max())
        log(f"dispatch: {name} impl='auto' (kernel) vs plain max_abs_err {err:.3e} "
            f"(atol {atol})")
        check(err <= atol, f"{name} through impl='auto' disagrees with its plain version")

    calls = [("gather", (pipe.dataset.series, pipe.batch_of_starts(
                  pipe.dataplane.epoch_global(0)[0])), {"input_len": HORIZON, "horizon": HORIZON}),
             ("diffusion_conv", (x, tuple(supports), w, bias),
              {"k_hops": K_HOPS, "n_supports": len(supports)}),
             *[("linear_scan", (a, bb, torch.zeros_like(a[:, 0])), {}) for a, bb in scans],
             ("flash_attention", (q, k, v), {"causal": True})]
    with autotuning(mode="load", cache_dir=cache_dir):
        for op, args, static in calls:
            vd = verdict_for(op, *args, **static)
            check(vd.source == "cache" and vd.variant == "pallas",
                  f"{op} verdict not the kernel read back from the cache: {vd}")
    log(f"dispatch: all {len(calls)} verdicts read back from the cache file under "
        f"mode='load', each the kernel")
    tmp.cleanup()
    return launches


# --------------------------------------------- distributed-index-batching
DIST_ENTRIES = 105_120  # PeMS-All-LA's full year of 5-minute bins, uncut
DIST_WORLD = 2          # two processes sharing the one card, over gloo
DIST_BATCHES = 5        # per-rank batches in the train pool; steps per run
DIST_RUNS = (("replicated", True), ("partitioned", True), ("partitioned", False),
             ("ondemand", True))
DIST_TIMEOUT_S = 900    # the children's collectives, and their join
DIST_W1_ENTRIES = 600   # the world-1 launcher run: 577 windows, 12 steps of 32


def dist_pool(entries: int) -> np.ndarray:
    """The train pool of the distributed phase: from each rank's shard, the
    train windows strictly interior to it (so with and without halo alike),
    every k-th, k chosen so that the rank holds DIST_BATCHES batches of
    BATCH // DIST_WORLD windows.  A prefix of the train split would leave
    rank 1's shard empty."""
    from repro_torch.core.distributed import local_window_ids
    from repro_torch.core.windows import WindowSpec, split_windows, window_starts

    spec = WindowSpec(horizon=HORIZON, input_len=HORIZON)
    train, _, _ = split_windows(len(window_starts(entries, spec)), 0.7, 0.1)
    n = DIST_BATCHES * (BATCH // DIST_WORLD)
    parts = []
    for r in range(DIST_WORLD):
        ids = local_window_ids(entries, spec, r, DIST_WORLD, halo=False)
        ids = ids[np.isin(ids, train)]
        parts.append(ids[::len(ids) // n][:n])
    return np.concatenate(parts)


def dist_child(rank: int, port: int, series_path: str, pool, out_path: str) -> None:
    """One rank of the distributed phase: PGT-DCRNN at full width over the
    uncut series, each placement built, trained DIST_BATCHES steps and
    evaluated once; the numbers go to ``out_path`` as JSON."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import IndexDataset, WindowSpec
    from repro_torch.core.distributed import Placement, choose_backend
    from repro_torch.kernels.window_gather.kernel import window_gather
    from repro_torch.kernels.window_gather.ref import window_gather_ref
    from repro_torch.models import pgt_dcrnn
    from repro_torch.optim import AdamConfig
    from repro_torch.pipeline import PipelineConfig, build_pipeline
    from repro_torch.pipeline.gathers import EXCHANGE_IMPL, exchange_windows
    from repro_torch.train import TrainLoopConfig

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = choose_backend(device, DIST_WORLD)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=DIST_WORLD,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        _, supports = graph()
        cfg = pgt_dcrnn.PGTDCRNNConfig(num_nodes=NODES, in_features=FEATURES,
                                       out_features=1, hidden=HIDDEN,
                                       max_diffusion_step=K_HOPS,
                                       input_len=HORIZON, horizon=HORIZON)
        spec = WindowSpec(horizon=HORIZON, input_len=HORIZON)
        t0 = time.perf_counter()
        raw = np.load(series_path, mmap_mode="r")
        ds = dataclasses.replace(IndexDataset.from_raw(raw, spec), train_windows=pool)
        whole = torch.as_tensor(ds.series)  # the full host series, for the checks
        prep_s = time.perf_counter() - t0

        def loss_fn(p, x, y):
            return pgt_dcrnn.loss_fn(p, cfg, supports, x, y), {}

        out = {"backend": backend, "prep_s": prep_s, "runs": []}
        for placement, halo in DIST_RUNS:
            params = pgt_dcrnn.init(torch.Generator().manual_seed(SEED), cfg, device=device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            pipe = build_pipeline(
                None, spec, loss_fn, params,
                PipelineConfig(batch_per_rank=BATCH // DIST_WORLD,
                               placement=Placement(placement), halo=halo,
                               gather="pallas", seed=SEED, device=str(device),
                               adam=AdamConfig(lr=1e-3),
                               loop=TrainLoopConfig(epochs=1, log_every=1)),
                dataset=ds)
            dp = pipe.dataplane
            window_gather.launches = 0
            with StepTimer() as timer:
                state, history = pipe.fit(eval_fn=None)
            torch.cuda.synchronize()
            launches = window_gather.launches
            val = pipe.evaluate(state["params"], split="val")
            peak = torch.cuda.max_memory_allocated()
            # The first batch of this rank, gathered as its train step does
            # (the kernel from its resident rows, or the exchange), against
            # the plain gather over the full host series at the global starts.
            row = dp.epoch_grid(0)[0]
            starts = dp.batch_of_starts(row)
            if dp.train_exchange:
                lo = dp.dataset.origin
                got = exchange_windows(dp.dataset.series, starts, span=spec.span,
                                       owned=(dp.owned[0] - lo, dp.owned[1] - lo),
                                       impl=EXCHANGE_IMPL["pallas"])[dp.block]
                ids = row[dp.block]
            else:
                got = window_gather(dp.dataset.series.reshape(len(dp.dataset.series), -1),
                                    starts, span=spec.span)
                ids = row
            torch.cuda.synchronize()
            want = window_gather_ref(whole, torch.as_tensor(ds.starts[ids]), span=spec.span)
            d = pipe.describe()
            out["runs"].append({
                "placement": placement, "halo": halo, "sampler": d["sampler"],
                "rows": list(d["resident_rows"]), "bytes": d["resident_bytes"],
                "peak": peak, "losses": [r["loss"] for r in history if "epoch_time_s" not in r],
                "val": val, "step_ms": timer.ms, "exchange_bytes": dp.exchange_bytes,
                "launches": launches, "steps": pipe.steps_per_epoch,
                "first_batch_equal": bool(torch.equal(got.cpu().reshape(want.shape), want)),
            })
            del pipe, dp, state, params, starts, got
        with open(out_path, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_distributed(adj, work) -> int:
    """World 2 on the one card (two processes over gloo, spawned here) under
    each placement, then world 1 over NCCL through the launcher under
    ``torch.distributed.run``.  Returns window_gather's launches on both
    ranks' train runs."""
    import multiprocessing
    import socket

    from repro_torch.data import make_traffic_series

    t0 = time.perf_counter()
    raw = make_traffic_series(DIST_ENTRIES, NODES, FEATURES, seed=SEED, adjacency=adj)
    series_path = os.path.join(work, "series.npy")
    np.save(series_path, raw)
    del raw
    pool = dist_pool(DIST_ENTRIES)
    log(f"distributed: PeMS-All-LA-shaped series [{DIST_ENTRIES}, {NODES}, {FEATURES}] "
        f"({DIST_ENTRIES * NODES * FEATURES * 4:,} bytes) made and saved in "
        f"{time.perf_counter() - t0:.1f} s; CUT: the train pool is every k-th train window "
        f"strictly inside each rank's shard, {DIST_BATCHES} batches of "
        f"{BATCH // DIST_WORLD} a rank ({len(pool)} windows, ids {pool[0]}..{pool[-1]}), "
        f"so each run is {DIST_BATCHES} steps of global batch {BATCH}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    outs = [os.path.join(work, f"rank{r}.json") for r in range(DIST_WORLD)]
    procs = [ctx.Process(target=dist_child, args=(r, port, series_path, pool, outs[r]))
             for r in range(DIST_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + DIST_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    check(codes == [0] * DIST_WORLD, f"distributed children exited with {codes}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    log(f"distributed: world {DIST_WORLD} on cuda:0, backend {ranks[0]['backend']} (the "
        f"topology's: {DIST_WORLD} processes, {torch.cuda.device_count()} card); wall "
        f"{time.perf_counter() - t0:.1f} s, host set-up a rank "
        f"{max(r['prep_s'] for r in ranks):.1f} s")
    check(all(r["backend"] == "gloo" for r in ranks), "world 2 on one card must use gloo")
    launches = 0
    replicated = [r["runs"][0] for r in ranks]
    for i, (placement, halo) in enumerate(DIST_RUNS):
        runs = [r["runs"][i] for r in ranks]
        name = placement + ("" if halo or placement != "partitioned" else " (no halo)")
        for rank, run in enumerate(runs):
            share = run["bytes"] / replicated[rank]["bytes"]
            log(f"distributed: {name} rank {rank}: rows [{run['rows'][0]}, {run['rows'][1]}) "
                f"{run['bytes']:,} bytes ({share:.4f} of replicated), {run['sampler']}; "
                f"peak device memory {run['peak']:,} bytes ({run['peak'] / 2**30:.3f} GiB); "
                f"step {statistics.median(run['step_ms'][1:]):.3f} ms (median of steps "
                f"2..{len(run['step_ms'])}; all: "
                f"{', '.join(f'{t:.1f}' for t in run['step_ms'])}); exchange "
                f"{run['exchange_bytes']:,} bytes a step; window_gather launches "
                f"{run['launches']}; loss {run['losses'][0]:.6f} -> {run['losses'][-1]:.6f}; "
                f"val {run['val']!r}")
            check(run["steps"] == DIST_BATCHES and len(run["losses"]) == DIST_BATCHES
                  and all(np.isfinite(run["losses"])), f"{name} rank {rank}: losses "
                                                       f"{run['losses']}")
            check(run["launches"] >= DIST_BATCHES, f"{name} rank {rank}: the train steps "
                                                   f"did not go through window_gather")
            check(run["first_batch_equal"], f"{name} rank {rank}: the first batch differs "
                                            f"from the plain gather over the full series")
            if placement != "replicated":
                check(share <= 0.51, f"{name} rank {rank} keeps {share:.4f} of the series")
            launches += run["launches"]
        check(runs[0]["val"] == runs[1]["val"], f"{name}: val losses differ between "
                                                f"ranks: {runs[0]['val']} {runs[1]['val']}")
        check(runs[0]["losses"] == runs[1]["losses"], f"{name}: ranks log different losses")
        if placement == "ondemand":
            same = all(run["losses"] == rep["losses"] for run, rep in zip(runs, replicated))
            log(f"distributed: ondemand losses {'equal' if same else 'DIFFER from'} "
                f"replicated's bit for bit on both ranks")
            check(same, "ondemand losses differ from replicated's")
    log("distributed: every first batch equals the plain gather over the full host "
        "series at the global starts; every val loss is one number across ranks")

    # World 1 over NCCL through the launcher under torch.distributed.run.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    hist = os.path.join(work, "w1.jsonl")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
           "--master-addr", "127.0.0.1", "--master-port", str(port),
           "-m", "repro_torch.launch.train", "--init-distributed", "--placement",
           "partitioned", "--gather", "pallas", "--arch", "pgt-dcrnn-pems-all-la",
           "--entries", str(DIST_W1_ENTRIES), "--batch", str(BATCH), "--seed", str(SEED),
           "--lr", "1e-3", "--log-every", "1", "--history-out", hist]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    for line in run.stdout.splitlines():
        log(f"  launcher: {line}")
    check(run.returncode == 0, f"world-1 launcher run exited {run.returncode}: "
                               f"{run.stderr[-3000:]}")
    check("backend nccl on cuda:0" in run.stdout, "world 1 on its own card must use nccl")
    with open(hist) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows if "epoch_time_s" not in r]
    log(f"distributed: world 1 over NCCL through the launcher: {len(losses)} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, val MAE {rows[-1].get('val_mae')}; wall "
        f"{time.perf_counter() - t0:.1f} s; CUT: {DIST_W1_ENTRIES} entries")
    check(len(losses) > 0 and all(np.isfinite(losses)), f"world-1 losses {losses}")
    return launches



# ------------------------------------------------------------ elastic training
EL_WORLD = 4              # (a): logical ranks in one process, BATCH // 4 a rank
EL_DEAD, EL_DEAD_AT, EL_BACK_AT = (1, 2), 6, 12  # (a): who goes silent, when, when back
EL_EPOCHS = 2
EL_ENTRIES = 2_000        # (b), (c): the launcher's default series length
EL_KILL_AT = 5            # (b), (c): SIGKILL once the victim's beat shows this step
EL_HB_TIMEOUT = 10.0      # (b), (c): real seconds; a step of two ranks is ~0.21 s
EL_CHILD_TIMEOUT = 600    # any one child of (b), (c)


class DeadThenBack:
    """``step_feed`` fake of (a): ranks ``EL_DEAD`` stop beating at step
    EL_DEAD_AT while the clock jumps past the heartbeat timeout (the next
    poll plans a shrink); from step EL_BACK_AT they beat again from outside
    the shrunk world (ids >= world), which plans a grow."""

    def __init__(self, clock):
        self.clock, self.killed = clock, False

    def __call__(self, step: int, world: int) -> dict:
        self.clock[0] += 1.0
        beats = {r: (step, None) for r in range(world)}
        if not self.killed and world == EL_WORLD and step >= EL_DEAD_AT:
            for r in EL_DEAD:
                del beats[r]
            self.clock[0] += 100.0
            self.killed = True
        if world < EL_WORLD and step >= EL_BACK_AT:
            beats.update({world + i: (step, None) for i in range(len(EL_DEAD))})
        return beats


def phase_elastic_inprocess(raw, supports, work) -> int:
    """(a): world 4 in one process loses ranks 1 and 2 at step 6 and gets
    them back at step 12, through ``build_pipeline(..., elastic=...).fit()``;
    held bit for bit against the uninterrupted world-4 run.  Returns
    window_gather's launches on the elastic run."""
    from repro_torch.kernels.window_gather.kernel import window_gather
    from repro_torch.pipeline import ElasticConfig

    runs = {}
    for label in ("uninterrupted", "elastic"):
        clock = [0.0]
        elastic = (ElasticConfig(heartbeat_timeout=50.0, clock=lambda: clock[0],
                                 step_feed=DeadThenBack(clock))
                   if label == "elastic" else None)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, _, pipe = stgnn_pipeline(raw, supports, "pallas", TRAIN_STEPS, world=EL_WORLD,
                                    elastic=elastic, epochs=EL_EPOCHS,
                                    ckpt_dir=os.path.join(work, label))
        window_gather.launches = 0
        with StepTimer() as steps:
            state, history = pipe.fit()
        torch.cuda.synchronize()
        # keep numbers, not the pipeline: a live plane's series would count
        # in the next run's peak
        runs[label] = dict(
            state=_leaves(state), spans=steps.spans, launches=window_gather.launches,
            peak=torch.cuda.max_memory_allocated(), restarts=pipe.restarts,
            series_bytes=int(pipe.dataset.series.nbytes),
            losses=[r["loss"] for r in history if "epoch_time_s" not in r],
            val=[r["val_mae"] for r in history if "epoch_time_s" in r])
        del pipe, state
    smooth, el = runs["uninterrupted"], runs["elastic"]
    recs = [(r["kind"], r["step"], r["world"], r["batch_per_rank"]) for r in el["restarts"]]
    series_bytes = el["series_bytes"]
    same_state = all(torch.equal(a, b) for a, b in zip(smooth["state"], el["state"],
                                                       strict=True))
    # re-mesh wall: from the end of the step whose poll raised the plan to
    # the start of the first resumed step (span i is global step i + 1: an
    # in-process restart resumes at the failure step itself)
    spans = el["spans"]
    walls = [(spans[r["step"]][0] - spans[r["step"] - 1][1]) * 1e3 for r in el["restarts"]]
    bounds = [0] + [r["step"] for r in el["restarts"]] + [len(spans)]
    ms = [(b - a) * 1e3 for a, b in spans]
    phases = [statistics.median(ms[lo:hi][1 if lo == 0 else 0:])
              for lo, hi in zip(bounds, bounds[1:])]
    smooth_ms = statistics.median((b - a) * 1e3 for a, b in smooth["spans"][1:])
    log(f"elastic (a): world {EL_WORLD} x batch {BATCH // EL_WORLD} in one process, "
        f"{EL_EPOCHS} epochs of {TRAIN_STEPS} steps; ranks {list(EL_DEAD)} silent at step "
        f"{EL_DEAD_AT}, back from step {EL_BACK_AT}: restarts (kind, step, world, batch a "
        f"rank) {recs}")
    log(f"elastic (a): re-mesh wall {', '.join(f'{w:.1f}' for w in walls)} ms (end of the "
        f"step that raised the plan to the start of the first resumed step: checkpoint, "
        f"plane rebuilt, step rebuilt, restore); median step ms by phase "
        f"{', '.join(f'{p:.3f}' for p in phases)} (uninterrupted {smooth_ms:.3f}); peak "
        f"device memory {el['peak']:,} bytes against {smooth['peak']:,} uninterrupted "
        f"(series {series_bytes:,} bytes); window_gather launches {el['launches']}")
    log(f"elastic (a): losses {'equal' if el['losses'] == smooth['losses'] else 'DIFFER'}, "
        f"val_mae {el['val']} vs {smooth['val']}, final state "
        f"{'identical' if same_state else 'DIFFERS'} against the uninterrupted run")
    check([r[0] for r in recs] == ["shrink", "grow"], f"restarts {recs}")
    check([(r[2], r[3]) for r in recs] == [(EL_WORLD - len(EL_DEAD), 2 * BATCH // EL_WORLD),
                                           (EL_WORLD, BATCH // EL_WORLD)], f"restarts {recs}")
    check(el["losses"] == smooth["losses"] and len(el["losses"]) == EL_EPOCHS * TRAIN_STEPS,
          "elastic losses differ from the uninterrupted run's")
    check(el["val"] == smooth["val"] and len(el["val"]) == EL_EPOCHS,
          f"elastic val_mae {el['val']} differs from {smooth['val']}")
    check(same_state, "the elastic run's final state differs from the uninterrupted run's")
    check(el["launches"] > 0, "the elastic run did not launch window_gather")
    check(el["peak"] < smooth["peak"] + series_bytes // 2,
          "the re-mesh held two copies of the series on the device")
    return el["launches"]


def _leaves(tree):
    from repro_torch.tree import tree_leaves

    return [torch.as_tensor(x) for x in tree_leaves(tree)]


class ElasticFleet:
    """Ranks of the launcher spawned here (not under torch.distributed.run,
    whose agent would stop the survivors), sharing cuda:0 over gloo, with
    the rendezvous store hosted here so no rank's death takes it along."""

    def __init__(self, work: str, extra: list):
        self.work, self.extra = work, extra
        self.procs: list = []
        self.stores: list = []

    def launch(self, world: int, tag: str, per_rank=None) -> list:
        import socket

        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        argv = [sys.executable, "-m", "repro_torch.launch.train", *self.extra]
        if world > 1:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            self.stores.append(torch.distributed.TCPStore(
                "127.0.0.1", port, world_size=world, is_master=True, wait_for_workers=False))
            env.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       TORCHELASTIC_USE_AGENT_STORE="True", TORCHELASTIC_RESTART_COUNT="0")
            argv.append("--init-distributed")
        procs = []
        for rank in range(world):
            out = open(os.path.join(self.work, f"{tag}{rank}.log"), "w")
            procs.append(subprocess.Popen(
                argv + list((per_rank or {}).get(rank, ())), cwd=ROOT, stdout=out,
                stderr=subprocess.STDOUT, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank))))
        self.procs += procs
        return procs

    def beat(self, rank: int) -> dict:
        try:
            with open(os.path.join(self.work, "hb", f"hb_{rank}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"step": -1, "wall": 0.0}

    def kill_at(self, procs, rank: int) -> float:
        """SIGKILL ``procs[rank]`` once its beat shows step >= EL_KILL_AT;
        returns the kill's wall time."""
        deadline = time.monotonic() + EL_CHILD_TIMEOUT
        while self.beat(rank)["step"] < EL_KILL_AT:
            check(time.monotonic() < deadline and all(p.poll() is None for p in procs),
                  f"rank {rank} never beat step {EL_KILL_AT}: {self.tail(procs)}")
            time.sleep(0.02)
        procs[rank].kill()
        return time.time()

    def wait(self, procs, *, first_after: int | None = None, on_resume=None):
        """Exit codes and wall exit times of ``procs``; with ``first_after``,
        also the wall time of rank 0's first beat past that step (calling
        ``on_resume`` then)."""
        deadline = time.monotonic() + EL_CHILD_TIMEOUT
        codes, ends, first = [None] * len(procs), [None] * len(procs), None
        while None in codes:
            for i, p in enumerate(procs):
                if codes[i] is None and p.poll() is not None:
                    codes[i], ends[i] = p.returncode, time.time()
            if first_after is not None and first is None:
                b = self.beat(0)
                if b["step"] > first_after:
                    first = b["wall"]
                    if on_resume is not None:
                        on_resume()
            if time.monotonic() > deadline:
                check(False, f"a child ran past {EL_CHILD_TIMEOUT} s: {self.tail(procs)}")
            time.sleep(0.02)
        return codes, ends, first

    def tail(self, procs) -> str:
        return " | ".join(open(os.path.join(self.work, n)).read()[-1500:]
                          for n in sorted(os.listdir(self.work)) if n.endswith(".log"))

    def lines(self, tag: str, *keys: str) -> list[str]:
        out = []
        for n in sorted(os.listdir(self.work)):
            if n.startswith(tag) and n.endswith(".log"):
                out += [f"{n[:-4]}: {line}" for line in open(os.path.join(self.work, n))
                        if any(k in line for k in keys)]
        return out

    def plan(self) -> dict:
        with open(os.path.join(self.work, "plan.json")) as f:
            return json.load(f)

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self.stores.clear()


def _resumed_from(fleet, tag: str) -> int:
    found = [int(line.split("resuming from step ")[1]) for line in
             fleet.lines(tag, "resuming from step ")]
    check(len(found) > 0, f"{tag}: no resume line: {fleet.tail([])}")
    return found[0]


def _check_history(path: str, what: str) -> int:
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    steps = [r["step"] for r in rows if "epoch_time_s" not in r]
    losses = [r["loss"] for r in rows if "epoch_time_s" not in r]
    check(steps == list(range(1, len(steps) + 1)),
          f"{what}: history steps not 1..n once each in order: {steps}")
    check([r["epoch"] for r in rows if "epoch_time_s" in r] == [0],
          f"{what}: epoch summaries {[r for r in rows if 'epoch_time_s' in r]}")
    check(all(np.isfinite(losses)), f"{what}: non-finite losses")
    return len(steps)


LAUNCH_LINES = ("peer failure", "leader ", "resuming from", "re-mesh requested", "done:",
                "backend", "Error", "error")


def phase_elastic_processes(work) -> None:
    """(b) kill rank 1 → shrink → grow, and (c) kill rank 0 → succession,
    each through the launcher on real processes sharing cuda:0."""
    import threading

    from repro_torch.distributed import FileHeartbeatTransport

    common = ["--arch", "pgt-dcrnn-pems-all-la", "--gather", "pallas",
              "--batch", str(BATCH), "--entries", str(EL_ENTRIES), "--seed", str(SEED),
              "--lr", "1e-3", "--log-every", "1", "--elastic", "--elastic-remesh",
              "relaunch", "--heartbeat-timeout", str(EL_HB_TIMEOUT)]
    for cycle in ("b", "c"):
        run = os.path.join(work, cycle)
        os.makedirs(run)
        extra = [*common, "--heartbeat", f"file:{os.path.join(run, 'hb')}",
                 "--target-world", "2", "--plan-out", os.path.join(run, "plan.json"),
                 "--ckpt-dir", os.path.join(run, "ck"),
                 "--history-out", os.path.join(run, "history.jsonl")]
        fleet = ElasticFleet(run, extra)
        try:
            if cycle == "b":
                _cycle_kill_rank1(fleet, FileHeartbeatTransport, threading)
            else:
                _cycle_kill_rank0(fleet)
            n = _check_history(os.path.join(run, "history.jsonl"), f"({cycle})")
            log(f"elastic ({cycle}): the one history file holds steps 1..{n} once each, "
                f"in order, finite losses, one epoch summary")
        finally:
            fleet.close()


def _cycle_kill_rank1(fleet, transport_cls, threading) -> None:
    t0 = time.time()
    procs = fleet.launch(2, "a", per_rank={0: ["--ckpt-every", "1"], 1: ["--ckpt-every", "1"]})
    killed = fleet.kill_at(procs, 1)
    codes, ends, _ = fleet.wait(procs)
    for line in fleet.lines("a", *LAUNCH_LINES):
        log(f"  {line.rstrip()}")
    plan = fleet.plan()
    log(f"elastic (b): rank 1 SIGKILLed at its step-{EL_KILL_AT} beat "
        f"{killed - t0:.1f} s after launch; exit codes {codes}; kill to survivor's exit "
        f"{(ends[0] - killed) * 1e3:.0f} ms (heartbeat timeout {EL_HB_TIMEOUT} s); plan "
        f"{plan['kind']} dropping {plan['dropped_workers']} decided by "
        f"{plan['decided_by']} at step {plan['step']}")
    check(codes == [75, -9], f"(b) kill: exit codes {codes}: {fleet.tail(procs)}")
    check((plan["kind"], plan["dropped_workers"], plan["decided_by"]) == ("shrink", [1], 0),
          f"(b) shrink plan {plan}")
    shrink_step = plan["step"]

    # world 1, the same global batch; rank 1 announces from outside the world
    stop = threading.Event()

    def announce():
        hb = transport_cls(os.path.join(fleet.work, "hb"))
        step = 0
        while not stop.is_set():
            hb.emit(1, step)
            step += 1
            time.sleep(0.02)

    announcer = threading.Thread(target=announce, daemon=True)
    t1 = time.time()
    (b,) = fleet.launch(1, "b", per_rank={0: ["--ckpt-every", "1", "--resume"]})
    try:
        codes, _, first = fleet.wait([b], first_after=shrink_step, on_resume=announcer.start)
    finally:
        stop.set()
        if announcer.is_alive():
            announcer.join()
    plan = fleet.plan()
    resumed = _resumed_from(fleet, "b")
    log(f"elastic (b): world-1 relaunch resumed from step {resumed}, first step "
        f"{first - t1:.1f} s after launch; exit {codes}; plan {plan['kind']} re-admitting "
        f"{plan['readmitted_workers']} at step {plan['step']}")
    check(codes == [75] and resumed == shrink_step, f"(b) world 1: {fleet.tail([b])}")
    check((plan["kind"], plan["readmitted_workers"]) == ("grow", [1]), f"(b) grow plan {plan}")

    grow_step = plan["step"]
    t2 = time.time()
    procs = fleet.launch(2, "c", per_rank={0: ["--ckpt-every", "1", "--resume"],
                                           1: ["--ckpt-every", "1", "--resume"]})
    codes, _, first = fleet.wait(procs, first_after=grow_step)
    for line in fleet.lines("c", "done:", "resuming"):
        log(f"  {line.rstrip()}")
    log(f"elastic (b): world-2 relaunch resumed from step {_resumed_from(fleet, 'c')}, first "
        f"step {first - t2:.1f} s after launch; exit codes {codes}")
    check(codes == [0, 0] and _resumed_from(fleet, "c") == grow_step,
          f"(b) world 2 again: {fleet.tail(procs)}")


def _cycle_kill_rank0(fleet) -> None:
    t0 = time.time()
    procs = fleet.launch(2, "ka", per_rank={0: ["--ckpt-every", "0"], 1: ["--ckpt-every", "1"]})
    killed = fleet.kill_at(procs, 0)
    codes, ends, _ = fleet.wait(procs)
    for line in fleet.lines("ka", *LAUNCH_LINES):
        log(f"  {line.rstrip()}")
    plan = fleet.plan()
    kept = sorted(os.listdir(os.path.join(fleet.work, "ck")))
    log(f"elastic (c): rank 0 (the leader, --ckpt-every 0) SIGKILLed at its "
        f"step-{EL_KILL_AT} beat {killed - t0:.1f} s after launch; exit codes {codes}; kill "
        f"to the successor's exit {(ends[1] - killed) * 1e3:.0f} ms; plan {plan['kind']} "
        f"dropping {plan['dropped_workers']} decided by {plan['decided_by']} at step "
        f"{plan['step']}; checkpoints on disk {kept}")
    check(codes == [-9, 75], f"(c) kill: exit codes {codes}: {fleet.tail(procs)}")
    check((plan["kind"], plan["dropped_workers"], plan["decided_by"]) == ("shrink", [0], 1),
          f"(c) plan {plan}")
    check(kept == [f"step_{plan['step']:010d}"],
          f"(c) the takeover checkpoint is not the only one: {kept}")
    t1 = time.time()
    (b,) = fleet.launch(1, "kb", per_rank={0: ["--ckpt-every", "1", "--resume"]})
    codes, _, first = fleet.wait([b], first_after=plan["step"])
    resumed = _resumed_from(fleet, "kb")
    log(f"elastic (c): world-1 relaunch resumed from step {resumed} (the takeover step "
        f"{plan['step']}), first step {first - t1:.1f} s after launch; exit {codes}")
    check(codes == [0] and resumed == plan["step"], f"(c) world 1: {fleet.tail([b])}")


# ------------------------------------- the §5.5 models: A3T-GCN and ST-LLM
BAY_NODES, BAY_ENTRIES = 325, 52_105  # PeMS-Bay (Table 1), uncut
S55_STEPS = 20         # train steps of each arm, BATCH windows each
A3T_LR, STLLM_LR = 5e-3, 1e-3
S55_TEST_WINDOWS = 64  # test MSE of both A3T-GCN arms


def bay_graph_and_data():
    """A PeMS-Bay-shaped graph and series from SEED: the symmetric-normalised
    adjacency (A3T-GCN's GCN support) and all 52,105 entries."""
    from repro_torch.data import (gaussian_adjacency, make_traffic_series,
                                  random_sensor_coords, sym_norm_adjacency)

    t0 = time.perf_counter()
    adj = gaussian_adjacency(random_sensor_coords(BAY_NODES, seed=SEED))
    raw = make_traffic_series(BAY_ENTRIES, BAY_NODES, FEATURES, seed=SEED, adjacency=adj)
    log(f"section 5.5 models: synthetic PeMS-Bay-shaped series {raw.shape} ({raw.nbytes:,} "
        f"bytes, uncut) in {time.perf_counter() - t0:.1f} s")
    return torch.as_tensor(sym_norm_adjacency(adj), dtype=torch.float32, device="cuda"), raw


def s55_dataset(raw):
    """The series' windows (12 in, 12 out), the train split cut to the
    S55_STEPS batches."""
    from repro_torch.core import IndexDataset, WindowSpec

    spec = WindowSpec(horizon=HORIZON, input_len=HORIZON)
    ds = IndexDataset.from_raw(raw, spec)
    return spec, dataclasses.replace(ds, train_windows=ds.train_windows[:S55_STEPS * BATCH])


def s55_fit(spec, ds, loss_fn, params, lr: float):
    """One epoch of S55_STEPS steps through ``build_pipeline(...,
    gather="pallas")``, each step timed on the host around a synchronize.
    Returns (pipe, state, losses, step ms, the fit's peak bytes above what
    was allocated before it)."""
    from repro_torch.optim import AdamConfig
    from repro_torch.pipeline import PipelineConfig, build_pipeline
    from repro_torch.train import TrainLoopConfig

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    pipe = build_pipeline(None, spec, loss_fn, params,
                          PipelineConfig(batch_per_rank=BATCH, gather="pallas", seed=SEED,
                                         device="cuda", adam=AdamConfig(lr=lr),
                                         loop=TrainLoopConfig(epochs=1, log_every=1)),
                          dataset=ds)
    with StepTimer() as timer:
        state, history = pipe.fit(eval_fn=None)
    peak = torch.cuda.max_memory_allocated() - before
    losses = [r["loss"] for r in history if "epoch_time_s" not in r]
    check(len(losses) == S55_STEPS, f"expected {S55_STEPS} steps, got {len(losses)}")
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    return pipe, state, losses, timer.ms, peak


def phase_a3tgcn(a_hat, spec, ds, profile: bool) -> int:
    """Table 6: A3T-GCN trained on index-batched windows (the gather from the
    resident series through the CUDA kernel) and on materialised windows,
    the same S55_STEPS batches of window ids, bit-equal.  Returns
    window_gather's count read just after the index arm (its fit and test
    batch); the base arm and the timings run after it."""
    from repro_torch.core.batching import materialize_windows
    from repro_torch.kernels.window_gather.kernel import window_gather
    from repro_torch.models import a3tgcn
    from repro_torch.optim import AdamConfig
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = a3tgcn.A3TGCNConfig(num_nodes=BAY_NODES, in_features=FEATURES)
    params = a3tgcn.init(torch.Generator().manual_seed(SEED), cfg, device="cuda")

    def loss_fn(p, x, y):
        return a3tgcn.loss_fn(p, cfg, a_hat, x, y), {}

    pipe, index_state, index_losses, index_ms, index_peak = s55_fit(
        spec, ds, loss_fn, params, A3T_LR)
    test_ids = ds.test_windows[:S55_TEST_WINDOWS]
    with torch.no_grad():
        index_mse = float(pipe._eval_loss(index_state["params"],
                                          pipe.batch_of_starts(test_ids))[0])
    launches = window_gather.launches
    resident = pipe.dataset.series.nbytes + pipe.dataset.starts.nbytes
    grid = pipe.dataplane.epoch_global(0)

    # The base arm: every window of the series materialised (Alg. 1) and
    # moved to the card, then the same batches of ids through make_train_step.
    t0 = time.perf_counter()
    xs, ys = materialize_windows(np.asarray(ds.series), ds.starts, HORIZON, HORIZON)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    xs_d, ys_d = torch.as_tensor(xs).to("cuda"), torch.as_tensor(ys).to("cuda")
    materialised = xs_d.nbytes + ys_d.nbytes
    del xs, ys

    def loss_base(p, ids):
        return a3tgcn.loss_fn(p, cfg, a_hat, xs_d[ids], ys_d[ids]), {}

    adam = AdamConfig(lr=A3T_LR)
    step = make_train_step(loss_base, adam, lambda s: A3T_LR)
    state, base_losses, base_ms = init_train_state(params, adam), [], []
    for ids in grid:
        ids = torch.as_tensor(ids, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, ids)
        torch.cuda.synchronize()
        base_ms.append((time.perf_counter() - t0) * 1e3)
        base_losses.append(float(metrics["loss"]))
    with torch.no_grad():
        base_mse = float(loss_base(state["params"], torch.as_tensor(test_ids, device="cuda"))[0])
    base_peak = torch.cuda.max_memory_allocated() - before

    # Each arm's step on its trained state and the first batch, timed in
    # turns (index, base, base, index, twice; CUDA events around each step).
    st = {"index": index_state, "base": state}
    ibatch, bids = pipe.batch_of_starts(grid[0]), torch.as_tensor(grid[0], device="cuda")
    arms = {"index": lambda: pipe.train_step(st["index"], ibatch),
            "base": lambda: step(st["base"], bids)}
    turns = in_turns(arms)
    if profile:
        for name, fn in arms.items():
            profile_step(f"A3T-GCN {name} train step", fn)
    del pipe, xs_d, ys_d

    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(index_state["params"]), strict=True))
    log(f"section 5.5 models (a) A3T-GCN, hidden {cfg.hidden}, {BAY_NODES} nodes, "
        f"{ds.n_windows:,} windows (train cut to {len(ds.train_windows)} = {S55_STEPS} "
        f"steps of {BATCH}), lr {A3T_LR}: loss {index_losses[0]:.6f} -> "
        f"{index_losses[-1]:.6f}")
    log(f"section 5.5 models (a) index: step {turns['index']:.3f} ms in turns "
        f"({statistics.median(index_ms[1:]):.3f} ms median of steps 2..{S55_STEPS} "
        f"in training), peak {index_peak:,} bytes above the arm's start, test MSE "
        f"{index_mse:.6f} over {len(test_ids)} windows")
    log(f"section 5.5 models (a) base: step {turns['base']:.3f} ms in turns "
        f"({statistics.median(base_ms[1:]):.3f} ms in training), peak {base_peak:,} "
        f"bytes above the arm's start, test MSE {base_mse:.6f}; windows materialised "
        f"on the host in {host_s:.1f} s")
    log(f"section 5.5 models (a) memory: resident series + starts {resident:,} bytes against "
        f"{materialised:,} bytes of materialised windows: {1 - resident / materialised:.2%} "
        f"less (peaks: {1 - index_peak / base_peak:.2%} less)")
    log(f"section 5.5 models (a) base against index: losses "
        f"{'equal' if base_losses == index_losses else 'DIFFER'}, parameters "
        f"{'equal' if same_params else 'DIFFER'} bit for bit, test MSE "
        f"{'equal' if base_mse == index_mse else 'DIFFERS'}")
    check(materialised == ds.nbytes_materialized(), "materialised bytes off the count")
    check(base_losses == index_losses, f"base losses {base_losses} differ from the "
                                       f"index-batched {index_losses}")
    check(same_params, "base and index arms end with different parameters")
    check(base_mse == index_mse, "base and index arms' test MSE differ")
    return launches


def phase_stllm(spec, ds, profile: bool) -> int:
    """ST-LLM at full width on the index-batched pipeline: S55_STEPS steps,
    then evaluate(split="test"); the leaves no loss reads stay as drawn.
    Returns window_gather's count read just after the evaluation."""
    from repro_torch.kernels.window_gather.kernel import window_gather
    from repro_torch.models import stllm
    from repro_torch.tree import tree_leaves

    cfg = stllm.STLLMConfig(num_nodes=BAY_NODES, in_features=FEATURES)
    params = stllm.init(torch.Generator().manual_seed(SEED), cfg, device="cuda")
    unused = {"backbone/embed": params["backbone"]["embed"].clone(),
              "backbone/lm_head/w": params["backbone"]["lm_head"]["w"].clone(),
              "tod": params["tod"].clone()}
    n_params = sum(t.numel() for t in tree_leaves(params))

    def loss_fn(p, x, y):
        return stllm.loss_fn(p, cfg, x, y), {}

    pipe, state, losses, ms, peak = s55_fit(spec, ds, loss_fn, params, STLLM_LR)
    t0 = time.perf_counter()
    test_mae = pipe.evaluate(state["params"], split="test")
    eval_s = time.perf_counter() - t0
    launches = window_gather.launches
    p = state["params"]
    after = {"backbone/embed": p["backbone"]["embed"],
             "backbone/lm_head/w": p["backbone"]["lm_head"]["w"], "tod": p["tod"]}
    kept = {k: bool(torch.equal(unused[k], after[k])) for k in unused}
    log(f"section 5.5 models (b) ST-LLM, d_model {cfg.d_model}, {cfg.layers} layers, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, {n_params:,} parameters, {BAY_NODES} node "
        f"tokens, lr {STLLM_LR}: loss {losses[0]:.6f} -> {losses[-1]:.6f}; step "
        f"{statistics.median(ms[1:]):.3f} ms (median of steps 2..{S55_STEPS}); peak "
        f"{peak:,} bytes above the arm's start; test MAE {test_mae:.6f} in "
        f"{eval_s:.2f} s; unchanged after the steps: {kept}")
    if profile:
        batch = pipe.batch_of_starts(pipe.dataplane.epoch_global(0)[0])
        profile_step("ST-LLM train step", lambda: pipe.train_step(state, batch))
    check(np.isfinite(test_mae), "non-finite ST-LLM test MAE")
    check(all(kept.values()), f"ST-LLM leaves no loss reads changed: {kept}")
    return launches


def phase_bay_gather(ds) -> dict:
    """window_gather at this path's shape, [52105, 650] (2,600-byte rows):
    the vector route, bit-exact against its plain version, timed."""
    from repro_torch.kernels.window_gather.kernel import window_gather
    from repro_torch.kernels.window_gather.ref import window_gather_ref

    span = 2 * HORIZON
    series = torch.as_tensor(ds.series).reshape(BAY_ENTRIES, -1).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    starts = torch.randint(0, BAY_ENTRIES - span + 1, (BATCH,), device="cuda",
                           generator=gen, dtype=torch.int32)
    out = window_gather(series, starts, span=span)
    torch.cuda.synchronize()
    want = window_gather_ref(series, starts, span=span)
    check(torch.equal(out, want), "window_gather differs from its plain version at "
                                  f"{tuple(series.shape)}")
    g = gather_times(series, gen)
    log(f"section 5.5 models (c) window_gather {tuple(series.shape)}, {BATCH} windows of "
        f"{span}: bit-exact")
    log_gather_times("section 5.5 models (c) time: window_gather", g)
    check(g["route"] == "vector", f"route {g['route']} at {g['row_bytes']}-byte rows")
    return g


def phase_section55(profile: bool) -> int:
    """The §5.5 models, window_gather's count set to 0 just before A3T-GCN's
    index arm and before ST-LLM and read just after each; then the kernel
    at this path's shape.  Returns the path's launches."""
    from repro_torch.kernels.window_gather.kernel import window_gather

    t0 = time.perf_counter()
    a_hat, raw = bay_graph_and_data()
    spec, ds = s55_dataset(raw)
    window_gather.launches = 0
    a_launches = phase_a3tgcn(a_hat, spec, ds, profile)
    window_gather.launches = 0
    b_launches = phase_stllm(spec, ds, profile)
    launches = a_launches + b_launches
    log(f"section 5.5 models path launches: window_gather {launches} (A3T-GCN "
        f"{a_launches}, ST-LLM {b_launches})")
    check(launches > 0, "window_gather was not launched on the section 5.5 models path")
    phase_bay_gather(ds)
    torch.cuda.empty_cache()
    log(f"section 5.5 models: phase wall {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------- the rest of the LM family
LM_ARCH = "rwkv6-1.6b"
LM_SEQ, LM_BATCH, LM_STEPS = 128, 8, 6
LM_ENTRIES = 196   # 68 windows of 129 tokens: 6 train steps of 8, 7 val, 13 test
# The step and peak of the WKV loop under autograd (PERF.md §2; NVIDIA
# H100 80GB HBM3, 700 W).  The WKV scan's own backward keeps one state a
# step in its residual stack, as the autograd loop kept one: its peak may
# grow by at most LM_PEAK_RATIO.
LM_STEP_MS_BEFORE, LM_PEAK_GIB_BEFORE, LM_PEAK_RATIO = 3140.8, 50.14, 1.05
DS_ARCH = "deepseek-v2-lite-16b"
DS_SLOTS, DS_MAX_LEN, DS_NEW_TOKENS = 8, 1024, 32
DS_REQUESTS, DS_PROMPT_LENS = 16, (128, 256, 512)  # the traffic cuts
# Every lane replayed dropless through the cache path (absorbed MLA over
# the latent cache) and through a forward over its prompt and generated
# tokens (decompressed MLA).  In float32 the two paths' router
# probabilities at every MoE layer and position must agree within
# DS_PROB_ATOL (about 3e-6 apart on the H100) up to the first place where
# an expert choice differs: with the probabilities that close, such a
# change is a near tie (the log gives its gap), after which the paths
# route otherwise and the last logits move by 5e-5 to 0.12, so a lane that
# has one is held no further.  At most half the lanes may have one, and
# every other lane's last logits must lie within DS_F32_ATOL of the
# float32 forward (about 2e-5 apart, against logits of about 4).  A wrong
# cache moves the probabilities at the logits' own scale.  In bf16,
# rounding through 27 layers and the expert choices it flips put both
# paths 0.1-0.6 from the float32 logits and one lane's ratio of the two
# anywhere from 0.3 to 3, and the bf16 MoE combine adds in no fixed order:
# the lanes' summed distance of the decode may be at most DS_LOGIT_RATIO
# times the bf16 forward's.
DS_PROB_ATOL, DS_F32_ATOL = 2e-5, 1e-4
DS_LOGIT_RATIO = 2.0
LM_SMOKE = ("qwen1.5-4b", "minitron-8b", "granite-34b", "h2o-danube-3-4b",
            "internvl2-26b", "musicgen-large", "grok-1-314b", "deepseek-v2-lite-16b",
            "rwkv6-1.6b")
SMOKE_SEQ, SMOKE_ENTRIES = 16, 33  # 17 windows: 3 train steps of 4, 2 val
SMOKE_DECODE_ATOL = 1e-4  # f32 prefill + decode vs a teacher-forced forward


def phase_lm_train(profile: bool) -> None:
    """(a) rwkv6-1.6b at full width through the launcher's LM path."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import main as launch

    cfg = get_arch(LM_ARCH).lm
    torch.cuda.reset_peak_memory_stats()
    flags = ["--arch", LM_ARCH, "--seq-len", str(LM_SEQ), "--batch", str(LM_BATCH),
             "--steps", str(LM_STEPS), "--entries", str(LM_ENTRIES), "--log-every", "1",
             "--seed", str(SEED)]
    log(f"LM train: {LM_ARCH} at full width ({cfg.layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, head size "
        f"{cfg.rwkv_head_size}; {cfg.param_dtype} master weights, {cfg.dtype} "
        f"compute) through the launcher: {' '.join(flags)}; CUT: a {LM_ENTRIES}-token "
        f"stream, so one epoch is {LM_STEPS} steps")
    t0 = time.perf_counter()
    with StepTimer(keep_last=profile) as timer:
        state, history = launch(flags)
    wall = time.perf_counter() - t0
    steps = [r for r in history if "lr" in r]
    losses = [r["loss"] for r in steps]
    final = history[-1]
    step_ms = statistics.median(timer.ms[1:])
    peak = torch.cuda.max_memory_allocated()
    log(f"LM train: {len(steps)} steps in {wall:.1f} s (parameters drawn, data and "
        f"eval included); loss {', '.join(f'{v:.4f}' for v in losses)}; val_loss "
        f"{final.get('val_loss')}, val_ppl {final.get('val_ppl')}; train step "
        f"{step_ms:.1f} ms (median of steps 2..{len(steps)}; all: "
        f"{', '.join(f'{t:.1f}' for t in timer.ms)}); peak device memory "
        f"{peak / 2**30:.2f} GiB (the WKV loop under autograd: {LM_STEP_MS_BEFORE} ms, "
        f"{LM_PEAK_GIB_BEFORE} GiB)")
    check(peak <= LM_PEAK_RATIO * LM_PEAK_GIB_BEFORE * 2**30,
          f"LM train: peak {peak / 2**30:.2f} GiB above {LM_PEAK_RATIO} x "
          f"{LM_PEAK_GIB_BEFORE} GiB")
    check(len(steps) == LM_STEPS and all(np.isfinite(losses)),
          f"LM train: {len(steps)} steps, losses {losses}")
    check(len(set(losses)) > 1, f"LM train: the loss never changed: {losses}")
    check(np.isfinite(final.get("val_loss", np.nan))
          and np.isfinite(final.get("val_ppl", np.nan)),
          f"LM train: no finite val_loss/val_ppl in the epoch row {final}")
    if profile:
        step, batch = timer.last
        profile_step(f"{LM_ARCH} train step", lambda: step(state, batch))
    del state, timer
    torch.cuda.empty_cache()


def ds_model():
    """deepseek-v2-lite-16b at its registered widths, random weights drawn
    on the card straight into bf16, leaf by leaf, from a seeded generator
    (the router stays float32, as in the JAX package)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as lm
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_arch(DS_ARCH).lm, param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                     device="cuda")
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    m, moe = cfg.mla, cfg.moe
    log(f"LM serve: {DS_ARCH} at full width: {cfg.layers} layers "
        f"({[(len(sp), r) for sp, r in lm.stage_plan(cfg)]} stage plan), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, MLA kv_lora_rank {m.kv_lora_rank} "
        f"(rope {m.qk_rope_head_dim}), MoE {moe.n_experts} routed experts top-"
        f"{moe.top_k} + {moe.n_shared} shared of width {moe.d_expert}, first "
        f"{moe.first_k_dense} dense (d_ff {moe.dense_d_ff}), vocab {cfg.vocab}: "
        f"{n:,} parameters, {sum(t.nbytes for t in leaves) / 1e9:.2f} GB "
        f"(bf16, router f32), drawn in {time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while drawing")
    return cfg, params


def phase_lm_serve(profile: bool) -> None:
    """(b) deepseek-v2-lite-16b at full width through ServeEngine: 16 greedy
    requests, every MoE dispatch's dropped assignments counted, and one
    lane's last decode logits held against a forward over its tokens."""
    from repro_torch.models.lm import model as lm
    from repro_torch.models.lm import moe
    from repro_torch.serve import ServeConfig, ServeEngine

    torch.cuda.reset_peak_memory_stats()
    cfg, params = ds_model()
    rng = np.random.default_rng(SEED + 5)
    lens = rng.choice(DS_PROMPT_LENS, size=DS_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(k)).astype(np.int32) for k in lens]
    log(f"LM serve: CUTS (traffic only): {DS_REQUESTS} requests, prompt lengths "
        f"{sorted(p.size for p in prompts)} drawn from {DS_PROMPT_LENS}, "
        f"{DS_NEW_TOKENS} new tokens each; no width or depth cut")
    eng = ServeEngine(params, cfg, ServeConfig(slots=DS_SLOTS, max_len=DS_MAX_LEN,
                                               max_new_tokens=DS_NEW_TOKENS),
                      planes=1, device="cuda")
    del params  # the engine's compute copy shares the bf16 leaves
    log(f"LM serve: slot-pool cache {eng.planes[0].cache_bytes() / 2**20:.1f} MiB "
        f"({DS_SLOTS} lanes x {DS_MAX_LEN} tokens of {cfg.mla.kv_lora_rank} + "
        f"{cfg.mla.qk_rope_head_dim} latents a layer)")

    drops = {"prefill": [], "decode": []}  # device counts, summed after the run
    records = []  # (input tokens, lengths, logits) of every decode call
    dispatch, decode_step = moe._dispatch_indices, lm.decode_step

    def counting(top_ix, n_experts, capacity):
        slot_src = dispatch(top_ix, n_experts, capacity)
        kind = "decode" if top_ix.shape[0] == DS_SLOTS else "prefill"
        drops[kind].append(top_ix.numel() - (slot_src < top_ix.numel()).sum())
        return slot_src

    def recording(p, c, token, cache, lengths, **kw):
        logits, cache = decode_step(p, c, token, cache, lengths, **kw)
        records.append((token[:, 0].clone(), lengths.clone(), logits))
        return logits, cache

    moe._dispatch_indices, lm.decode_step = counting, recording
    try:
        rids, out, groups, steps, wall = serve_timed(eng, prompts)
    finally:
        moe._dispatch_indices, lm.decode_step = dispatch, decode_step
    statuses = [eng.router.done[r].status for r in rids]
    n_tok = sum(len(out[r]) for r in rids)
    dropped = {k: int(sum(int(v) for v in vals)) for k, vals in drops.items()}
    calls = {k: len(vals) for k, vals in drops.items()}
    peak = torch.cuda.max_memory_allocated()
    per_shape = {}
    for shape, ms in groups:
        per_shape.setdefault(tuple(shape), []).append(ms)
    log(f"LM serve: {len(rids)} requests in {wall:.3f} s: {len(groups)} prefill groups "
        f"{[tuple(g) for g, _ in groups]}, {len(steps)} decode steps, {n_tok} tokens "
        f"({n_tok / wall:.1f} tokens/s over the run); prefill group ms (host clock to "
        f"the token pull) {', '.join(f'{s}: {statistics.median(v):.1f}' for s, v in per_shape.items())}; "
        f"decode step {statistics.median(steps):.2f} ms (median of {len(steps)}); peak "
        f"device memory {peak / 2**30:.2f} GiB")
    log(f"LM serve: MoE assignments dropped over capacity: prefill {dropped['prefill']} "
        f"in {calls['prefill']} dispatches, decode {dropped['decode']} in "
        f"{calls['decode']} dispatches ({DS_SLOTS} tokens x top-{cfg.moe.top_k} = "
        f"{DS_SLOTS * cfg.moe.top_k} assignments against a capacity of "
        f"{moe.capacity_of(DS_SLOTS, cfg.moe)} an expert)")
    check(statuses == ["ok"] * DS_REQUESTS, f"request statuses {statuses}")
    check(all(len(out[r]) == DS_NEW_TOKENS for r in rids),
          f"a request did not get its {DS_NEW_TOKENS} tokens")
    check(all(0 <= t < cfg.vocab for r in rids for t in out[r]),
          "a token outside the vocabulary")
    check(dropped["decode"] == 0, "a decode step dropped MoE assignments")

    # Lane 0's served logits: the decode call that produced its last token
    # fed its second-to-last token at length len(prompt) + DS_NEW_TOKENS - 2.
    gens = [np.asarray(out[r]) for r in rids]
    at = prompts[0].size + DS_NEW_TOKENS - 2
    served = None
    for tok, lens, logits in records:
        lanes = torch.nonzero((lens == at) & (tok == int(gens[0][-2])))
        if len(lanes):
            served = logits[int(lanes[0, 0])].float()
    check(served is not None, "no decode call fed lane 0's second-to-last token")
    ds_check_lanes(eng.planes[0].params, cfg, prompts, gens, served)
    if profile:
        profile_step(f"{DS_ARCH} decode step", eng.planes[0].decode)
    del records
    torch.cuda.empty_cache()
    ds_serve_paged(cfg, eng, prompts, out, rids, peak)
    del eng
    torch.cuda.empty_cache()


def ds_serve_paged(cfg, eng, prompts, out, rids, contiguous_peak) -> None:
    """(d) the same 16 requests through a paged plane (MLA latent pools of
    block 16, the pool sized to the live tokens), on the engine's weights:
    every request ``ok`` and 0 drops at decode; cache bytes and peak beside
    the contiguous run's; tokens against the contiguous run's, and where
    they differ, a second contiguous run against the first (the bf16 MoE
    combine is an ``index_add`` in no fixed order on the card).  Then one
    full-width MLA layer's paged decode held bit-equal to its contiguous
    decode."""
    from repro_torch.models.lm import moe
    from repro_torch.serve import ServeConfig, ServeEngine

    params = eng.planes[0].params
    pool = pool_for(DS_SLOTS, max(DS_PROMPT_LENS), DS_NEW_TOKENS, RG_BLOCK)
    decode_drops = []
    dispatch = moe._dispatch_indices

    def counting(top_ix, n_experts, capacity):
        slot_src = dispatch(top_ix, n_experts, capacity)
        if top_ix.shape[0] == DS_SLOTS:
            decode_drops.append(top_ix.numel() - (slot_src < top_ix.numel()).sum())
        return slot_src

    runs = {}
    for label, extra in (("paged", dict(block_size=RG_BLOCK, pool_blocks=pool)),
                         ("contiguous again", {})):
        torch.cuda.reset_peak_memory_stats()
        e = ServeEngine(params, cfg, ServeConfig(slots=DS_SLOTS, max_len=DS_MAX_LEN,
                                                 max_new_tokens=DS_NEW_TOKENS, **extra),
                        planes=1, device="cuda")
        moe._dispatch_indices = counting
        try:
            r2, o2, groups, steps, wall = serve_timed(e, prompts)
        finally:
            moe._dispatch_indices = dispatch
        statuses = [e.router.done[r].status for r in r2]
        runs[label] = [o2[r] for r in r2]
        log(f"LM serve {label}: cache {e.planes[0].cache_bytes():,} B against "
            f"{eng.planes[0].cache_bytes():,} B contiguous; decode step "
            f"{statistics.median(steps):.2f} ms (median of {len(steps)}); "
            f"{sum(map(len, runs[label])) / wall:.1f} tokens/s; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the contiguous run "
            f"{contiguous_peak / 2**30:.2f} GiB from the draw on)")
        check(statuses == ["ok"] * DS_REQUESTS, f"{label} request statuses {statuses}")
        check(int(sum(int(d) for d in decode_drops)) == 0,
              f"{label}: a decode step dropped MoE assignments")
        del e
        torch.cuda.empty_cache()
        first = [out[r] for r in rids]
        if label == "paged":
            same = sum(a == b for a, b in zip(runs[label], first))
            log(f"LM serve: paged tokens equal to the contiguous run's: "
                f"{same}/{DS_REQUESTS} requests")
            if same == DS_REQUESTS:
                break
        else:
            again = sum(a == b for a, b in zip(runs[label], first))
            log(f"LM serve: a second contiguous run equal to the first: "
                f"{again}/{DS_REQUESTS} requests (the MoE combine's atomics)")
    ds_mla_layer_paged(cfg, params)


def ds_mla_layer_paged(cfg, params) -> None:
    """Layer 0's absorbed MLA decode at full width (kv_lora_rank 512, rope
    64, 16 heads) on 8 lanes of random bf16 latents at lengths up to 1,023:
    through a paged pool (block 16, shuffled blocks, a retired lane on the
    null block) it must give the contiguous decode's output and latents bit
    for bit."""
    from repro_torch.models.lm import mla
    from repro_torch.tree import tree_map

    m, b, s, bs = cfg.mla, DS_SLOTS, DS_MAX_LEN, RG_BLOCK
    p = tree_map(lambda t: t[0], params["stages"][0]["sub0"]["attn"])
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    dt = getattr(torch, cfg.dtype)
    ckv = torch.randn(b, s, m.kv_lora_rank, device="cuda", generator=g).to(dt)
    kpe = torch.randn(b, s, m.qk_rope_head_dim, device="cuda", generator=g).to(dt)
    x = torch.randn(b, 1, cfg.d_model, device="cuda", generator=g).to(dt)
    lengths = torch.randint(0, s - 1, (b,), device="cuda", generator=g)
    lengths[-1] = 0
    nblk = s // bs
    perm = 1 + torch.randperm(b * nblk, device="cuda", generator=g)
    tables = perm.reshape(b, nblk)
    tables[-1] = 0  # a retired lane: all-null table, length 0
    ckv_pool = torch.zeros(1 + b * nblk, bs, m.kv_lora_rank, device="cuda", dtype=dt)
    kpe_pool = torch.zeros(1 + b * nblk, bs, m.qk_rope_head_dim, device="cuda", dtype=dt)
    ckv_pool[tables[:-1]] = ckv[:-1].reshape(b - 1, nblk, bs, -1)
    kpe_pool[tables[:-1]] = kpe[:-1].reshape(b - 1, nblk, bs, -1)
    with torch.no_grad():
        y, c2, k2 = mla.mla_decode(p, cfg, x, ckv.clone(), kpe.clone(), lengths)
        yp, cp, kp = mla.mla_decode(p, cfg, x, ckv_pool, kpe_pool, lengths,
                                    paged=(tables, bs, s))
    torch.cuda.synchronize()
    same_y = torch.equal(yp[:-1], y[:-1])
    same_c = all(torch.equal(cp[tables[i]].reshape(s, -1), c2[i]) for i in range(b - 1))
    same_k = all(torch.equal(kp[tables[i]].reshape(s, -1), k2[i]) for i in range(b - 1))
    log(f"LM serve: one full-width MLA layer, paged (block {bs}, shuffled blocks) against "
        f"contiguous decode at lengths {lengths.tolist()}: output bit-equal {same_y}, "
        f"latent pools bit-equal {same_c} / {same_k}")
    check(same_y and same_c and same_k, "paged MLA decode differs from contiguous")


def ds_check_lanes(params, cfg, prompts, gens, served) -> None:
    """Every lane's tokens through the cache path and through ``forward``,
    with a capacity that drops nothing (capacity factor E / k): the served
    run's prefill groups drop assignments, and which ones depends on the
    group, so only a dropless pass compares the two paths.  The lanes of
    one prompt length run as one batch: prompts prefilled, generated tokens
    decoded teacher-forced, in bf16 and in float32.  In float32 every MoE
    layer's router probabilities are recorded at every position on both
    paths (see DS_PROB_ATOL and DS_F32_ATOL); in bf16 the last logits of the
    decode and of a bf16 forward are measured against a float32 forward
    (DS_LOGIT_RATIO).  The first lane's served logits (prefill groups with
    drops) are logged against its bf16 forward."""
    from repro_torch.models.lm import model as lm
    from repro_torch.models.lm import moe as moe_mod

    moe = cfg.moe
    nd = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))
    nd32 = dataclasses.replace(nd, dtype="float32")
    router, probs = moe_mod._router, []

    def recording(p, x, k):
        out = router(p, x, k)
        probs.append(out[0])
        return out

    def decode(c, seq, n_prompt):
        cache = lm.init_cache(c, seq.shape[0], DS_MAX_LEN, device="cuda")
        logits, cache, lengths = lm.prefill(params, c, seq[:, :n_prompt], cache)
        for t in range(n_prompt, seq.shape[1]):
            logits, cache = lm.decode_step(params, c, seq[:, t:t + 1], cache, lengths)
            lengths = lengths + 1
        return logits.float()

    def routed(run, seq, n_prompt=None):
        """run's result and the router probabilities [layers, B, S, E]:
        the cache path routes its prompt in one call a layer, then each
        decoded token in one call a layer."""
        probs.clear()
        moe_mod._router = recording
        try:
            got = run()
        finally:
            moe_mod._router = router
        b, s = seq.shape
        n = s if n_prompt is None else n_prompt
        layers = len(probs) // (s - n + 1)
        calls = [probs[i::layers] for i in range(layers)]
        return got, torch.stack([torch.cat([calls[l][0].reshape(b, n, -1)]
                                           + [c.reshape(b, 1, -1) for c in calls[l][1:]], 1)
                                 for l in range(layers)])

    err = {"dec16": {}, "fwd16": {}, "dec32": {}, "probs": {}}
    flips, bf16_first = {}, None
    for n_prompt in sorted({p.size for p in prompts}):
        ix = [i for i, p in enumerate(prompts) if p.size == n_prompt]
        seq = torch.as_tensor(np.stack([np.concatenate([prompts[i], gens[i][:-1]])
                                        for i in ix]), dtype=torch.long, device="cuda")
        with torch.no_grad():
            dec16 = decode(nd, seq, n_prompt)
            fwd16 = lm.forward(params, nd, seq)[0][:, -1].float()
            dec32, dprobs = routed(lambda: decode(nd32, seq, n_prompt), seq, n_prompt)
            f32, fprobs = routed(lambda: lm.forward(params, nd32, seq)[0][:, -1], seq)
        chosen = [torch.sort(moe_mod._top_k(q, moe.top_k)[1], -1)[0] for q in (dprobs, fprobs)]
        differ = (chosen[0] != chosen[1]).any(-1)  # [layers, B, S]
        for row, i in enumerate(ix):
            for name, got in (("dec16", dec16), ("fwd16", fwd16), ("dec32", dec32)):
                err[name][i] = float((got[row] - f32[row]).abs().max())
            gap = (dprobs[:, row] - fprobs[:, row]).abs().amax(-1)  # [layers, S]
            at = torch.nonzero(differ[:, row].T)  # (position, layer), in order
            if len(at):  # the probabilities up to the first change of choice
                t, l = (int(v) for v in at[0])
                top = torch.sort(fprobs[l, row, t], descending=True)[0]
                flips[i] = (l, t, float(top[moe.top_k - 1] - top[moe.top_k]))
                gap = torch.cat([gap[:, :t].reshape(-1), gap[:l + 1, t]])
            err["probs"][i] = float(gap.max())
        if 0 in ix:
            bf16_first = fwd16[ix.index(0)]
        del dec16, fwd16, dec32, f32, dprobs, fprobs, chosen, differ
    lanes = range(len(prompts))
    even = [i for i in lanes if i not in flips]
    worst_p = max(lanes, key=err["probs"].get)
    worst32 = max(even, key=err["dec32"].get, default=None)
    sum_dec, sum_fwd = (sum(err[k].values()) for k in ("dec16", "fwd16"))
    ratios = sorted(err["dec16"][i] / err["fwd16"][i] for i in lanes)
    changed = "; ".join(f"lane {i} at layer {l}, position {t} (the forward's "
                        f"{moe.top_k}th and next probabilities {tie:.1e} apart; last "
                        f"logits {err['dec32'][i]:.3e})"
                        for i, (l, t, tie) in sorted(flips.items()))
    held = (f"{min(err['dec32'][i] for i in even):.3e}..{err['dec32'][worst32]:.3e}"
            if even else "none")
    log(f"LM serve: {len(prompts)} lanes replayed dropless (capacity factor "
        f"{nd.moe.capacity_factor:.3f}), one batch a prompt length.  float32: router "
        f"probabilities of the decode path against the forward's, up to any change of "
        f"choice, at most {err['probs'][worst_p]:.3e} apart (lane {worst_p}; at most "
        f"{DS_PROB_ATOL}); expert choices changed on a near tie in {len(flips)} lanes"
        f"{': ' + changed if flips else ''}; the other {len(even)} lanes' last logits "
        f"{held} from the float32 forward (at most {DS_F32_ATOL}).  bf16: max_abs_diff "
        f"from the float32 forward summed over the lanes, decode {sum_dec:.4f}, bf16 "
        f"forward {sum_fwd:.4f} (ratio {sum_dec / sum_fwd:.3f}, at most {DS_LOGIT_RATIO}); "
        f"lane ratios {', '.join(f'{r:.3f}' for r in ratios)}; lane 0's served logits "
        f"(prefill groups with drops) against its bf16 forward "
        f"{float((served - bf16_first).abs().max()):.4f}")
    check(err["probs"][worst_p] <= DS_PROB_ATOL,
          f"lane {worst_p}'s float32 router probabilities differ by "
          f"{err['probs'][worst_p]:.3e} between the decode path and the forward")
    check(2 * len(even) >= len(prompts),
          f"expert choices changed in {len(flips)} of {len(prompts)} lanes")
    check(err["dec32"][worst32] <= DS_F32_ATOL,
          f"lane {worst32}'s float32 decode logits are {err['dec32'][worst32]:.3e} from "
          f"the float32 forward (at most {DS_F32_ATOL})")
    check(sum_dec <= DS_LOGIT_RATIO * sum_fwd,
          "the lanes' bf16 decode logits are further from the float32 forward than "
          f"{DS_LOGIT_RATIO}x the bf16 forward")


def phase_lm_smoke() -> None:
    """(c) every new LM arch at its smoke config, float32, on the card: 3
    launcher steps, then prefill plus 4 decode steps against a
    teacher-forced forward."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import main as launch
    from repro_torch.models.lm import model as lm

    for arch_id in LM_SMOKE:
        _, history = launch(["--arch", arch_id, "--smoke", "--seq-len", str(SMOKE_SEQ),
                             "--batch", "4", "--entries", str(SMOKE_ENTRIES),
                             "--log-every", "1", "--seed", str(SEED)])
        losses = [r["loss"] for r in history if "lr" in r]
        cfg = get_arch(arch_id).smoke_config()
        params = lm.init(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                         device="cuda")
        toks = torch.randint(0, cfg.vocab, (2, 12), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(SEED))
        errs = []
        with torch.no_grad():
            full, _ = lm.forward(params, cfg, toks)
            cache = lm.init_cache(cfg, 2, 16, device="cuda")
            logits, cache, lengths = lm.prefill(params, cfg, toks[:, :8], cache)
            errs.append(float((logits - full[:, 7]).abs().max()))
            for t in range(8, 12):
                logits, cache = lm.decode_step(params, cfg, toks[:, t:t + 1], cache,
                                               lengths)
                lengths = lengths + 1
                errs.append(float((logits - full[:, t]).abs().max()))
        log(f"LM smoke: {arch_id}: {len(losses)} launcher steps, loss "
            f"{', '.join(f'{v:.4f}' for v in losses)}; prefill + 4 decode steps vs "
            f"a teacher-forced forward: max_abs_diff {max(errs):.2e} (atol "
            f"{SMOKE_DECODE_ATOL})")
        check(len(losses) == 3 and all(np.isfinite(losses)),
              f"{arch_id}: launcher losses {losses}")
        check(max(errs) <= SMOKE_DECODE_ATOL, f"{arch_id}: decode disagrees with "
                                              f"the teacher-forced forward")


def phase_lm(profile: bool) -> None:
    t0 = time.perf_counter()
    phase_lm_train(profile)
    phase_lm_serve(profile)
    phase_lm_smoke()
    log(f"LM family: phase wall {time.perf_counter() - t0:.1f} s")

# ------------------------------------------------------------------ dry-run
PLACEMENTS = ("replicated", "partitioned", "ondemand")
# (a) cells dry-run on fake CUDA meshes of 256 and 512 ranks, each in its
# own process (a fake process group is global state of a process)
DRYRUN_CELLS = ([("dcrnn-pems", "train_pems", p) for p in PLACEMENTS]
                + [("pgt-dcrnn-pems-all-la", "train_all_la", p) for p in PLACEMENTS]
                + [("qwen1.5-4b", s, None) for s in ("train_4k", "prefill_32k", "decode_32k")]
                + [("deepseek-v2-lite-16b", "decode_32k", None)]
                # the cells that failed on a DTensor rule torch 2.11 lacks,
                # repaired by the local forms of models/lm/attention.py and
                # rwkv6.py
                + [("h2o-danube-3-4b", "prefill_32k", None),
                   ("deepseek-v2-lite-16b", "train_4k", None),
                   ("deepseek-v2-lite-16b", "prefill_32k", None),
                   ("musicgen-large", "train_4k", None),
                   ("musicgen-large", "decode_32k", None),
                   ("rwkv6-1.6b", "decode_32k", None)]
                # the recurrences: RG-LRU's associative scan in training, its
                # sequential scan and the WKV loops rolled (loops.trips)
                + [(a, s, None) for a in ("recurrentgemma-2b", "rwkv6-1.6b")
                   for s in ("train_4k", "prefill_32k")])
DRYRUN_JOBS = 8          # processes at once (the card's host has 8 cores)
DRYRUN_CELL_TIMEOUT = 240  # seconds a cell may run before it is recorded as failed
DRYRUN_PEAK_RTOL = 0.10  # predicted vs measured per-device peak at 1x1


def dryrun_cell(arch_id, shape, placement, multi_pod, out_dir) -> dict:
    tag = f"{arch_id}-{shape}-{placement or 'lm'}-{'2x16x16' if multi_pod else '16x16'}"
    path = os.path.join(out_dir, tag + ".json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cuda",
           "--arch", arch_id, "--shape", shape, "--cell-timeout", str(DRYRUN_CELL_TIMEOUT),
           "--out", path]
    if multi_pod:
        cmd.append("--multi-pod")
    if placement:
        cmd += ["--placement", placement]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=DRYRUN_CELL_TIMEOUT + 120)
    if not os.path.exists(path):
        raise RuntimeError(f"dry-run of {tag} wrote no record (exit {run.returncode}): "
                           f"{run.stderr[-2000:]}")
    with open(path) as f:
        (rec,) = json.load(f)
    return rec


def phase_dryrun_meshes(out_dir) -> list[dict]:
    """(a) The production meshes: every listed cell at 16x16 and 2x16x16,
    then the halo evidence on a fake mesh of 8."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import dryrun, roofline

    t0 = time.perf_counter()
    jobs = [(a, s, p, mp) for mp in (False, True) for a, s, p in DRYRUN_CELLS]
    with ThreadPoolExecutor(DRYRUN_JOBS) as pool:
        records = list(pool.map(lambda j: dryrun_cell(*j, out_dir), jobs))
    for rec in records:
        log(f"dry-run: {dryrun.format_record(rec)}")
        if rec["status"] != "ok":
            tail = [ln.strip() for ln in rec.get("traceback", "").splitlines()
                    if ln.strip().startswith("File") and "repro_torch" in ln][-3:]
            log(f"  failed at: {' <- '.join(reversed(tail))}")
        if rec["status"] == "ok":
            m = rec["memory"]
            log(f"  memory/device: argument {m['argument_bytes']} output {m['output_bytes']} "
                f"temp {m['temp_bytes']} alias {m['alias_bytes']} peak {m['peak_bytes']} "
                f"bytes; collectives/device {json.dumps(rec['collectives'])}")
    log("dry-run roofline (H100 SXM datasheet peaks, 50 GB/s a GPU across nodes):")
    for line in roofline.format_table(roofline.summarize(records)).splitlines():
        log(f"  {line}")
    n_ok = sum(r["status"] == "ok" for r in records)
    log(f"dry-run: {n_ok} of {len(records)} cell runs ok; meshes phase "
        f"{time.perf_counter() - t0:.1f} s")
    failed = [f"{r['arch']}:{r['shape']}:{r.get('options', {}).get('placement', 'lm')} "
              f"{r.get('mesh')}" for r in records if r["status"] != "ok"]
    check(not failed, f"dry-run cells failed: {failed}")

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    halo_path = os.path.join(out_dir, "halo.json")
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cuda",
                    "--halo-evidence", "--out", halo_path], env=env, cwd=ROOT,
                   capture_output=True, text=True, check=True, timeout=300)
    with open(halo_path) as f:
        halo = json.load(f)
    df, dt = halo["halo_false"]["data_bytes"], halo["halo_true"]["data_bytes"]
    # the collectives these programs specify (the per-rank program's explicit
    # all-reduce; the global-index program's series made replicated), which
    # tests/test_torch_dryrun.py holds to XLA's choices for the JAX programs
    log(f"dry-run halo evidence on a fake mesh of {halo['mesh']} (the communication "
        f"the port's programs specify): halo=False data-collective bytes/device {df} "
        f"(gradient all-reduce {halo['halo_false']['all-reduce']}), halo=True {dt}")
    check(df == 0, "the halo=False program moved data-collective bytes")
    check(dt > 0, "the halo=True program moved no data-collective byte")
    return records


def dryrun_card_cells():
    """(b) cells at a 1x1 mesh, at the sizes the paths above run."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell

    return [
        (get_arch("pgt-dcrnn-pems-all-la"), ShapeCell("train_b32", "train", 12, BATCH),
         {"series_len": ENTRIES}),
        (get_arch("dcrnn-pems"), ShapeCell("train_b8", "train", 12, 8), {"series_len": 104}),
        (get_arch("qwen1.5-4b"), ShapeCell("decode_8x1024", "decode", 1024, 8), {}),
    ]


def phase_dryrun_card() -> list[dict]:
    """(b) The dry-run held to the card: each cell dry-run at a 1x1 mesh over
    a one-rank NCCL group, then its args drawn on cuda:0 and the same
    program run for real; the peak above the phase's start against the
    prediction, the counter's FLOPs over the real step against the
    prediction's, and the roofline bound beside the measured step."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import dryrun, roofline, specs
    from repro_torch.launch import mesh as M
    from repro_torch.launch.costs import CUDA_BLOCK, CostCounter

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    rows = []
    try:
        one = M.MeshSpec(("data", "model"), (1, 1))
        dm = M.device_mesh(one, "cuda")
        for arch, cell, kw in dryrun_card_cells():
            build = (specs.build_stgnn_train if arch.family == "stgnn" else
                     specs.build_lm_decode)
            prog = build(arch, cell, one, **kw)
            t0 = time.perf_counter()
            pred = dryrun.count_cell(arch, cell, one, dm, block=CUDA_BLOCK, **kw)
            dry_s = time.perf_counter() - t0
            rec = dryrun.record({"arch": arch.id, "shape": cell.name, "mesh": "1x1",
                                 "chips": 1}, prog, pred,
                                dryrun.argument_bytes(prog, one, CUDA_BLOCK),
                                arch.lm.dtype if arch.lm is not None else "float32")
            terms = roofline.roofline_terms(rec)
            cublas_ready()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            base_req = torch.cuda.memory_stats()["requested_bytes.all.current"]
            args = specs.place_args(prog, dm, specs.random_local("cuda", SEED))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = prog.fn(*args)
            torch.cuda.synchronize()
            measured = torch.cuda.max_memory_allocated() - base
            # the bytes the ops asked for, before the allocator's block slack
            requested = torch.cuda.memory_stats()["requested_bytes.all.peak"] - base_req
            first = tree_first(out)
            check(bool(torch.isfinite(first).all()), f"{prog.name}: non-finite output")
            del out, first
            counter = CostCounter(block=CUDA_BLOCK)
            with counter:
                out = prog.fn(*args)
            del out
            ms = median_ms(lambda: prog.fn(*args), reps=3, warmup=0)
            bound_ms = terms["step_lower_bound_s"] * 1e3
            gap = measured - pred.peak
            row = {"cell": prog.name, "predicted_peak": pred.peak, "measured_peak": measured,
                   "requested_peak": requested, "peak_gap": gap, "predicted_flops": pred.flops,
                   "counted_flops": counter.costs.flops, "bytes": pred.bytes,
                   "bound_ms": bound_ms, "dominant": terms["dominant"], "step_ms": ms,
                   "ratio": ms / bound_ms, "dry_run_s": dry_s}
            rows.append(row)
            log(f"dry-run at 1x1: {prog.name}: peak predicted {pred.peak} measured "
                f"{measured} bytes ({gap / measured * 100:+.2f} %; requested by the "
                f"ops {requested}, {(requested - pred.peak) / measured * 100:+.2f} %); "
                f"flops predicted "
                f"{pred.flops:.6e} counted over the real step {counter.costs.flops:.6e}; "
                f"bytes/step {pred.bytes:.6e}; roofline bound {bound_ms:.4f} ms "
                f"({terms['dominant']}); measured step {ms:.4f} ms = {ms / bound_ms:.2f}x "
                f"the bound (fraction {bound_ms / ms:.4f}); dry-run {dry_s:.1f} s")
            check(counter.costs.flops == pred.flops,
                  f"{prog.name}: predicted flops {pred.flops} != counted {counter.costs.flops}")
            check(abs(gap) <= DRYRUN_PEAK_RTOL * measured,
                  f"{prog.name}: predicted peak {pred.peak} vs measured {measured}")
            del args
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return rows


def cublas_ready() -> None:
    """The persistent cuBLAS and cuBLASLt workspaces allocated: the first
    matmul of a process on a stream allocates them from the caching
    allocator and holds them until exit, so a step measured before them
    would carry them (the cost counter, like the step itself, does not
    allocate them again)."""
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.ones(64, 64, device="cuda", dtype=dtype)
        (a @ a).sum().item()
        torch.addmm(a[0], a, a).sum().item()
        torch.bmm(a[None], a[None]).sum().item()
    torch.cuda.synchronize()


def tree_first(tree):
    """The first tensor of a step's output, as a plain tensor."""
    while isinstance(tree, (tuple, list, dict)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree


def phase_dryrun() -> None:
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "dryrun")
    os.makedirs(out_dir, exist_ok=True)
    phase_dryrun_meshes(out_dir)
    phase_dryrun_card()
    log(f"dry-run: phase wall {time.perf_counter() - t0:.1f} s")



def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hop-gemm", action="store_true",
                        help="run only the build and the hop_gemm phase")
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler breakdown of one train "
                             "step, one forecast batch and one decode step, "
                             "of the section 5.5 models' train steps and of "
                             "the LM family's train and decode steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm, hop_project
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.linear_scan.kernel import linear_scan
    from repro_torch.kernels.window_gather.kernel import window_gather

    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    hop_rows = phase_hop_gemm()
    host_us = hop_gemm_host_us()
    if args.hop_gemm:
        print(json.dumps({"hop_gemm": hop_rows, "host_us": host_us}))
        return 0
    adj, supports = graph()
    errs = phase_kernels(supports)
    raw = make_data(adj)

    # The ST-GNN path: counts from 0, train then forecast, counts read after.
    window_gather.launches = 0
    hop_project.launches = 0
    hop_gemm.launches_fwd = hop_gemm.launches_bwd = 0
    cfg, spec, pipe, state, sync_losses = phase_train(raw, supports)
    fpipe, mae = phase_forecast(cfg, spec, pipe, state, supports)
    launches = {"window_gather": window_gather.launches,
                "hop_project": hop_project.launches,
                "hop_gemm": hop_gemm.launches_fwd + hop_gemm.launches_bwd}
    log(f"ST-GNN path launches: {launches}")
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched on the ST-GNN path")

    ppipe = eval_pipeline(cfg, spec, pipe, state, supports, False)
    compare_forecast(ppipe, state, mae)
    kernels = phase_times(pipe, fpipe, ppipe, state, supports, errs)
    kernels.append(hop_gemm_row(hop_rows, host_us))
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if args.profile:
        phase_profile(pipe, fpipe, state)
    log(f"peak device memory of the ST-GNN phases "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pipe, fpipe, ppipe, state
    phase_prefetch(raw, supports, sync_losses)
    torch.cuda.empty_cache()

    # dcrnn-pems through the launcher: counts from 0, run A, resume and
    # forecast, counts read and added to the kernels' launches.
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="dcrnn-", dir=os.path.join(ROOT, "build")) as work:
        window_gather.launches = 0
        hop_project.launches = 0
        hop_gemm.launches_fwd = hop_gemm.launches_bwd = 0
        dc = phase_dcrnn(work)
        dc_launches = {"window_gather": window_gather.launches,
                       "hop_project": hop_project.launches,
                       "hop_gemm": hop_gemm.launches_fwd + hop_gemm.launches_bwd}
    log(f"dcrnn-pems path launches: {dc_launches}")
    for k in kernels:
        check(dc_launches[k["name"]] > 0, f"{k['name']} was not launched on the "
                                          f"dcrnn-pems path")
        k["launches"] += dc_launches[k["name"]]
    phase_dcrnn_times(dc, supports[0], args.profile)
    del dc
    log(f"dcrnn: phase wall {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # The serving path: linear_scan's count from 0, the run, the count read.
    torch.cuda.reset_peak_memory_stats()
    rg_cfg, rg_params = rg_model()
    n_rec = sum(kind == "rec" for kind in rg_cfg.block_types())
    linear_scan.launches = 0
    eng, out, groups, steps, wall, n_tok = phase_serve(rg_cfg, rg_params)
    scan_launches = linear_scan.launches
    expected = n_rec * (len(groups) + len(steps))
    log(f"serving path launches: linear_scan {scan_launches} ({n_rec} RG-LRU "
        f"layers x ({len(groups)} prefill groups + {len(steps)} decode steps) "
        f"= {expected} expected)")
    check(n_rec == 18, f"{n_rec} recurrent layers, expected 18")
    check(scan_launches == expected, "linear_scan launches do not match 18 per "
                                     "prefill group and per decode step")
    del rg_params  # the engine keeps its compute-dtype copy
    # (b) the same requests paged, odd ones sampled: the count from 0 again.
    linear_scan.launches = 0
    p_groups, p_steps = phase_serve_paged(rg_cfg, eng, out, list(range(RG_REQUESTS)))
    paged_launches = linear_scan.launches
    expected = n_rec * (len(p_groups) + len(p_steps))
    log(f"serving path launches, paged run: linear_scan {paged_launches} ({n_rec} x "
        f"({len(p_groups)} prefill groups + {len(p_steps)} decode steps) = {expected} "
        f"expected)")
    check(paged_launches == expected, "linear_scan launches of the paged run do not "
                                      "match 18 per prefill group and per decode step")
    scan_launches += paged_launches
    rg_compare_plain(rg_cfg, eng, groups)
    scan_err = phase_scan_kernel(rg_cfg, groups)
    kernels.append(phase_serve_times(rg_cfg, eng, groups, steps, wall, n_tok,
                                     scan_launches, scan_err))
    if args.profile:
        profile_decode(eng)
    log(f"peak device memory of the serving phases "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del eng
    torch.cuda.empty_cache()

    # The sampler, qwen1.5-4b through the serving launcher and the fleet
    # drill: counts from 0 just before each, read just after; none of them
    # runs a kernel in this process (the launcher serves with the plain
    # scan, as the JAX launcher does; the fleet's workers are processes).
    counters = (window_gather, hop_project, linear_scan, flash_attention)
    with tempfile.TemporaryDirectory(prefix="fleet-", dir=os.path.join(ROOT, "build")) as work:
        for label, run in (("sampler", phase_sampler_card), ("qwen serve", phase_qwen),
                           ("fleet", lambda: phase_fleet(work))):
            for kernel in counters:
                kernel.launches = 0
            t0 = time.perf_counter()
            run()
            counts = {k.__name__: k.launches for k in counters}
            log(f"{label} path launches: {counts} (0 expected); phase "
                f"{time.perf_counter() - t0:.1f} s")
            check(not any(counts.values()), f"a kernel launched on the {label} path")
            torch.cuda.empty_cache()

    # Serving over a mesh: the parent's counts from 0 just before and read
    # just after (0: the child serves); the child's own counts, from 0 just
    # before each sharded run, give linear_scan's launches on the RG-LRU's
    # local shards.
    for kernel in counters:
        kernel.launches = 0
    with tempfile.TemporaryDirectory(prefix="sharded-", dir=os.path.join(ROOT, "build")) as work:
        sharded_scans = phase_sharded_serving(work)
    counts = {k.__name__: k.launches for k in counters}
    check(not any(counts.values()), f"a kernel launched in the sharded phase's parent: {counts}")
    log(f"sharded serving path launches: linear_scan {sharded_scans} (the child's "
        f"sharded recurrentgemma-2b run)")
    kernels[-1]["launches"] += sharded_scans
    torch.cuda.empty_cache()

    flash_err = phase_flash_kernel(rg_cfg)
    # The measured-dispatch path: tuned, then every count from 0, the path
    # dispatched from the cache, counts read.
    torch.cuda.reset_peak_memory_stats()
    dispatch_launches = phase_dispatch(
        raw, supports, rg_cfg, (window_gather, hop_project, linear_scan, flash_attention))
    kernels.append(phase_flash_times(rg_cfg, dispatch_launches["flash_attention"],
                                     flash_err))
    torch.cuda.empty_cache()

    # Distributed-index-batching: each child rank sets window_gather's count
    # to 0 before each placement's train run and reads it after; the sum of
    # the ranks' counts joins the kernel's launches.
    with tempfile.TemporaryDirectory(prefix="dist-", dir=os.path.join(ROOT, "build")) as work:
        dist_launches = phase_distributed(adj, work)
    log(f"distributed path launches: window_gather {dist_launches} (both ranks, "
        f"{len(DIST_RUNS)} placements)")
    kernels[0]["launches"] += dist_launches

    # Elastic training: (a) in process, window_gather's count from 0 just
    # before the elastic fit and read just after; (b), (c) on processes.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="elastic-", dir=os.path.join(ROOT, "build")) as work:
        el_launches = phase_elastic_inprocess(raw, supports, work)
        log(f"elastic path launches: window_gather {el_launches}")
        kernels[0]["launches"] += el_launches
        phase_elastic_processes(work)
    log(f"elastic: phase wall {time.perf_counter() - t0:.1f} s")

    # The section 5.5 models: window_gather's count from 0 before A3T-GCN's
    # two arms and ST-LLM, read after; the count joins the kernel's launches.
    kernels[0]["launches"] += phase_section55(args.profile)

    # The rest of the LM family: counts from 0 just before, read just after;
    # this path runs none of the four kernels (the lm gather is an indexed
    # slice, and no LM arch trains through a kernel or calls flash).
    counters = (window_gather, hop_project, linear_scan, flash_attention)
    for kernel in counters:
        kernel.launches = 0
    phase_lm(args.profile)
    lm_launches = {k.__name__: k.launches for k in counters}
    log(f"LM family path launches: {lm_launches} (0 expected: no kernel on this path)")
    check(not any(lm_launches.values()), "a kernel launched on the LM family path")

    # The launch tooling: counts from 0 just before, read just after; the
    # dry-run's cells use the plain gather and hops (use_pallas=False, as the
    # JAX package's cells), so no kernel runs on this path.
    for kernel in counters:
        kernel.launches = 0
    phase_dryrun()
    dry_launches = {k.__name__: k.launches for k in counters}
    log(f"dry-run path launches: {dry_launches} (0 expected: no kernel on this path)")
    check(not any(dry_launches.values()), "a kernel launched on the dry-run path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
