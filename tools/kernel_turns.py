#!/usr/bin/env python3
"""Time earlier builds of the scan and gather kernels in turns with the
current ones, on one NVIDIA card, at the shapes the port's paths give them.

Usage, from the repository root (the earlier sources go into a git-ignored
directory; they keep the C entry points they were written with):

    mkdir -p build/earlier
    git show <rev>:src/repro_torch/kernels/csrc/linear_scan.cu > build/earlier/linear_scan.cu
    git show <rev>:src/repro_torch/kernels/csrc/window_gather.cu > build/earlier/window_gather.cu
    python3 tools/kernel_turns.py --earlier build/earlier [--out build/kernel_turns.json]

The earlier entry points are those of the one-thread-per-channel scan
(``linear_scan(..., threads, stream)`` at 128 threads) and of the
one-block-per-row gather (``window_gather(..., threads, stream)`` at 256).
Each pair is timed as earlier, current, current, earlier, twice, each turn
a median of 5 means of 20 launches of device time (``chip_smoke.median_ms``
with the stream held busy while the host enqueues).  At S = 1 (the decode
shape, and the launch floor [1, 1, 32]) the current scan is also timed
against a scratch build of its own source with the S = 1 branch switched
off (:data:`RING_ONLY`); the chain floor is timed alone
(:data:`CHAIN_SOURCE`); the gather's bulk
route also at each piece size of :data:`PIECE_SWEEP`, in turns with
``index_select``.  Every pair's outputs are compared bit for bit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (BATCH, ENTRIES, FEATURES, HORIZON, NODES,  # noqa: E402
                        PEAK_BYTES_PER_S, in_turns, median_ms, scan_bound_ms,
                        scan_inputs)

# The current scan source with its S = 1 branch switched off, so that a
# decode step runs the staged kernel with one partial stage.
RING_ONLY = ("  if (x.seq == 1) {", "  if (false) {")

# The floor of the scan's dependency chain: one warp, `steps` steps of the
# kernel's rounded multiply and rounded add with a and b in registers, with
# (store = 1) or without (store = 0) a coalesced 128-byte store a step.
CHAIN_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void chain_kernel(const float* a, const float* b, float* out, int steps, int store) {
  const float av = a[threadIdx.x], bv = b[threadIdx.x];
  float h = out[threadIdx.x];
  for (int i = 0; i < steps; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      h = __fadd_rn(__fmul_rn(av, h), bv);
      if (store) out[32 + static_cast<long long>(i + u) * 32 + threadIdx.x] = h;
    }
  }
  out[threadIdx.x] = h;
}
extern "C" int chain(const void* a, const void* b, void* out, int steps, int store, void* stream) {
  chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out),
      steps, store);
  return static_cast<int>(cudaGetLastError());
}
"""
CHAIN_STEPS = 1 << 16

RG_WIDTH = 2560
PREFILL_GROUPS = ((1, 256), (1, 512), (2, 128), (2, 512), (4, 128), (4, 256))
# Piece bytes of the bulk route (a block keeps 8 pieces, one block an SM).
PIECE_SWEEP = (4096, 8192, 16384)


def build(src: str, out: str) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild

    cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(kbuild._CSRC), "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(out)


def entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def raising(fn):
    def call(*args):
        err = fn(*args)
        if err:
            raise RuntimeError(f"{fn.__name__} launch failed ({err})")
    return call


def scan_rows(earlier_lib, ring_lib) -> list[dict]:
    from repro_torch.kernels.linear_scan.kernel import linear_scan, scan_threads

    argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    old = raising(entry(earlier_lib, "linear_scan", argtypes))
    ring = raising(entry(ring_lib, "linear_scan", argtypes))
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for b, s, d in ((1, 1, 32), (8, 1, RG_WIDTH)) + tuple((k, n, RG_WIDTH)
                                                          for k, n in PREFILL_GROUPS):
        a, x = scan_inputs(gen, b, s, d)
        h0 = torch.randn((b, d), device="cuda", generator=gen)
        y_old, last_old = torch.empty_like(a), torch.empty_like(h0)

        def earlier():
            old(a.data_ptr(), x.data_ptr(), h0.data_ptr(), y_old.data_ptr(),
                last_old.data_ptr(), b, s, d, 0, 0, 128, stream())

        def current():
            linear_scan(a, x, h0)

        earlier()
        y_new, last_new = linear_scan(a, x, h0)
        torch.cuda.synchronize()
        same = torch.equal(y_old, y_new) and torch.equal(last_old, last_new)
        t = in_turns({"earlier": earlier, "current": current}, inner=20, device_only=True)
        row = {"kernel": "linear_scan", "shape": [b, s, d], "bit_equal": same,
               "bound_ms": scan_bound_ms(b, s, d), **{f"{k}_ms": v for k, v in t.items()}}
        if s == 1:
            y_ring, last_ring = torch.empty_like(a), torch.empty_like(h0)

            def staged():
                ring(a.data_ptr(), x.data_ptr(), h0.data_ptr(), y_ring.data_ptr(),
                     last_ring.data_ptr(), b, s, d, 0, 0, scan_threads(b, d, 132), stream())

            staged()
            torch.cuda.synchronize()
            row["staged_bit_equal"] = torch.equal(y_ring, y_new)
            t2 = in_turns({"staged": staged, "current": current}, inner=20,
                          device_only=True)
            row["staged_ms"], row["current_vs_staged_ms"] = t2["staged"], t2["current"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def chain_rows(chain_lib) -> list[dict]:
    fn = raising(entry(chain_lib, "chain", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p]))
    a = torch.full((32,), 0.999, device="cuda")
    b = torch.full((32,), 0.001, device="cuda")
    out = torch.zeros(32 * (CHAIN_STEPS + 1), device="cuda")
    rows = []
    for store in (0, 1):
        ms = median_ms(lambda: fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), CHAIN_STEPS,
                                  store, stream()), reps=5)
        row = {"kernel": "chain", "steps": CHAIN_STEPS, "store": bool(store), "ms": ms,
               "ns_per_step": ms * 1e6 / CHAIN_STEPS}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def gather_rows(earlier_lib) -> list[dict]:
    from repro_torch.kernels.window_gather.kernel import window_gather

    old = raising(entry(earlier_lib, "window_gather",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p]))
    gen = torch.Generator(device="cuda").manual_seed(8)
    span, c = 2 * HORIZON, NODES * FEATURES
    series = torch.randn((ENTRIES, c), device="cuda", generator=gen)
    starts = [torch.randint(0, ENTRIES - span + 1, (BATCH,), device="cuda", generator=gen,
                            dtype=torch.int32) for _ in range(64)]
    offs = torch.arange(span, device="cuda", dtype=torch.int32)
    flat_idx = [(st[:, None] + offs).reshape(-1) for st in starts]
    out_old = torch.empty((BATCH, span, c), device="cuda")
    it = {"old": 0, "new": 0, "lib": 0}

    def earlier():
        st = starts[it["old"] % 64]
        it["old"] += 1
        old(series.data_ptr(), st.data_ptr(), out_old.data_ptr(), ENTRIES, 4 * c, BATCH,
            span, 256, stream())

    def current():
        window_gather(series, starts[it["new"] % 64], span=span)
        it["new"] += 1

    def index_select():
        series.index_select(0, flat_idx[it["lib"] % 64])
        it["lib"] += 1

    old(series.data_ptr(), starts[0].data_ptr(), out_old.data_ptr(), ENTRIES, 4 * c, BATCH,
        span, 256, stream())
    same = torch.equal(out_old, window_gather(series, starts[0], span=span))
    bound = (2 * BATCH * span * c * 4 + BATCH * 4) / PEAK_BYTES_PER_S * 1e3
    row = {"kernel": "window_gather", "shape": [ENTRIES, c, BATCH, span], "bit_equal": same,
           "bound_ms": bound}
    for pair in ({"earlier": earlier, "current": current},
                 {"index_select": index_select, "current_vs_index_select": current}):
        row.update({f"{k}_ms": v for k, v in in_turns(pair, inner=20, device_only=True).items()})
    print(json.dumps(row), flush=True)
    rows = [row]
    # The bulk route at other piece sizes, each in turns with index_select.
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.window_gather.kernel import _entry

    lib, fn = _entry()
    out = torch.empty((BATCH, span, c), device="cuda")
    for piece in PIECE_SWEEP:
        blocks = min(-(-BATCH * span * 4 * c // piece), sm_count(series.device))

        def bulk(piece=piece, blocks=blocks):
            st = starts[it["new"] % 64]
            it["new"] += 1
            err = fn(series.data_ptr(), st.data_ptr(), out.data_ptr(), ENTRIES, 4 * c, BATCH,
                     span, piece, blocks, stream())
            if err:
                raise RuntimeError(f"window_gather piece {piece} failed ({err})")

        bulk()
        torch.cuda.synchronize()
        same = torch.equal(out, window_gather(series, starts[(it["new"] - 1) % 64], span=span))
        t = in_turns({"index_select": index_select, "bulk": bulk}, inner=20, device_only=True)
        piece_row = {"kernel": "window_gather", "piece": piece, "blocks": blocks,
                     "bit_equal": same, "bound_ms": bound,
                     **{f"{k}_ms": v for k, v in t.items()}}
        print(json.dumps(piece_row), flush=True)
        rows.append(piece_row)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--earlier", required=True,
                        help="directory with the earlier linear_scan.cu and window_gather.cu")
    parser.add_argument("--out", default=None, help="write the rows as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    earlier = os.path.abspath(args.earlier)
    libs = {name: build(os.path.join(earlier, f"{name}.cu"),
                        os.path.join(earlier, f"{name}.so"))
            for name in ("linear_scan", "window_gather")}
    from repro_torch.kernels import build as kbuild

    with open(kbuild._CSRC / "linear_scan.cu") as f:
        source = f.read()
    if RING_ONLY[0] not in source:
        raise RuntimeError("linear_scan.cu has no S = 1 branch to switch off")
    ring_src = os.path.join(earlier, "linear_scan_staged.cu")
    with open(ring_src, "w") as f:
        f.write(source.replace(*RING_ONLY))
    ring_lib = build(ring_src, os.path.join(earlier, "linear_scan_staged.so"))
    chain_src = os.path.join(earlier, "chain.cu")
    with open(chain_src, "w") as f:
        f.write(CHAIN_SOURCE)
    chain_lib = build(chain_src, os.path.join(earlier, "chain.so"))
    rows = (chain_rows(chain_lib) + scan_rows(libs["linear_scan"], ring_lib)
            + gather_rows(libs["window_gather"]))
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip()
    print(f"nvidia-smi clocks.sm, clocks.max.sm after the runs: {clocks}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    bad = [r for r in rows
           if not r.get("bit_equal", True) or not r.get("staged_bit_equal", True)]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
