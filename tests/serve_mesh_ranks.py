"""The ranks of tests/test_torch_serve_mesh.py: one process each, spawned once
for the whole module over a gloo group on the CPU (this module is not a
test module and imports no JAX, so the spawned ranks start with torch only).

Each rank runs, on a (data=2, model=2) mesh:

- the local forms against the plain functions on whole tensors: full,
  blockwise and banded attention with batch rows over ``data`` and heads
  over ``model``; decode attention against a cache whose sequence is split
  over ``model`` (the split softmax) and against one whose heads are; the
  ring write (``roll_seq`` + ``write_prefix``) into a cache whose window is
  split; the WKV scan; ``linear_scan(use_pallas=True)`` on batch- and
  channel-split operands, and its refusal of a split sequence;
- every serving case of :data:`CASES` through ``ServeEngine(mesh=...)``:
  the tokens, the one-pull-a-step count, the cache's placements and local
  shapes and the paged pool's block count;

then ranks 0 and 1 run the serving launcher as a group of two, as under
``torch.distributed.run``, and rank 0 once more on one device.  Each rank writes its results to
``<work>/rank<r>.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

MESH = (2, 2)  # (data, model)
MAX_LEN = 48
NEW_TOKENS = 4
#: (arch, slots, block size or 0): slots 8 splits the lane rows over data,
#: 3 keeps them whole; block 5 does not divide max_len, 16 does
CASES = [("qwen1.5-4b", 8, 0), ("qwen1.5-4b", 8, 5), ("qwen1.5-4b", 3, 0),
         ("qwen1.5-4b", 3, 16), ("recurrentgemma-2b", 8, 0), ("recurrentgemma-2b", 3, 16),
         ("deepseek-v2-lite-16b", 8, 0), ("deepseek-v2-lite-16b", 3, 16)]
SAMPLED = {"temperature": 0.7, "top_k": 20, "top_p": 0.9}
LAUNCHER_FLAGS = ["--requests", "5", "--slots", "4", "--max-new-tokens", "5"]


def requests(arch: str) -> list[tuple[np.ndarray, dict]]:
    """Six (prompt, submit keywords) pairs: prompts of 3, 5 or 7 tokens,
    every odd request sampled (its own seed), the rest greedy."""
    rng = np.random.default_rng(len(arch))
    out = []
    for i in range(6):
        prompt = rng.integers(0, 120, size=int(rng.choice([3, 5, 7]))).astype(np.int32)
        out.append((prompt, dict(SAMPLED, seed=10 + i) if i % 2 else {}))
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rng_tensor(rng, shape):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))


def _max_err(got, want) -> float:
    return float((got.full_tensor() - want).abs().max())


def local_forms(dm) -> dict:
    """Max abs error of each local form against the plain function on the
    whole tensors (every rank holds the same seeded inputs)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.distributed import shard_local
    from repro_torch.kernels.linear_scan import linear_scan
    from repro_torch.models.lm import attention as A
    from repro_torch.models.lm import rwkv6

    rng = np.random.default_rng(0)
    put = lambda t, *pl: shard_local(t, dm, pl)
    rows_heads = (Shard(0), Shard(2))
    out = {}
    q, k, v = (_rng_tensor(rng, (4, 32, 4, 8)) for _ in range(3))
    kv1 = _rng_tensor(rng, (4, 32, 1, 8))
    for name, fn, kw in (("full", A.full_attention, {}),
                         ("blockwise", A.blockwise_attention, {"q_chunk": 8, "kv_chunk": 16}),
                         ("banded", A.banded_attention, {"window": 8, "q_chunk": 8})):
        out[f"attention_{name}"] = _max_err(
            fn(put(q, *rows_heads), put(k, *rows_heads), put(v, *rows_heads), **kw),
            fn(q, k, v, **kw))
    # one kv head (MQA): every rank keeps it whole, q's heads split
    out["attention_mqa"] = _max_err(
        A.full_attention(put(q, *rows_heads), put(kv1, Shard(0), Replicate()),
                         put(kv1, Shard(0), Replicate())),
        A.full_attention(q, kv1, kv1))
    q1 = _rng_tensor(rng, (4, 1, 4, 8))
    lengths = torch.tensor([0, 5, 31, 32])
    for name, pl, window in (("seq", (Shard(0), Shard(1)), None),
                             ("seq_window", (Shard(0), Shard(1)), 6),
                             ("heads", (Shard(0), Shard(2)), None)):
        out[f"decode_{name}"] = _max_err(
            A.decode_attention(put(q1, Shard(0), Replicate()), put(k, *pl), put(v, *pl),
                               lengths, window=window),
            A.decode_attention(q1, k, v, lengths, window=window))
    # the ring write of a prefill: the window split over model
    new = _rng_tensor(rng, (4, 11, 2, 8))
    for s, shift in ((11, 11 % 6), (6, 0)):
        ring = put(torch.zeros(4, 6, 2, 8), Shard(0), Shard(1))
        A.write_prefix(ring, A.roll_seq(put(new[:, :s], Shard(0), Replicate())[:, -6:], shift))
        out[f"ring_{s}"] = _max_err(ring, torch.roll(new[:, :s][:, -6:], shift, dims=1))
    prefix = put(torch.zeros(4, 12, 2, 8), Shard(0), Shard(1))
    A.write_prefix(prefix, put(new[:, :7], Shard(0), Replicate()))
    want = torch.zeros(4, 12, 2, 8)
    want[:, :7] = new[:, :7]
    out["write_prefix"] = _max_err(prefix, want)
    # the WKV scan: batch rows over data, heads over model
    r, kk, vv = (_rng_tensor(rng, (2, 6, 4, 4)) for _ in range(3))
    w = torch.sigmoid(_rng_tensor(rng, (2, 6, 4, 4)))
    u, s0 = _rng_tensor(rng, (4, 4)), _rng_tensor(rng, (2, 4, 4, 4))
    got = rwkv6._wkv_scan(*(put(t, *rows_heads) for t in (r, kk, vv, w)),
                          put(u, Replicate(), Shard(0)), put(s0, Shard(0), Shard(1)))
    want = rwkv6._wkv_scan(r, kk, vv, w, u, s0)
    out["wkv_out"], out["wkv_state"] = (_max_err(g, t) for g, t in zip(got, want))
    # the scan on local shards: rows over data, channels over model
    a = torch.sigmoid(_rng_tensor(rng, (4, 9, 6)))
    b = _rng_tensor(rng, (4, 9, 6))
    h0 = _rng_tensor(rng, (4, 6))
    got = linear_scan(put(a, Shard(0), Shard(2)), put(b, Shard(0), Shard(2)),
                      put(h0, Shard(0), Shard(1)), use_pallas=True)
    want = linear_scan(a, b, h0)
    out["scan_seq"], out["scan_last"] = (_max_err(g, t) for g, t in zip(got, want))
    out["scan_placements"] = [[type(p).__name__, getattr(p, "dim", None)]
                              for p in got[0].placements]
    try:
        linear_scan(put(a[:, :8], Shard(0), Shard(1)), put(b[:, :8], Shard(0), Shard(1)),
                    use_pallas=True)
        out["scan_split_sequence"] = "no error"
    except ValueError as e:
        out["scan_split_sequence"] = str(e)
    return out


class _Count:
    """Decode steps and prefill groups of every plane in this process,
    counted at class level (no bound method is patched onto an instance)."""

    def __init__(self):
        from repro_torch.kernels.linear_scan import ops
        from repro_torch.serve import plane

        self.n = {"decode": 0, "prefill": 0, "scan_on_shards": 0}
        for cls in (plane.InferencePlane, plane.PagedInferencePlane):
            for name, key in (("decode", "decode"), ("prefill_into", "prefill")):
                if name in vars(cls):
                    setattr(cls, name, self._wrap(getattr(cls, name), key))
        # linear_scan's route for DTensor operands, looked up by name at call time
        ops._scan_on_shards = self._wrap(ops._scan_on_shards, "scan_on_shards")

    def _wrap(self, fn, key):
        def counted(*args, **kw):
            self.n[key] += 1
            return fn(*args, **kw)
        return counted


def serve_cases(dm, params: dict, counter: _Count) -> list[dict]:
    from repro_torch.configs import get_arch
    from repro_torch.interop import params_from_jax
    from repro_torch.launch.mesh import dp_size
    from repro_torch.launch.sharding import cache_shardings, paged_cache_shardings, to_placements
    from repro_torch.models.lm import model as lm
    from repro_torch.serve import ServeConfig, ServeEngine, count_transfers
    from repro_torch.tree import tree_leaves, tree_map_with_path

    results = []
    for arch, slots, bs in CASES:
        cfg = get_arch(arch).smoke_config()
        if arch == "recurrentgemma-2b":  # the RG-LRU through linear_scan's local shards
            cfg = dataclasses.replace(cfg, use_pallas_scan=True)
        sc = ServeConfig(slots=slots, max_len=MAX_LEN, max_new_tokens=NEW_TOKENS,
                         block_size=bs or None)
        eng = ServeEngine(params_from_jax(params[arch], device="cpu"), cfg, sc,
                          mesh=dm, device="cpu")
        rids = [eng.submit(p, **kw) for p, kw in requests(arch)]
        before = dict(counter.n)
        with count_transfers() as c:
            out = eng.run()
        plane = eng.planes[0]
        mesh = plane.mesh
        # the rules on the cache's global shapes
        want = (paged_cache_shardings(plane.cache, cfg, mesh, lm.paged_cache_mask(cfg))
                if bs else cache_shardings(plane.cache, cfg, mesh))
        placed = tree_map_with_path(
            lambda path, t: [str(p) for p in t.placements], plane.cache)
        wanted = tree_map_with_path(
            lambda path, sh: [str(p) for p in to_placements(sh.spec, plane.device_mesh)], want)
        leaves = tree_leaves(plane.cache)
        results.append({
            "arch": arch, "slots": slots, "block_size": bs,
            "tokens": [list(map(int, out[r])) for r in rids],
            "pulls": c["pulls"],
            "decode_steps": counter.n["decode"] - before["decode"],
            "prefill_groups": counter.n["prefill"] - before["prefill"],
            "scans_on_shards": counter.n["scan_on_shards"] - before["scan_on_shards"],
            "placements_equal": tree_leaves(placed) == tree_leaves(wanted),
            "split_leaves": sum(t.to_local().numel() < t.numel() for t in leaves),
            "leaves": len(leaves),
            "cache_bytes": plane.cache_bytes(),
            "cache_bytes_whole": sum(t.numel() * t.element_size() for t in leaves),
            "n_dev": getattr(plane, "n_dev", None),
            "pool_blocks": plane.pool.num_blocks if bs else None,
            "dp": dp_size(mesh),
            "mesh": mesh.shape,
            "lanes_split": plane._lane_placements != plane._whole,
            "occupancy_after": eng.occupancy(),
        })
    return results


def launcher(rank: int, port: int) -> dict:
    """The serving launcher as a group of two ranks, as under
    ``torch.distributed.run``, then (rank 0) on one device.  Returns what
    this rank printed."""
    from repro_torch.launch import serve

    def printed(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        return buf.getvalue()

    argv = [*LAUNCHER_FLAGS, "--smoke", "--device", "cpu"]
    env = dict(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    os.environ.update(env)
    out = {"launcher": printed(argv)}
    assert not dist.is_initialized()
    for k in env:
        del os.environ[k]
    if rank == 0:
        out["launcher_single"] = printed(argv)
    return out


def run_rank(rank: int, world: int, port: int, launcher_port: int, work: str,
             params: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import MeshSpec, device_mesh

    counter = _Count()
    t0 = time.perf_counter()
    try:
        dm = device_mesh(MeshSpec(("data", "model"), MESH), "cpu")
        out = {"local_forms": local_forms(dm)}
        t1 = time.perf_counter()
        out["serve"] = serve_cases(dm, params, counter)
        t2 = time.perf_counter()
    finally:
        dist.destroy_process_group()
    if rank < 2:
        out.update(launcher(rank, launcher_port))
    out["seconds"] = {"local_forms": t1 - t0, "serve": t2 - t1,
                      "launcher": time.perf_counter() - t2}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
