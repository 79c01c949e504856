#!/usr/bin/env python3
"""Which collectives two gloo ranks sharing one card run on CUDA tensors.

One NVIDIA card takes one NCCL rank, so a mesh of two ranks on it must run
over gloo.  For each op below, two processes (``--rank 0/1``) join a gloo
group on ``cuda:0`` with ``faulthandler`` on and run it once; a crash
(SIGSEGV) prints the Python stack of the op that caused it.  The ``serve_*``
ops run a sharded ``ServeEngine`` (qwen1.5-4b's smoke config, 4 requests)
at data 2 x model 1 and data 1 x model 2 against the unsharded engine.

Usage, from the repository root on a machine with a card:

    python3 tools/gloo_cuda_collectives.py --out build/gloo_cuda
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import socket
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ["init_mesh", "all_reduce_sum", "all_reduce_max", "broadcast", "funcol_all_reduce",
       "all_gather_into_tensor", "all_gather_list", "funcol_all_gather",
       "reduce_scatter_tensor", "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
       "serve_data2", "serve_model2"]


def _serve(sizes):
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.lm import model as lm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_arch("qwen1.5-4b").smoke_config()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 120, int(rng.integers(3, 12))) for _ in range(4)]
    outs = []
    for mesh in (None, MeshSpec(("data", "model"), sizes)):
        eng = ServeEngine(params, cfg, ServeConfig(slots=4, max_len=48, max_new_tokens=5),
                          mesh=mesh, device="cuda")
        rids = [eng.submit(p) for p in prompts]
        out = eng.run()
        outs.append([out[r] for r in rids])
    return outs[0] == outs[1]


def rank_main(rank: int, port: int, op: str, path: str) -> None:
    faulthandler.enable()
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    res = {"op": op, "rank": rank}
    try:
        x = torch.full((4, 3), float(rank + 1), device="cuda")
        if op == "init_mesh":
            from torch.distributed.device_mesh import init_device_mesh
            res["out"] = str(init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model")))
        elif op in ("all_reduce_sum", "all_reduce_max"):
            dist.all_reduce(x, op=dist.ReduceOp.SUM if op.endswith("sum") else dist.ReduceOp.MAX)
            res["out"] = x.sum().item()
        elif op == "broadcast":
            dist.broadcast(x, 0)
            res["out"] = x.sum().item()
        elif op == "funcol_all_reduce":
            res["out"] = funcol.all_reduce(x, "max", dist.group.WORLD).sum().item()
        elif op == "all_gather_into_tensor":
            out = torch.empty((8, 3), device="cuda")
            dist.all_gather_into_tensor(out, x)
            res["out"] = out.sum().item()
        elif op == "all_gather_list":
            outs = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(outs, x)
            res["out"] = sum(o.sum().item() for o in outs)
        elif op == "funcol_all_gather":
            res["out"] = funcol.all_gather_tensor(x, 0, dist.group.WORLD).sum().item()
        elif op == "reduce_scatter_tensor":
            out = torch.empty((2, 3), device="cuda")
            dist.reduce_scatter_tensor(out, x)
            res["out"] = out.sum().item()
        elif op.startswith("dtensor"):
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
            m = init_device_mesh("cuda", (2,), mesh_dim_names=("model",))
            pl = [Shard(0)] if op == "dtensor_shard_to_replicate" else [Partial()]
            d = DTensor.from_local(x, m, pl, run_check=False)
            res["out"] = d.redistribute(m, [Replicate()]).to_local().sum().item()
        else:
            res["out"] = _serve((2, 1) if op == "serve_data2" else (1, 2))
        torch.cuda.synchronize()
    except Exception:
        res["error"] = traceback.format_exc()[-1500:]
    with open(path, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "gloo_cuda"))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--op", default=None)
    ap.add_argument("--result", default=None)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.port, args.op, args.result)
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    results = {}
    for op in OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        paths = [os.path.join(args.out, f"{op}_{r}.json") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   "--port", str(port), "--op", op, "--result", paths[r]],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(2)]
        outs = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            outs.append((p.returncode, err[-2500:]))
        done = []
        for q in paths:
            if os.path.exists(q):
                with open(q) as f:
                    done.append(json.load(f))
        results[op] = {"codes": [c for c, _ in outs], "results": done,
                       "stderr": [e for c, e in outs if c != 0][:1]}
        print(op, results[op]["codes"],
              [(r.get("out"), r.get("error", "")[-400:]) for r in done], flush=True)
        if results[op]["stderr"]:
            print("  stderr:", results[op]["stderr"][0][-1800:], flush=True)
    with open(os.path.join(args.out, "collectives.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
