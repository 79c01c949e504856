"""Production-mesh dry-run: one step of every (arch × shape × mesh) cell on a
fake process group.

Per cell this shows, with one process and no card per rank, that the
distribution config is coherent: the cell's DTensor program runs one step on
a ``DeviceMesh`` of 256 or 512 ranks (``torch.distributed``'s fake process
group, rank 0's view), and :class:`~repro_torch.launch.costs.CostCounter`
counts that rank's FLOPs, bytes, collectives and peak live memory — the
inputs of ``roofline.py``.  The records have the JAX package's schema, so
either package's ``roofline.py`` reads either package's records.

Local shards are meta tensors: shapes and storages, no data, no allocation.
(Under ``FakeTensorMode`` DTensor takes its tracing paths, whose
redistribute planner reads rank coordinates as data and fails.)  The
microbatch loop and the blockwise-attention kv loop run two trips, the
second counted for the rest (``repro_torch.loops.trips``).  A stage of ``R``
alike layers is run at depth 1 and 2, and every count is extended linearly
to ``R``: the layers of a stage
are identical, so FLOPs, bytes and collectives grow by the same amount per
layer, and so does live memory (a layer's weights, optimizer state, cache
and saved activations).

Usage:
  python -m repro_torch.launch.dryrun --device cpu --arch qwen1.5-4b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --device cpu --all --out build/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import time
import traceback

import torch

from repro_torch.launch.costs import _COLLECTIVES, CUDA_BLOCK, CostCounter


def collective_bytes(costs) -> dict:
    """A counter's collective table in the JAX record's layout: bytes by
    kind (result shapes, per device), ``total`` and ``counts``."""
    out = {k: float(costs.coll_by_op.get(k, 0.0)) for k in _COLLECTIVES}
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = {k: int(costs.coll_counts.get(k, 0)) for k in _COLLECTIVES}
    return out


@dataclasses.dataclass
class _Run:
    """The numbers of one counted step, for linear extension in depth."""

    flops: float
    bytes: float
    coll: dict
    counts: dict
    peak: int
    output: int
    alias: int

    def extend(self, other: "_Run", k: int) -> "_Run":
        """``self + k · (other - self)``: depth 1 and 2 -> depth 1 + k."""
        lin = lambda a, b: a + k * (b - a)
        return _Run(lin(self.flops, other.flops), lin(self.bytes, other.bytes),
                    {c: lin(self.coll[c], other.coll[c]) for c in self.coll},
                    {c: lin(self.counts[c], other.counts[c]) for c in self.counts},
                    lin(self.peak, other.peak), lin(self.output, other.output),
                    lin(self.alias, other.alias))


def init_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (torch's
    ``fake`` backend: collectives complete at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def count_step(prog, device_mesh, *, block: int = 1) -> _Run:
    """One step of ``prog`` on meta shards placed on ``device_mesh``."""
    from repro_torch.launch.specs import empty_local, place_args

    counter = CostCounter(block=block, roll=True)
    args = place_args(prog, device_mesh, empty_local("meta"))
    counter.track(args)
    with counter:
        out = prog.fn(*args)
    keys_in = counter.live_keys(args)
    keys_out = counter.live_keys(out)
    c = counter.costs
    return _Run(c.flops, c.bytes, dict(c.coll_by_op), dict(c.coll_counts),
                c.peak_bytes, sum(keys_out.values()),
                sum(n for k, n in keys_out.items() if k in keys_in))


def _stage_cut(arch, repeats: int):
    """``arch`` with its one multi-repeat stage cut to ``repeats`` (None
    when no stage repeats), and that stage's full repeat count."""
    from repro_torch.models.lm.model import stage_plan

    if arch.lm is None:
        return None, 1
    plan = stage_plan(arch.lm)
    multi = [i for i, (_, r) in enumerate(plan) if r > 1]
    if not multi:
        return None, 1
    if len(multi) > 1:
        raise NotImplementedError(f"{arch.id}: {len(multi)} stages repeat")
    specs, full = plan[multi[0]]
    lm = dataclasses.replace(arch.lm, layers=arch.lm.layers - (full - repeats) * len(specs))
    if stage_plan(lm)[multi[0]][1] != repeats:
        raise NotImplementedError(f"{arch.id}: cannot cut the repeating stage")
    return dataclasses.replace(arch, lm=lm), full


def _local_nbytes(tspec, pspec, mesh) -> int:
    from repro_torch.launch.specs import local_shape

    return math.prod(local_shape(tspec.shape, pspec, mesh)) * tspec.dtype.itemsize


def _rounded(n: int, block: int) -> int:
    return -(-n // block) * block


def count_cell(arch, cell, mesh, device_mesh, *, block: int = 1, **build_kw) -> _Run:
    """Per-device counts of one step of ``arch``'s ``cell`` on ``mesh``
    (a :class:`MeshSpec`, realised as ``device_mesh``): counted once, or at
    depth 1 and 2 and extended to the stage's repeats."""
    from repro_torch.launch import specs

    build = (specs.build_stgnn_train if arch.family == "stgnn" else
             {"train": specs.build_lm_train, "prefill": specs.build_lm_prefill,
              "decode": specs.build_lm_decode}[cell.kind])
    cut1, full = _stage_cut(arch, 1)
    if cut1 is None:
        return count_step(build(arch, cell, mesh, **build_kw), device_mesh, block=block)
    cut2, _ = _stage_cut(arch, 2)
    r1 = count_step(build(cut1, cell, mesh, **build_kw), device_mesh, block=block)
    r2 = count_step(build(cut2, cell, mesh, **build_kw), device_mesh, block=block)
    return r1.extend(r2, full - 1)


def argument_bytes(prog, mesh, block: int = 1) -> int:
    """Bytes of one device's argument shards (each its own storage)."""
    from repro_torch.launch.specs import _leaf_pairs

    return sum(_rounded(_local_nbytes(s, sh.spec, mesh), block)
               for s, sh in _leaf_pairs(prog.args, prog.in_shardings))


def record(rec: dict, prog, run: _Run, arg_bytes: int, compute_dtype: str) -> dict:
    """Fill ``rec`` with ``run``'s numbers in the JAX record's schema."""
    rec["memory"] = {
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(run.output),
        "temp_bytes": int(run.peak - arg_bytes - run.output + run.alias),
        "alias_bytes": int(run.alias),
        "peak_bytes": int(run.peak),
    }
    rec["cost"] = {"flops": float(run.flops), "bytes_accessed": float(run.bytes)}
    coll = {k: float(run.coll.get(k, 0.0)) for k in _COLLECTIVES}
    rec["collectives"] = {**coll, "total": sum(coll.values()),
                          "counts": {k: int(run.counts.get(k, 0)) for k in _COLLECTIVES}}
    rec["meta"] = {k: (float(v) if isinstance(v, (int, float)) else v)
                   for k, v in prog.meta.items()}
    rec["kind"] = prog.kind
    rec["compute_dtype"] = compute_dtype
    rec["status"] = "ok"
    return rec


class CellTimeout(BaseException):
    """A cell ran past its time limit (a BaseException, so that no
    ``except Exception`` on the way swallows it)."""


@contextlib.contextmanager
def _time_limit(seconds: float | None):
    """Raise :class:`CellTimeout` in this (main) thread after ``seconds``,
    and every second after that until the block is left."""
    if not seconds:
        yield
        return

    def expire(signum, frame):
        where = f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"
        raise CellTimeout(f"no step after {seconds:g} s (in {frame.f_code.co_name}, "
                          f"{where})")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds, 1.0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             device: str = "cuda", timeout: float | None = None,
             verbose: bool = True, **build_kw) -> dict:
    """Run one cell's step on the production mesh over a fake process group
    made here (and destroyed after); return the dry-run / roofline record.
    ``timeout``: seconds before the cell is recorded as failed."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs

    spec = M.make_production_mesh(multi_pod=multi_pod)
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": spec.label,
                 "chips": M.mesh_chips(spec), "multi_pod": multi_pod,
                 "options": {k: str(v) for k, v in build_kw.items()}}
    t0 = time.time()
    try:
        dev = torch.device(device)
        block = CUDA_BLOCK if dev.type == "cuda" else 1
        prog = specs.build_cell(arch_id, shape_name, spec, **build_kw)
        arch = get_arch(arch_id)
        cell = next(s for s in arch.shapes if s.name == shape_name)
        init_fake_group(M.mesh_chips(spec))
        with _time_limit(timeout):
            run = count_cell(arch, cell, spec, M.device_mesh(spec, dev.type),
                             block=block, **build_kw)
        rec["run_s"] = round(time.time() - t0, 2)
        record(rec, prog, run, argument_bytes(prog, spec, block),
               arch.lm.dtype if arch.lm is not None
               else build_kw.get("compute_dtype") or "float32")
    except (Exception, CellTimeout) as e:  # noqa: BLE001 — recorded; main() exits non-zero
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if verbose:
        print(format_record(rec), flush=True)
    return rec


def format_record(rec: dict) -> str:
    """One line: status, per-device peak, FLOPs, bytes and collectives."""
    name = f"{rec['arch']}:{rec['shape']}"
    placement = rec.get("meta", {}).get("placement") or rec.get("options", {}).get("placement")
    if placement:
        name += f":{placement}"
    if rec.get("status") == "skipped":
        return f"[skip] {name} — {str(rec.get('reason'))[:80]}"
    if rec.get("status") != "ok":
        return f"[ERR] {name} mesh={rec.get('mesh')}: {rec.get('error')}"
    coll = rec["collectives"]
    kinds = " ".join(f"{k}={coll[k] / 2**20:.1f}MiB/{coll['counts'][k]}"
                     for k in _COLLECTIVES if coll["counts"][k])
    return (f"[ok] {name} mesh={rec['mesh']} run={rec['run_s']}s "
            f"peak/device={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
            f"flops/device={rec['cost']['flops']:.3e} "
            f"bytes/device={rec['cost']['bytes_accessed']:.3e} "
            f"coll/device={coll['total'] / 2**20:.1f}MiB [{kinds or 'none'}]")


def partitioned_halo_evidence(world: int = 8, *, device: str = "cuda",
                              entries: int = 256, nodes: int = 4, features: int = 2,
                              global_batch: int = 16, input_len: int = 3,
                              horizon: int = 3) -> dict:
    """Collective-bytes evidence for the PARTITIONED ``halo`` knob, on a
    fake mesh of ``world`` data slots.

    ``halo=False`` confines every sampled window to the series shard its
    rank owns, so the step is the per-rank program: shard-local starts, and
    the ONLY collective is the gradient all-reduce.  ``halo=True`` windows
    may spill ``span−1`` steps into the next shard, which takes the
    global-index program over the time-sharded series: the gather from it
    all-gathers the resident series.

    In the JAX package XLA's partitioner chooses these collectives; here
    each program states its own (the explicit all-reduce, the series
    redistributed to replicated), so the tables are the communication the
    port's programs specify.  ``tests/test_torch_dryrun.py`` holds them to
    the JAX programs' compiled tables.

    Returns both programs' per-device collective tables plus ``data_bytes``
    = everything except the gradient all-reduce.
    """
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.batching import gather_batch_fused
    from repro_torch.launch import mesh as M
    from repro_torch.launch.specs import _all_reduce_partial, _program

    spec = M.make_host_mesh(devices=world)
    init_fake_group(world)
    try:
        dm = M.device_mesh(spec, torch.device(device).type)
        rep, sh = [Replicate(), Replicate()], [Shard(0), Replicate()]

        def loss(w, series, starts):
            x, y = gather_batch_fused(series, starts, input_len=input_len,
                                      horizon=horizon)
            return torch.mean(torch.square((x * w).sum(-1))) + torch.mean(y)

        def grad(w, series, starts):
            w = w.detach().requires_grad_(True)
            with torch.enable_grad():
                l = loss(w, series, starts)
                (g,) = torch.autograd.grad(l, [w])
            return l.detach(), g

        shard_len = entries // world

        def step_local(w, series, starts):
            # inside the shard, global starts become shard-local offsets
            lo = dm.get_coordinate()[0] * shard_len
            l, g = grad(w.to_local(), series.to_local(), starts.to_local() - lo)
            mean = lambda t: funcol.all_reduce(t, "sum", dist.group.WORLD) / world
            return mean(l), mean(g)

        def step_global(w, series, starts):
            with _program():
                src = series.redistribute(dm, rep)  # global starts: whole series
                l, g = grad(w, src, starts)
                return l, _all_reduce_partial(g)

        def place(shape, dtype, placements):
            local = list(shape)
            if placements[0] == Shard(0):
                local[0] //= world
            t = torch.empty(local, dtype=dtype, device="meta")
            return DTensor.from_local(t, dm, placements, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=torch.empty(shape, device="meta").stride())

        def count(fn):
            args = (place((features,), torch.float32, rep),
                    place((entries, nodes, features), torch.float32, sh),
                    place((global_batch,), torch.int32, sh))
            counter = CostCounter()
            with counter:
                fn(*args)
            coll = collective_bytes(counter.costs)
            coll["data_bytes"] = coll["total"] - coll["all-reduce"]
            return coll

        return {
            "mesh": spec.label,
            "dims": {"entries": entries, "nodes": nodes, "features": features,
                     "global_batch": global_batch, "input_len": input_len,
                     "horizon": horizon},
            # halo=False contract: shard-local gathers (the per-rank program)
            "halo_false": count(step_local),
            # halo=True upper bound: global-index gathers over the sharded series
            "halo_true": count(step_global),
        }
    finally:
        dist.destroy_process_group()


def _write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def main(argv=None) -> list[dict]:
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.launch.specs import all_cells

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="the full cell matrix")
    ap.add_argument("--placement", default="replicated",
                    choices=["replicated", "partitioned", "ondemand"],
                    help="ST-GNN series placement")
    ap.add_argument("--halo-evidence", action="store_true",
                    help="run the PARTITIONED step with shard-local "
                         "(halo=False) vs global-index (halo=True) gathers "
                         "and report per-device collective bytes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake mesh (cuda needs a card)")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="seconds a cell may run before it is recorded as failed")
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.halo_evidence:
        rec = partitioned_halo_evidence(device=args.device)
        print(json.dumps(rec, indent=1))
        if args.out:
            _write(args.out, rec)
        df, dt = rec["halo_false"]["data_bytes"], rec["halo_true"]["data_bytes"]
        print(f"halo=False data-collective bytes/device: {df} "
              f"(communication-free: {df == 0}); halo=True: {dt}")
        return [rec]

    if args.all:
        cells = list(all_cells())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, None)]

    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    records = []
    for aid, shape, skip in cells:
        if skip:
            records.append({"arch": aid, "shape": shape, "status": "skipped",
                            "reason": skip})
            print(format_record(records[-1]))
            continue
        kw = {"placement": args.placement} if get_arch(aid).family == "stgnn" else {}
        for mp in meshes:
            records.append(run_cell(aid, shape, multi_pod=mp, device=args.device,
                                    timeout=args.cell_timeout, **kw))

    if args.out:
        _write(args.out, records)
        print(f"wrote {len(records)} records -> {args.out}")
    n_err = sum(1 for r in records if r.get("status") == "error")
    if n_err:
        raise SystemExit(f"{n_err} cells failed")
    return records


if __name__ == "__main__":
    main()
