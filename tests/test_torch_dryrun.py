"""The port's dry-run (``launch/dryrun.py``) and roofline
(``launch/roofline.py``).

- The PARTITIONED halo evidence on a fake mesh of 8: ``halo=False`` moves
  no data-collective byte, ``halo=True`` all-gathers the series.  The
  port's programs state these collectives themselves (DTensor moves what a
  program's placements ask for; nothing partitions it), so the test holds
  their bytes to what XLA's partitioner chose for the JAX programs,
  compiled on 8 forced host devices (a JAX subprocess).
- The ST-GNN cell on a fake mesh of 8 under each placement: its
  data-collective bytes a device equal the compiled JAX cell's, and the
  replicated cell's one gradient all-reduce is the float32 parameter
  bytes, with the JAX package's figure beside it.
- Two mesh axes on one tensor dim: each rank's DTensor shard holds the
  elements JAX's ``NamedSharding`` gives that device (16 forced devices).
- At one rank the dry-run's FLOPs and peak equal those the cost counter
  reads over the real step.
- Records in the JAX schema, read by either package's roofline; a failing
  cell is recorded and makes the CLI exit non-zero.
- ``roofline_terms`` on the JAX test record gives the H100 terms by hand.

Fake process groups are made and destroyed inside each call, so no other
test sees one.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun, roofline
from repro_torch.launch import mesh as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_subprocess(code: str, devices: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_JAX_COLLECTIVES = """
import dataclasses, json, jax
from repro.configs import get_arch
from repro.launch.dryrun import collective_bytes, partitioned_halo_evidence
from repro.launch.mesh import make_host_mesh
from repro.launch.specs import build_stgnn_train
mesh = make_host_mesh()
out = partitioned_halo_evidence(mesh)
arch = get_arch("pgt-dcrnn-pems-all-la")
arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, num_nodes=12))
for placement in ("replicated", "partitioned", "ondemand"):
    prog = build_stgnn_train(arch, arch.shapes[0], mesh, series_len=200, placement=placement)
    with mesh:
        hlo = jax.jit(prog.fn, in_shardings=prog.in_shardings,
                      out_shardings=prog.out_shardings).lower(*prog.args).compile().as_text()
    out[placement] = collective_bytes(hlo)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_collectives():
    """The JAX package's compiled collective tables on 8 forced host
    devices: its halo evidence and the ST-GNN cell under each placement."""
    return _jax_subprocess(_JAX_COLLECTIVES, 8)


def test_halo_evidence_on_a_fake_mesh_of_8(jax_collectives):
    rec = dryrun.partitioned_halo_evidence(8, device="cpu")
    assert rec["mesh"] == "8x1"
    assert rec["halo_false"]["data_bytes"] == 0
    assert rec["halo_false"]["all-reduce"] > 0  # grads still reduce
    assert rec["halo_true"]["data_bytes"] > 0
    assert rec["halo_true"]["counts"]["all-gather"] >= 1
    # the halo=True all-gather is the whole series, f32
    d = rec["dims"]
    assert rec["halo_true"]["all-gather"] == d["entries"] * d["nodes"] * d["features"] * 4
    assert not dist.is_initialized()
    # what the port's programs specify is what XLA's partitioner chose
    for knob in ("halo_false", "halo_true"):
        assert rec[knob]["data_bytes"] == jax_collectives[knob]["data_bytes"], knob
        assert rec[knob]["all-gather"] == jax_collectives[knob]["all-gather"], knob


def _stgnn_cell_on_8(placement):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import specs

    arch = get_arch("pgt-dcrnn-pems-all-la")
    arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, num_nodes=12))
    mesh = M.make_host_mesh(devices=8)
    prog = specs.build_stgnn_train(arch, arch.shapes[0], mesh, series_len=200,
                                   placement=placement)
    dryrun.init_fake_group(8)
    try:
        run = dryrun.count_step(prog, M.device_mesh(mesh, "cpu"))
    finally:
        dist.destroy_process_group()
    return prog, run


@pytest.mark.parametrize("placement", ["replicated", "partitioned", "ondemand"])
def test_stgnn_data_collectives_equal_the_compiled_jax_cell(placement, jax_collectives):
    """Everything but the gradient all-reduce, a device: nothing under
    REPLICATED and PARTITIONED, the whole series all-gathered under
    ONDEMAND, as XLA partitions the JAX cell."""
    _, run = _stgnn_cell_on_8(placement)
    jax_coll = jax_collectives[placement]
    mine = sum(run.coll.values()) - run.coll["all-reduce"]
    assert mine == jax_coll["total"] - jax_coll["all-reduce"]
    assert run.coll["all-gather"] == jax_coll["all-gather"]
    assert (run.counts["all-gather"] > 0) == (placement == "ondemand")


def test_stgnn_replicated_gradient_all_reduce_is_the_parameter_bytes(jax_collectives):
    from repro_torch.tree import tree_leaves

    prog, run = _stgnn_cell_on_8("replicated")
    param_bytes = sum(s.nbytes for s in tree_leaves(prog.args[0]["params"]))
    assert run.coll["all-reduce"] == param_bytes
    assert run.counts["all-reduce"] == len(tree_leaves(prog.args[0]["params"]))
    assert sum(run.coll.values()) == param_bytes  # the replicated series: nothing else
    jax_coll = jax_collectives["replicated"]
    print(f"all-reduce bytes/device: port {run.coll['all-reduce']}, JAX "
          f"{jax_coll['all-reduce']} (f32 parameters: {param_bytes})")
    # XLA reduces the same gradients (and the loss) in its own grouping
    assert jax_coll["all-reduce"] >= param_bytes
    assert jax_coll["total"] - jax_coll["all-reduce"] == 0


_JAX_INDEX_MAP = """
import json, jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 4, 2), ("pod", "data", "model"))
out = {}
for name, spec in (("pd", P(("pod", "data"), "model")), ("dm", P(None, ("data", "model")))):
    m = NamedSharding(mesh, spec).devices_indices_map((16, 8))
    out[name] = [[[s.start or 0, s.stop if s.stop is not None else n]
                  for s, n in zip(m[d], (16, 8))] for d in mesh.devices.reshape(-1)]
print(json.dumps(out))
"""


def test_two_mesh_axes_on_one_dim_shard_like_jax():
    """``P(("pod", "data"))`` splits one dim pod-major: every rank's DTensor
    shard (read off ``distribute_tensor`` of an arange at that rank) is the
    block JAX's index map gives the device at the same mesh position."""
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.sharding import P, to_placements

    want = _jax_subprocess(_JAX_INDEX_MAP, 16)
    spec = M.MeshSpec(("pod", "data", "model"), (2, 4, 2))
    full = torch.arange(16 * 8).reshape(16, 8)
    for name, pspec in (("pd", P(("pod", "data"), "model")), ("dm", P(None, ("data", "model")))):
        for rank in range(16):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=16)
            try:
                dm = M.device_mesh(spec, "cpu")
                local = distribute_tensor(full, dm, to_placements(pspec, dm),
                                          src_data_rank=None).to_local()
            finally:
                dist.destroy_process_group()
            (r0, r1), (c0, c1) = want[name][rank]
            assert torch.equal(local, full[r0:r1, c0:c1]), (name, rank)


def test_dry_run_at_one_rank_equals_the_real_step():
    """FLOPs equal and the live-memory peak equal (block 1 on the CPU)
    between the dry-run on meta shards and the counter over a real step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import specs
    from repro_torch.launch.costs import CostCounter

    arch = get_arch("dcrnn-pems")
    arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, num_nodes=10))
    one = M.MeshSpec(("data", "model"), (1, 1))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        dm = M.device_mesh(one, "cpu")
        for placement in ("replicated", "partitioned"):
            prog = specs.build_stgnn_train(arch, dataclasses.replace(arch.shapes[0],
                                                                     global_batch=4),
                                           one, series_len=64, placement=placement)
            predicted = dryrun.count_step(prog, dm)
            args = specs.place_args(prog, dm, specs.seeded_local("cpu", seed=3))
            counter = CostCounter()
            counter.track(args)
            with counter:
                state, loss = prog.fn(*args)
            assert np.isfinite(float(loss.full_tensor()))
            assert counter.costs.flops == predicted.flops > 0
            assert counter.costs.peak_bytes == predicted.peak
            del state, loss, args
    finally:
        dist.destroy_process_group()


def test_rolled_microbatch_loop_counts_what_the_unrolled_loop_counts():
    """An LM train cell's microbatch loop, rolled as the dry-run rolls it,
    counts the FLOPs, bytes, collectives and peak of the same step unrolled
    (smoke config, 4 microbatches, a fake 2x2 mesh)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import specs
    from repro_torch.launch.costs import CostCounter

    arch = get_arch("qwen1.5-4b")
    arch = dataclasses.replace(arch, lm=arch.smoke_config())
    mesh = M.MeshSpec(("data", "model"), (2, 2))
    prog = specs.build_lm_train(arch, ShapeCell("train_s", "train", 16, 8), mesh,
                                microbatches=4)
    dryrun.init_fake_group(4)
    try:
        dm = M.device_mesh(mesh, "cpu")
        counted = []
        for roll in (False, True):
            counter = CostCounter(roll=roll)
            args = specs.place_args(prog, dm, specs.empty_local("meta"))
            counter.track(args)
            with counter:
                prog.fn(*args)
            counted.append(counter.costs)
            del args
    finally:
        dist.destroy_process_group()
    unrolled, rolled = counted
    assert rolled.flops == unrolled.flops > 0
    assert rolled.bytes == unrolled.bytes
    assert rolled.coll_by_op == unrolled.coll_by_op
    assert rolled.coll_counts == unrolled.coll_counts
    assert rolled.peak_bytes == unrolled.peak_bytes


def test_run_cell_record_has_the_jax_schema_and_both_rooflines_read_it():
    from repro.launch import roofline as jroofline

    rec = dryrun.run_cell("qwen1.5-4b", "decode_32k", device="cpu", verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert not dist.is_initialized()
    assert {"arch", "shape", "mesh", "chips", "multi_pod", "memory", "cost",
            "collectives", "meta", "kind", "status"} <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "peak_bytes"}
    mem = rec["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["alias_bytes"] > 0  # the cache is written in place
    assert rec["mesh"] == "16x16" and rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["collectives"]["total"] == sum(
        rec["collectives"][k] for k in ("all-gather", "all-reduce", "reduce-scatter",
                                        "all-to-all", "collective-permute"))
    mine = roofline.summarize([rec])[0]
    theirs = jroofline.summarize([rec])[0]
    assert mine["model_flops"] == theirs["model_flops"] == 2.0 * rec["meta"][
        "active_params"] * rec["meta"]["tokens_per_step"]
    assert mine["memory_s"] == rec["cost"]["bytes_accessed"] / roofline.HBM_BW
    assert "qwen1.5-4b" in roofline.format_table([mine])


def test_cli_records_a_failing_cell_and_exits_non_zero(tmp_path, capsys):
    out = tmp_path / "rec.json"
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--device", "cpu", "--arch", "qwen1.5-4b", "--shape",
                     "train_1k", "--out", str(out)])
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "error" and "train_1k" in rec["error"]
    assert "[ERR] qwen1.5-4b:train_1k" in capsys.readouterr().out
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.main(["--halo-evidence"])


def test_roofline_terms_of_the_jax_test_record():
    rec = {"cost": {"flops": 1e12, "bytes_accessed": 1e12},
           "collectives": {"total": 1e9}, "chips": 256, "kind": "train",
           "meta": {"active_params": 1e9, "tokens_per_step": 1e6}}
    t = roofline.roofline_terms(rec)
    # H100 SXM datasheet: 989 TFLOP/s bf16, 3.35 TB/s HBM3, 50 GB/s network
    assert t["compute_s"] == pytest.approx(1e12 / 989e12)
    assert t["memory_s"] == pytest.approx(1e12 / 3.35e12)
    assert t["collective_s"] == pytest.approx(1e9 / 50e9)
    assert t["dominant"] == "memory"
    assert t["step_lower_bound_s"] == pytest.approx(1e12 / 3.35e12)
    assert t["model_flops"] == 6e15
    assert t["useful_ratio"] == pytest.approx(6e15 / (1e12 * 256))
    assert t["roofline_fraction"] == pytest.approx((6e15 / 256 / 989e12) / (1e12 / 3.35e12))
    assert 0 < t["roofline_fraction"] < 1
    # an ST-GNN record computes in float32 (TF32 off): the fp32 peak
    st = dict(rec, meta={"flops_model": 6e15})
    assert roofline.roofline_terms(st)["compute_s"] == pytest.approx(1e12 / 67e12)


def test_roofline_cli_reads_a_records_file(tmp_path, capsys):
    rec = {"arch": "a", "shape": "s", "mesh": "16x16", "status": "ok", "kind": "decode",
           "cost": {"flops": 1e12, "bytes_accessed": 1e9}, "chips": 256,
           "collectives": {"total": 0.0}, "memory": {"peak_bytes": 2**30},
           "meta": {"active_params": 1e9, "tokens_per_step": 128}}
    path = tmp_path / "r.json"
    path.write_text(json.dumps([rec, {"arch": "b", "shape": "t", "status": "skipped",
                                      "reason": "why"}]))
    roofline.main([str(path), "--json-out", str(tmp_path / "rows.json")])
    text = capsys.readouterr().out
    assert "compute" in text and "skipped" in text
    rows = json.loads((tmp_path / "rows.json").read_text())
    assert rows[0]["dominant"] == "compute" and rows[0]["peak_gib"] == 1.0
