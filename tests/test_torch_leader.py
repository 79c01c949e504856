"""Leader succession in the port, held against the JAX package: twins of
tests/test_leader.py, each driving the same call sequence into both packages.

- ``LeaderTracker``: the same leader, liveness and ``is_leader`` verdicts
  after every call (lowest live rank; timeout and ``note_dead``
  succession; never-beaten grace; out-of-world beats ignored; ``reset``);
- ``LeaderCheckpointer``: the same pending steps and takeover results, and
  the same bytes on disk — every array of ``arrays.npz`` and the manifest
  (bar the archive's checksum, which covers zip timestamps) — with each
  package restoring the other's takeover checkpoint; a standby's snapshot
  is a host copy that a later change to the source does not reach;
- ``LeaderHistorySink``: standby buffering, the takeover flush with its
  first-wins dedup, and the torn-tail truncation give the same file, byte
  for byte;
- the engine chain: a dead rank 0 yields a shrink decided by rank 1 with
  JAX's restart record; ``succeed_as_leader`` after a failed collective
  writes the standby checkpoint of the failure step and decides the plan,
  as JAX's does; a survivor that is not the successor takes nothing over.
"""
import json
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed as jd
import repro_torch.distributed as td
from repro.core import Placement as JPlacement
from repro.core import WindowSpec as JWindowSpec
from repro.data import make_traffic_series
from repro.launch.mesh import make_host_mesh
from repro.optim import AdamConfig as JAdam
from repro.pipeline import ElasticConfig as JElasticConfig
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jax_build_pipeline
from repro.train import TrainLoopConfig as JLoop
from repro_torch.core import Placement, WindowSpec
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import ElasticConfig, PipelineConfig, build_pipeline
from repro_torch.train import TrainLoopConfig

PACKAGES = {"jax": jd, "torch": td}


# --------------------------------------------------------------- LeaderTracker
def _tracker_trace(pkg, script):
    """Run ``script(tracker, clock)`` steps, recording the verdicts after each."""
    clock = [0.0]
    world, own, timeout, steps = script
    t = pkg.LeaderTracker(world, own, timeout=timeout, clock=lambda: clock[0])
    out = []
    for op, arg in steps:
        if op == "tick":
            clock[0] += arg
        elif op == "reset":
            t.reset(arg)
        else:
            getattr(t, op)(arg)
        out.append((t.live(), t.leader(), t.is_leader(), sorted(t.own_ranks), t.world))
    return out


TRACKER_SCRIPTS = {
    "lowest_live_wins": (4, [2, 3], 5.0, [
        ("observe", {r: (1, None) for r in range(4)}), ("tick", 2.0),
        ("observe", {2: (2, None), 3: (2, None)}), ("tick", 4.0)]),
    "never_beaten_grace": (2, [1], 5.0, [
        ("tick", 100.0), ("observe", {1: (1, None)}), ("tick", 4.0), ("tick", 2.0),
        ("observe", {1: (2, None)})]),
    "note_dead_then_heal": (3, [1], 1e9, [
        ("observe", {r: (1, None) for r in range(3)}), ("note_dead", [0]),
        ("observe", {0: (5, None)})]),
    "last_survivor_and_outsiders": (2, [1], 1e9, [
        ("note_dead", [0]), ("observe", {7: (3, None)}), ("note_dead", [1])]),
    "reset": (4, [1], 5.0, [("note_dead", [0]), ("reset", 3), ("tick", 10.0)]),
}


@pytest.mark.parametrize("name", sorted(TRACKER_SCRIPTS))
def test_tracker_verdicts_equal_jax(name):
    script = TRACKER_SCRIPTS[name]
    assert _tracker_trace(td, script) == _tracker_trace(jd, script)


def test_lowest_live_rank_wins():
    trace = _tracker_trace(td, TRACKER_SCRIPTS["lowest_live_wins"])
    assert trace[0][1:3] == (0, False)
    assert trace[-1][:3] == ([2, 3], 2, True)


# ---------------------------------------------------------- LeaderCheckpointer
def _state(pkg):
    w = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    return {"w": jnp.asarray(w) if pkg is jd else torch.as_tensor(w)}


def _on_disk(directory, step):
    path = os.path.join(directory, f"step_{step:010d}")
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        arrays = {n: z.read(n) for n in z.namelist()}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    del manifest["files"]  # the archive's sha256 covers zip member timestamps
    return arrays, manifest


def test_standby_snapshot_takeover_writes_the_same_bytes(tmp_path):
    trace = {}
    for name, pkg in PACKAGES.items():
        d = str(tmp_path / name)
        lead = [False]
        ck = pkg.LeaderCheckpointer(pkg.Checkpointer(d), lambda: lead[0])
        ck.save(_state(pkg), step=4, meta={"epoch": 0, "done_in_epoch": 4})
        nothing = pkg.latest_step(d)
        pending = ck.pending_step
        lead[0] = True
        took = ck.takeover()
        trace[name] = (nothing, pending, took, ck.takeover(), pkg.checkpoint_meta(d),
                       _on_disk(d, 4))
    assert trace["torch"] == trace["jax"]
    assert trace["torch"][:4] == (None, 4, 4, None)
    # each package restores the other's takeover checkpoint
    ours, step = td.restore(str(tmp_path / "jax"), _state(td))
    theirs, jstep = jd.restore(str(tmp_path / "torch"), _state(jd))
    assert step == jstep == 4
    np.testing.assert_array_equal(ours["w"].numpy(), np.asarray(theirs["w"]))


def test_leader_saves_land_directly_and_clear_pending(tmp_path):
    for name, pkg in PACKAGES.items():
        d = str(tmp_path / name)
        ck = pkg.LeaderCheckpointer(pkg.Checkpointer(d), lambda: True)
        ck.save(_state(pkg), step=1)
        ck.wait()
        assert pkg.latest_step(d) == 1
        assert ck.pending_step is None and ck.takeover() is None
    assert _on_disk(str(tmp_path / "torch"), 1) == _on_disk(str(tmp_path / "jax"), 1)


def test_standby_snapshot_survives_a_changed_source(tmp_path):
    lead = [False]
    ck = td.LeaderCheckpointer(td.Checkpointer(str(tmp_path)), lambda: lead[0])
    state = {"w": torch.arange(4.0)}
    ck.save(state, step=2)
    state["w"][:] = -1.0
    lead[0] = True
    ck.takeover()
    restored, _ = td.restore(str(tmp_path), {"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.arange(4.0))


# ----------------------------------------------------------- LeaderHistorySink
ROWS = [{"step": s, "epoch": 0, "loss": 1.0 - 0.1 * s} for s in range(1, 5)]


def _sink_scenario(pkg, path):
    dead = pkg.LeaderHistorySink(path, lambda: True)
    for row in ROWS[:2]:
        dead.append(row)
    dead.close()
    lead = [False]
    succ = pkg.LeaderHistorySink(path, lambda: lead[0])
    for row in ROWS[:3]:
        succ.append(row)
    untouched = open(path).read()
    lead[0] = True
    flushed = succ.flush_as_leader()
    succ.append(ROWS[3])
    rows = succ.load()
    succ.close()
    return untouched, flushed, [r["step"] for r in rows], open(path, "rb").read()


def test_standby_buffers_takeover_flushes_dedup_same_file(tmp_path):
    ours = _sink_scenario(td, str(tmp_path / "t.jsonl"))
    theirs = _sink_scenario(jd, str(tmp_path / "j.jsonl"))
    assert ours == theirs
    assert ours[1:3] == (1, [1, 2, 3, 4])


def test_buffer_standby_off_keeps_no_unflushable_copy(tmp_path):
    s = td.LeaderHistorySink(str(tmp_path / "h.jsonl"), lambda: False, buffer_standby=False)
    for row in ROWS:
        s.append(row)
    assert s._buffer == [] and len(s.rows) == 4
    s.bind(lambda: True)
    assert s.flush_as_leader() == 0
    s.close()
    assert not os.path.exists(tmp_path / "h.jsonl")


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_takeover_truncates_a_torn_tail(tmp_path, name):
    path = str(tmp_path / "h.jsonl")
    with open(path, "w") as f:
        f.write('{"step": 1, "epoch": 0, "loss": 1.0}\n{"step": 2, "epoch": 0, "lo')
    succ = PACKAGES[name].LeaderHistorySink(path, lambda: False)
    succ.append({"step": 2, "epoch": 0, "loss": 0.9})
    succ.bind(lambda: True)
    assert succ.flush_as_leader() == 1
    assert [(r["step"], r["loss"]) for r in succ.load()] == [(1, 1.0), (2, 0.9)]
    succ.close()
    assert open(path).read() == ('{"step": 1, "epoch": 0, "loss": 1.0}\n'
                                 '{"step": 2, "epoch": 0, "loss": 0.9}\n')


# ------------------------------------------------ the engine: the leader dies
ENTRIES, NODES, WORLD, B = 120, 3, 4, 2


class LeaderDies:
    """step_feed fake: rank 0 stops beating at step 3 while the clock flies
    past the timeout; the process owning ranks 1..3 must take over."""

    def __init__(self, clock, dead_after: int = 3):
        self.clock, self.dead_after = clock, dead_after

    def __call__(self, step: int, world: int) -> dict:
        self.clock[0] += 1.0
        beats = {r: (step, None) for r in range(world)}
        if world == WORLD and step >= self.dead_after:
            del beats[0]
            self.clock[0] += 100.0
        return beats


def _pipe(pkg, ckpt, elastic_kw, *, world=WORLD, epochs=2, ckpt_every=0):
    series = make_traffic_series(ENTRIES, NODES)
    if pkg is jd:
        return jax_build_pipeline(
            series, JWindowSpec(horizon=2, input_len=2), make_host_mesh(),
            lambda p, x, y: (jnp.mean((x[:, -1] * p["w"] - y[:, 0]) ** 2), {}),
            {"w": jnp.full((NODES, 2), 0.1, jnp.float32)},
            JPipelineConfig(batch_per_rank=B, placement=JPlacement.REPLICATED, world=world,
                            seed=7, adam=JAdam(lr=1e-2),
                            loop=JLoop(epochs=epochs, log_every=1, ckpt_every=ckpt_every,
                                       ckpt_dir=ckpt)),
            elastic=JElasticConfig(**elastic_kw))
    return build_pipeline(
        series, WindowSpec(horizon=2, input_len=2),
        lambda p, x, y: (torch.mean((x[:, -1] * p["w"] - y[:, 0]) ** 2), {}),
        {"w": torch.full((NODES, 2), 0.1)},
        PipelineConfig(batch_per_rank=B, placement=Placement.REPLICATED, world=world,
                       seed=7, adam=AdamConfig(lr=1e-2), device="cpu",
                       loop=TrainLoopConfig(epochs=epochs, log_every=1,
                                            ckpt_every=ckpt_every, ckpt_dir=ckpt)),
        elastic=ElasticConfig(**elastic_kw))


def test_dead_rank0_shrink_decided_by_successor(tmp_path):
    out = {}
    for name, pkg in PACKAGES.items():
        clock = [0.0]
        tracker = pkg.LeaderTracker(WORLD, [1, 2, 3], timeout=50.0, clock=lambda: clock[0])
        pipe = _pipe(pkg, str(tmp_path / name),
                     dict(heartbeat_timeout=50.0, clock=lambda: clock[0],
                          step_feed=LeaderDies(clock), leader=tracker))
        before = pipe.is_leader()
        _, history = pipe.fit(eval_fn=None)
        (rec,) = pipe.restarts
        plan = rec["plan"]
        out[name] = (before, plan.kind, plan.dropped_workers, plan.decided_by,
                     pipe.world, pipe.is_leader(), sorted(tracker.own_ranks),
                     [rec[k] for k in ("epoch", "step", "world", "batch_per_rank",
                                       "global_batch")],
                     [h["step"] for h in history])
    assert out["torch"] == out["jax"]
    assert out["torch"][:7] == (False, "shrink", (0,), 1, WORLD - 1, True, [0, 1, 2])


def test_succeed_as_leader_takes_over_checkpoint_and_plan(tmp_path):
    out = {}
    for name, pkg in PACKAGES.items():
        clock = [0.0]
        tracker = pkg.LeaderTracker(2, [1], timeout=50.0, clock=lambda: clock[0])

        def step_feed(step, world):
            clock[0] += 1.0
            if step >= 3:
                raise RuntimeError("Gloo all-reduce failed: connection closed by peer")
            return {r: (step, None) for r in range(world)}

        ckpt = str(tmp_path / name)
        pipe = _pipe(pkg, ckpt, dict(heartbeat_timeout=50.0, clock=lambda: clock[0],
                                     step_feed=step_feed, leader=tracker,
                                     remesh="relaunch"),
                     world=2, epochs=1, ckpt_every=1)
        with pytest.raises(RuntimeError, match="closed by peer"):
            pipe.fit(eval_fn=None)
        nothing = pkg.latest_step(ckpt)
        got = pipe.succeed_as_leader([0])
        plan = got["plan"]
        out[name] = (nothing, got["leader"], got["ckpt_step"], pkg.latest_step(ckpt),
                     plan.kind, plan.dropped_workers, plan.decided_by,
                     _on_disk(ckpt, 3)[1])
    assert out["torch"] == out["jax"]
    assert out["torch"][:7] == (None, 1, 3, 3, "shrink", (0,), 1)


def test_non_successor_does_not_take_over(tmp_path):
    for name, pkg in PACKAGES.items():
        ckpt = str(tmp_path / name)
        pipe = _pipe(pkg, ckpt, dict(leader=pkg.LeaderTracker(3, [2], timeout=1e9),
                                     remesh="relaunch"), world=3, epochs=1)
        assert pipe.succeed_as_leader([0]) is None
        assert not os.path.exists(ckpt) or pkg.latest_step(ckpt) is None
