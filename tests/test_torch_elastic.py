"""Elastic training in the port, held against the JAX package, one process.

Twins of tests/test_elastic_engine.py: ``ElasticConfig``'s two fakes —
``clock`` (a mutable list standing in for ``time.monotonic``) and
``step_feed`` (the heartbeat transport, which stops reporting the "dead"
ranks while the clock jumps past the timeout, then reports them from
OUTSIDE the shrunk world to announce their return) — drive the same fault
schedule through both packages' ``build_pipeline(..., elastic=...).fit()``
on the same seeded series and parameters:

- shrink, grow, the epoch-boundary restart and the meta round trip over two
  re-meshes give restart records (``kind``, ``epoch``, ``step``,
  ``world``, ``batch_per_rank``, ``global_batch``, the plan's fields) equal
  to the JAX package's, and loss trajectories within rtol 1e-4 of it (as
  tests/test_torch_pipeline.py: float sums in another order);
- the port's shrink → grow run is bit-identical to its own uninterrupted run
  when the global batch divides (losses, ``val_mae``, final state), and the
  port's runs are deterministic;
- the fault matrix (each rank killed at each of 4 steps) is rank-agnostic,
  with a pre-kill prefix bit-equal to the uninterrupted run;
- ``DataPlane.remesh`` frees the old plane's series before it places the new
  one, and ``remesh="inprocess"`` is refused under a process group.
"""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.distributed import checkpoint_meta, latest_step, scale_batch_or_steps
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import ElasticConfig, PipelineConfig, build_pipeline
from repro_torch.pipeline import dataplane as tdataplane
from repro_torch.train import TrainLoopConfig
from repro_torch.tree import tree_leaves

ENTRIES, NODES, HORIZON, B, WORLD, SEED = 120, 3, 2, 2, 4, 7
DEAD_RANK, DEAD_AT_STEP = 1, 3
RTOL = 1e-4
RECORD = ("kind", "epoch", "step", "world", "batch_per_rank", "global_batch")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class OneDeadWorker:
    """step_feed fake: rank ``dead_rank`` stops heartbeating at global step
    ``dead_after`` while the shared fake clock jumps past the timeout, so the
    next poll flags it DEAD; after the re-mesh every rank beats."""

    def __init__(self, clock, dead_after=DEAD_AT_STEP, dead_rank=DEAD_RANK):
        self.clock, self.dead_after, self.dead_rank = clock, dead_after, dead_rank

    def __call__(self, step: int, world: int) -> dict:
        self.clock[0] += 1.0
        beats = {r: (step, None) for r in range(world)}
        if world == WORLD and step >= self.dead_after:
            del beats[self.dead_rank]
            self.clock[0] += 100.0  # past the 50 s timeout
        return beats


class DeadThenRecovered:
    """step_feed fake for shrink → grow: ``dead_ranks`` go silent at step
    ``dead_after``; from step ``recover_after`` they beat again from OUTSIDE
    the shrunk world (ids >= world)."""

    def __init__(self, clock, dead_ranks=(DEAD_RANK,), dead_after=DEAD_AT_STEP,
                 recover_after=6):
        self.clock, self.dead_ranks = clock, tuple(dead_ranks)
        self.dead_after, self.recover_after = dead_after, recover_after
        self.killed = False

    def __call__(self, step: int, world: int) -> dict:
        self.clock[0] += 1.0
        beats = {r: (step, None) for r in range(world)}
        if not self.killed and world == WORLD and step >= self.dead_after:
            for r in self.dead_ranks:
                del beats[r]
            self.clock[0] += 100.0
            self.killed = True
        if world < WORLD and step >= self.recover_after:
            for i in range(len(self.dead_ranks)):
                beats[world + i] = (step, None)
        return beats


def _torch_loss(p, x, y):
    return torch.mean((x[:, -1] * p["w"] - y[:, 0]) ** 2), {}


def _jax_loss(p, x, y):
    return jnp.mean((x[:, -1] * p["w"] - y[:, 0]) ** 2), {}


def _pipes(ckpt_dir, feed=None, *, epochs=2, jax_side=False, **loop_kw):
    """The port's pipeline (or the JAX package's) over the same series and
    parameters; ``feed(clock)`` builds the step_feed fake (None: no elastic);
    ``loop_kw`` go to the port's TrainLoopConfig."""
    series = make_traffic_series(ENTRIES, NODES)
    clock = [0.0]
    if jax_side:
        elastic = (JElasticConfig(heartbeat_timeout=50.0, clock=lambda: clock[0],
                                  step_feed=feed(clock)) if feed else None)
        return jax_build_pipeline(
            series, JWindowSpec(horizon=HORIZON, input_len=HORIZON), make_host_mesh(),
            _jax_loss, {"w": jnp.full((NODES, 2), 0.1, jnp.float32)},
            JPipelineConfig(batch_per_rank=B, placement=JPlacement.REPLICATED,
                            world=WORLD, seed=SEED, adam=JAdam(lr=1e-2),
                            loop=JLoop(epochs=epochs, log_every=1, ckpt_dir=ckpt_dir)),
            elastic=elastic)
    elastic = (ElasticConfig(heartbeat_timeout=50.0, clock=lambda: clock[0],
                             step_feed=feed(clock)) if feed else None)
    return build_pipeline(
        series, WindowSpec(horizon=HORIZON, input_len=HORIZON), _torch_loss,
        {"w": torch.full((NODES, 2), 0.1)},
        PipelineConfig(batch_per_rank=B, placement=Placement.REPLICATED, world=WORLD,
                       seed=SEED, adam=AdamConfig(lr=1e-2), device="cpu",
                       loop=TrainLoopConfig(epochs=epochs, log_every=1, ckpt_dir=ckpt_dir,
                                            **loop_kw)),
        elastic=elastic)


def _losses(history) -> dict[int, float]:
    return {h["step"]: h["loss"] for h in history if "epoch_time_s" not in h}


def _evals(history) -> dict[int, float]:
    return {h["epoch"]: h["val_mae"] for h in history if "epoch_time_s" in h}


def _records(pipe) -> list[tuple]:
    return [tuple(r[k] for k in RECORD)
            + (r["plan"].dropped_workers, r["plan"].readmitted_workers,
               r["plan"].mesh_shape, r["plan"].decided_by)
            for r in pipe.restarts]


def _both(tmp_path, feed, *, eval_fn=None, **kw):
    """Fit the port and the JAX package under the same fault schedule; hold
    the restart records equal and the trajectories within RTOL."""
    ours = _pipes(str(tmp_path / "t"), feed, **kw)
    theirs = _pipes(str(tmp_path / "j"), feed, jax_side=True, **kw)
    state, hist = ours.fit(eval_fn=eval_fn)
    jstate, jhist = theirs.fit(eval_fn=eval_fn)
    assert _records(ours) == _records(theirs)
    a, b = _losses(hist), _losses(jhist)
    assert sorted(a) == sorted(b)
    np.testing.assert_allclose([a[s] for s in sorted(a)], [b[s] for s in sorted(a)],
                               rtol=RTOL)
    np.testing.assert_allclose(state["params"]["w"].numpy(),
                               np.asarray(jstate["params"]["w"]), rtol=RTOL)
    return ours, state, hist, jhist


def _monotonic(history) -> list[int]:
    steps = [h["step"] for h in history if "epoch_time_s" not in h]
    assert steps == sorted(steps) and len(steps) == len(set(steps))
    assert [h["epoch"] for h in history if "epoch_time_s" in h] == [0, 1]
    return steps


def test_shrink_chain_matches_jax(tmp_path):
    pipe, _, history, _ = _both(tmp_path, OneDeadWorker)
    (rec,) = pipe.restarts
    assert rec["plan"].dropped_workers == (DEAD_RANK,)
    assert rec["plan"].mesh_shape == (WORLD - 1, 1)
    per, glob = scale_batch_or_steps(B * WORLD, old_dp=WORLD, new_dp=WORLD - 1)
    assert (pipe.world, pipe.config.batch_per_rank, pipe.global_batch) == \
        (WORLD - 1, per, glob)
    assert (rec["epoch"], rec["step"]) == (0, DEAD_AT_STEP)
    _monotonic(history)
    assert latest_step(str(tmp_path / "t")) == max(h["step"] for h in history)
    assert pipe.config.seed == SEED


def test_shrink_is_deterministic(tmp_path):
    s1, h1 = _pipes(str(tmp_path / "a"), OneDeadWorker).fit(eval_fn=None)
    s2, h2 = _pipes(str(tmp_path / "b"), OneDeadWorker).fit(eval_fn=None)
    assert torch.equal(s1["params"]["w"], s2["params"]["w"])
    assert [(h["step"], h["loss"]) for h in h1] == [(h["step"], h["loss"]) for h in h2]


def test_restart_on_epoch_boundary_keeps_summary(tmp_path):
    """A fault on an epoch's last step keeps that epoch's summary row: the
    last health poll runs after the summary, and the resumed run skips the
    finished epoch."""
    assert _pipes(str(tmp_path / "spe"), None).steps_per_epoch == 10
    pipe, _, history, _ = _both(tmp_path, lambda c: OneDeadWorker(c, dead_after=10))
    assert [r["step"] for r in pipe.restarts] == [10]
    _monotonic(history)  # epoch 0's summary survived the restart


def test_grow_chain_matches_jax(tmp_path):
    pipe, _, history, _ = _both(tmp_path, DeadThenRecovered)
    assert [r["kind"] for r in pipe.restarts] == ["shrink", "grow"]
    shrink, grow = pipe.restarts
    assert shrink["plan"].dropped_workers == (DEAD_RANK,) and shrink["world"] == WORLD - 1
    assert grow["plan"].readmitted_workers == (WORLD - 1,)
    assert grow["plan"].mesh_shape == (WORLD, 1) and grow["world"] == WORLD
    assert (pipe.world, pipe.config.batch_per_rank, pipe.global_batch) == (WORLD, B, B * WORLD)
    _monotonic(history)
    assert latest_step(str(tmp_path / "t")) == max(h["step"] for h in history)


def test_grow_bit_identical_when_batch_divides(tmp_path):
    """Half the fleet lost and grown back: 8/2 and 8/4 both divide, so the
    port's whole trajectory — losses, val_mae and final state — is
    bit-identical to its uninterrupted run, and within RTOL of JAX's."""
    smooth, smooth_hist = _pipes(str(tmp_path / "smooth"), None).fit()
    feed = lambda c: DeadThenRecovered(c, dead_ranks=(1, 2))  # noqa: E731
    pipe, bumpy, bumpy_hist, jhist = _both(tmp_path, feed, eval_fn="auto")
    assert [(r["kind"], r["world"], r["batch_per_rank"]) for r in pipe.restarts] == \
        [("shrink", WORLD - 2, 2 * B), ("grow", WORLD, B)]
    for a, b in zip(tree_leaves(smooth), tree_leaves(bumpy), strict=True):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert _losses(bumpy_hist) == _losses(smooth_hist)
    assert set(_evals(smooth_hist)) == {0, 1}
    assert _evals(bumpy_hist) == _evals(smooth_hist)
    np.testing.assert_allclose(sorted(_evals(bumpy_hist).items()),
                               sorted(_evals(jhist).items()), rtol=RTOL)


@pytest.mark.parametrize("staleness", [0, 1])
def test_grow_bit_identical_through_the_prefetcher(tmp_path, staleness):
    """The same shrink → grow with the feed prefetcher on: each re-mesh
    drains the old plane's stream first, and the run stays bit-identical to
    the synchronous uninterrupted one."""
    smooth, smooth_hist = _pipes(str(tmp_path / "smooth"), None).fit()
    pipe = _pipes(str(tmp_path / "el"), lambda c: DeadThenRecovered(c, dead_ranks=(1, 2)),
                  prefetch_depth=2, staleness=staleness, prefetch_chunk=3)
    bumpy, bumpy_hist = pipe.fit()
    assert [r["kind"] for r in pipe.restarts] == ["shrink", "grow"]
    assert _losses(bumpy_hist) == _losses(smooth_hist)
    assert _evals(bumpy_hist) == _evals(smooth_hist)
    for a, b in zip(tree_leaves(smooth), tree_leaves(bumpy), strict=True):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_meta_round_trip_across_two_remeshes(tmp_path):
    """(epoch, done_in_epoch) survives steps_per_epoch changing twice
    (4 → 3 → 4: global batch 8 → 9 → 8, 10 → 9 → 10 steps an epoch)."""
    pipe, _, history, _ = _both(
        tmp_path, lambda c: DeadThenRecovered(c, dead_after=12, recover_after=15))
    shrink, grow = pipe.restarts
    assert (shrink["kind"], shrink["epoch"], shrink["step"]) == ("shrink", 1, 12)
    assert (grow["kind"], grow["epoch"], grow["step"]) == ("grow", 1, 17)
    assert (shrink["batch_per_rank"], shrink["global_batch"]) == (3, 9)
    assert grow["batch_per_rank"] == B and pipe.global_batch == B * WORLD
    _monotonic(history)
    ckpt = str(tmp_path / "t")
    assert latest_step(ckpt) == max(h["step"] for h in history)
    assert checkpoint_meta(ckpt) == {"epoch": 2, "done_in_epoch": 0}


@pytest.fixture(scope="module")
def smooth_losses(tmp_path_factory):
    pipe = _pipes(str(tmp_path_factory.mktemp("smooth")), None)
    return _losses(pipe.fit(eval_fn=None)[1])


@pytest.mark.parametrize("dead_at", [1, 4, 9, 10])
def test_fault_matrix_rank_agnostic(tmp_path, dead_at, smooth_losses):
    """Each rank killed at step ``dead_at``: the same trajectory whoever
    died, a pre-kill prefix bit-equal to the uninterrupted run, no gap and
    no repeat; rank 0's run within RTOL of JAX's and with JAX's record."""
    trajectories = []
    detect = dead_at if dead_at > 1 else 2  # a never-beaten rank gets one poll of grace
    for rank in range(WORLD):
        pipe = _pipes(str(tmp_path / f"r{rank}"),
                      lambda c: OneDeadWorker(c, dead_after=dead_at, dead_rank=rank))
        losses = _losses(pipe.fit(eval_fn=None)[1])
        assert [(r["epoch"], r["step"]) for r in pipe.restarts] == [(detect // 10, detect)]
        assert all(losses[s] == smooth_losses[s] for s in range(1, detect + 1))
        assert sorted(losses) == list(range(1, max(losses) + 1))
        trajectories.append(losses)
    assert all(t == trajectories[0] for t in trajectories[1:])
    _both(tmp_path / "jax", lambda c: OneDeadWorker(c, dead_after=dead_at, dead_rank=0))


def test_remesh_frees_the_old_series_first(tmp_path):
    """The engine drops its step (which closes over the series) and the
    plane gives up its series before the new plane places one."""
    pipe = _pipes(str(tmp_path / "ck"), OneDeadWorker)
    old = weakref.ref(pipe.dataplane.dataset.series)
    seen = []
    remesh = tdataplane.DataPlane.remesh

    def spy(self, **kw):
        out = remesh(self, **kw)
        gc.collect()
        seen.append(old())
        return out

    tdataplane.DataPlane.remesh = spy
    try:
        pipe.fit(eval_fn=None)
    finally:
        tdataplane.DataPlane.remesh = remesh
    assert seen == [None]
    assert pipe.dataplane.dataset.series.shape[0] == ENTRIES


def test_inprocess_remesh_is_refused_under_a_process_group(tmp_path, monkeypatch):
    monkeypatch.setattr(tdataplane, "process_info", lambda: (0, 2))
    pipe = _pipes(str(tmp_path / "ck"), OneDeadWorker)
    assert pipe.dataplane.processes == 2
    with pytest.raises(ValueError, match="remesh='inprocess'"):
        pipe.fit(eval_fn=None)
    with pytest.raises(ValueError, match="relaunches"):
        pipe.dataplane.remesh(world=2, batch_per_rank=4)


# ------------------------------------------------- the policy, call for call
def test_heartbeat_monitor_verdicts_equal_jax():
    from repro.distributed import HeartbeatMonitor as JMonitor
    from repro_torch.distributed import HeartbeatMonitor

    def trace(cls):
        t = [0.0]
        mon = cls(4, timeout=10.0, straggler_factor=3.0, clock=lambda: t[0])
        out = [mon.dead()]
        for step in range(1, 8):
            for w in range(4):
                t[0] += 0.5
                if w != 3 or step == 1:  # worker 3 goes silent after step 1
                    mon.beat(w, step, step_time=1.0 if w != 2 else 10.0)
            out.append((mon.dead(), mon.stragglers(), mon.unhealthy()))
        t[0] += 20.0
        mon.beat(0, 3)  # an older step refreshes liveness, keeps the counter
        out.append((mon.dead(), mon.workers[0].last_step))
        return out

    ours = trace(HeartbeatMonitor)
    assert ours == trace(JMonitor)
    assert ours[-2] == ([3], [2], [2, 3]) and ours[-1] == ([1, 2, 3], 7)


@pytest.mark.parametrize("n,unhealthy,recovered,mp,cph", [
    (16, [5], (), 16, 4), (16, [], (), 16, 4), (4, [0], (), 1, 1),
    (4, [], (5, 4), 1, 1), (8, [], (9,), 4, 2), (8, [1, 6], (9,), 2, 1),
    (4, [], (4, 5, 6, 7), 4, 2)])
def test_plan_remesh_equals_jax(n, unhealthy, recovered, mp, cph):
    from repro.distributed import plan_remesh as jplan
    from repro_torch.distributed import plan_remesh

    kw = dict(recovered=recovered, model_parallel=mp, chips_per_host=cph, decided_by=1)
    ours, theirs = plan_remesh(n, unhealthy, **kw), jplan(n, unhealthy, **kw)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.kind == theirs.kind
        assert ours.__dict__ == theirs.__dict__


def test_plan_remesh_exhausted_raises_as_jax():
    from repro.distributed import plan_remesh as jplan
    from repro_torch.distributed import plan_remesh

    for plan in (plan_remesh, jplan):
        with pytest.raises(RuntimeError, match="no healthy TP group"):
            plan(4, [0, 1, 2, 3], model_parallel=4, chips_per_host=4)


@pytest.mark.parametrize("keep", [True, False])
def test_scale_batch_or_steps_equals_jax(keep):
    from repro.distributed import scale_batch_or_steps as jscale

    for g in (8, 9, 1024):
        for old in (1, 3, 4, 16):
            for new in (1, 2, 3, 5, 12):
                assert scale_batch_or_steps(g, old, new, keep_global_batch=keep) == \
                    jscale(g, old, new, keep_global_batch=keep)
