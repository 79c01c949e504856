"""Engine — the execution half of the pipeline: the train step with the
window gather fused in, checkpoints, ``fit`` and ``evaluate``, and elastic
restarts.

The engine owns what the :class:`~repro_torch.pipeline.dataplane.DataPlane`
does not: the step that gathers (x, y) from the resident series and runs
loss, gradients and AdamW, the checkpointer (``loop.ckpt_dir``: ``fit``
resumes from its latest checkpoint), the prefetch pipeline
(``loop.prefetch_depth``) and the evaluation over the val/test feeds.

Under ``torch.distributed`` each process trains its own feed columns (or,
under ``ONDEMAND``, its block of what the exchange assembles), the step
all-reduces gradients and loss over the group, process 0 alone writes
checkpoints and history rows (every rank restores), and :meth:`Engine.evaluate`
combines every process's ``(loss, windows)`` pairs in rank order, so every
rank returns the same value.

With an :class:`ElasticConfig` attached, ``fit`` survives worker loss:

1. every step, worker heartbeats reach the
   :class:`~repro_torch.distributed.HeartbeatMonitor`
   (``ElasticConfig.step_feed`` is the transport — a real one from
   :mod:`repro_torch.distributed.transport` across processes, a
   deterministic fake in one-process fault-injection tests);
2. when the monitor flags a worker, the leader (the lowest live rank,
   :mod:`repro_torch.distributed.leader`) plans the largest healthy world
   (``plan_remesh``) and the in-flight state is checkpointed with its
   (epoch, done_in_epoch) coordinates;
3. in one process (``remesh="inprocess"``) the engine rebuilds the data
   plane for the new world (``DataPlane.remesh``: series placed again,
   sampler rebuilt, per-rank batch re-scaled by ``scale_batch_or_steps``
   against the BASE global batch), rebuilds the step and restores the
   checkpoint; across processes (``remesh="relaunch"``) it hands the plan
   up for the launcher to relaunch the fleet into the new world;
4. training resumes from the same (seed, epoch, step): samplers are
   deterministic functions of (seed, epoch), and the global step counter
   stays monotonic across re-meshes.

A dropped worker that heartbeats again from outside the world is planned
back in (GROW), the same machinery in reverse.  The JAX package's engine
does the same over a device mesh; this one has no mesh, so a world is the
logical world of feed ranks in one process or the process group's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.index_dataset import IndexDataset
from repro_torch.core.windows import WindowSpec
from repro_torch.distributed import (Checkpointer, HeartbeatMonitor,
                                     LeaderCheckpointer, LeaderHistorySink,
                                     checkpoint_meta, latest_step, plan_remesh,
                                     restore, scale_batch_or_steps)
from repro_torch.pipeline.dataplane import DataPlane, PipelineConfig, build_dataplane
from repro_torch.pipeline.gathers import (EXCHANGE_IMPL, exchange_windows,
                                          resolve_gather, split_windows)
from repro_torch.pipeline.prefetch import FeedPrefetcher, PrefetchPlan
from repro_torch.train.loop import (RestartSignal, combine_weighted,
                                    init_train_state, make_train_step,
                                    run_training)
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Fault-tolerance policy for :meth:`Engine.fit`.

    Heartbeat workers are indexed by DATA-PARALLEL rank (0..world−1); with
    the defaults ``model_parallel == chips_per_host`` each worker is its own
    TP group, so losing one drops exactly one data rank.  Set them per the
    fleet's layout when a TP group spans hosts — ``plan_remesh`` then drops
    whole groups and the engine shrinks the world by the dropped-rank count.

    ``step_feed(global_step, world) -> {rank: (step, step_time | None)}`` is
    the heartbeat transport: which workers reported in since the last step.
    None (the default) simulates an all-healthy fleet — every rank beats
    every step — which is correct for one-process runs and lets tests
    inject faults by omitting ranks (and driving ``clock``) instead.  Real
    transports live in :mod:`repro_torch.distributed.transport`.  A beat
    from a rank OUTSIDE the current world is a dropped worker announcing its
    return: the engine plans the inverse GROW re-mesh (up to
    ``target_world``, defaulting to the world the engine was built with) and
    the per-worker batch scales back down against the BASE global batch —
    shrink and grow round-trip to the original topology.

    ``emitter(global_step)`` is the worker-side half of a real transport:
    called once per step so THIS process's ranks heartbeat out (wire it to
    ``transport.emit``); None for one-process fakes.

    ``remesh`` selects who executes a plan: ``"inprocess"`` (default) has
    the engine shrink/grow the world and resume inside this process — valid
    in one process, where the whole series is resident; ``"relaunch"``
    makes :meth:`Engine.fit` re-raise the checkpoint-annotated
    :class:`~repro_torch.train.loop.RestartSignal` so an external launcher
    can tear the group down and relaunch into the planned world (the only
    sound option under a ``torch.distributed`` group, where a dead peer's
    rows are gone and the next collective fails).

    On shrink with ``keep_global_batch=True`` the per-worker batch is
    ``ceil(global/new_dp)``, so the global batch can GROW by up to
    ``new_dp − 1`` windows (no ragged trim exists — uniform per-rank
    batches); ``False`` keeps the per-worker batch and shrinks the global
    batch.  Both directions always re-scale from the engine's BASE global
    batch, so repeated re-meshes never compound the ceil rounding.
    """

    check_every: int = 1           # poll the monitor every N steps
    heartbeat_timeout: float = 60.0
    straggler_factor: float = 3.0
    model_parallel: int = 1        # TP group size, kept whole by plan_remesh
    chips_per_host: int = 1
    keep_global_batch: bool = True  # scale_batch_or_steps policy on re-mesh
    max_restarts: int = 8
    clock: Callable[[], float] = time.monotonic
    step_feed: Callable[[int, int], dict] | None = None
    emitter: Callable[[int], None] | None = None
    target_world: int | None = None  # grow ceiling; None = the build world
    remesh: str = "inprocess"      # or "relaunch" (external launcher re-meshes)
    # A returned worker must announce on this many polls (and still be
    # fresh) before a grow is planned — one stray beat from a crash-looping
    # host must not trigger a grow that immediately shrinks back.  The
    # launcher owns any stronger quarantine policy; this is the in-process
    # debounce.
    readmit_after_beats: int = 3
    # Leader succession (repro_torch.distributed.leader.LeaderTracker): when
    # set, every single-writer duty — checkpoint writes, plan decisions,
    # plan/history emission — follows `leader.is_leader()` instead of the
    # fixed process 0, so the death of process 0 hands the decider role to
    # the lowest surviving rank (whose transport state is already primed:
    # the file transport is symmetric, the TCP collectors peer-mirror).
    # None keeps the process-0 gate.
    leader: Any | None = None


@dataclasses.dataclass
class Engine:
    """Train step + checkpoints + evaluation + elastic restarts over a
    rebuildable DataPlane."""

    dataplane: DataPlane
    init_params: Any
    train_step: Callable
    _eval_loss: Callable  # (params, starts) -> (loss, metrics), gathered locally
    _exchange_loss: Callable  # (params, starts, keep) -> (loss, metrics)
    loss_fn: Callable  # (params, x, y) -> (loss, metrics); a re-mesh rebuilds the step from it
    elastic: ElasticConfig | None = None
    # One record per elastic restart: the plan plus the resume coordinates.
    restarts: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        # The BASE topology: re-mesh scaling is always computed against it
        # (never against the previous re-mesh's inflated output), so a
        # shrink→grow round trip restores the original (world, per-rank
        # batch) exactly.
        self._base_world = self.dataplane.world
        self._base_global_batch = self.dataplane.global_batch
        self._checkpointer: Any = None  # fit's writer, kept for succession
        self._hb_step = 0  # the last health-polled step (eval re-beats it)

    @property
    def config(self) -> PipelineConfig:
        return self.dataplane.config

    @property
    def dataset(self) -> IndexDataset:
        return self.dataplane.dataset

    @property
    def world(self) -> int:
        return self.dataplane.world

    @property
    def steps_per_epoch(self) -> int:
        return self.dataplane.steps_per_epoch

    @property
    def global_batch(self) -> int:
        return self.dataplane.global_batch

    def describe(self) -> dict:
        return self.dataplane.describe()

    def batch_of_starts(self, window_ids: np.ndarray) -> torch.Tensor:
        return self.dataplane.batch_of_starts(window_ids)

    # -------------------------------------------------------------- leadership
    def is_leader(self) -> bool:
        """Whether THIS process owns the single-writer duties (checkpoints,
        plan emission, durable history).  With an ``ElasticConfig.leader``
        tracker the verdict follows the succession rule (lowest live rank
        wins); without one it is the fixed gate, process 0."""
        el = self.elastic
        if el is not None and el.leader is not None:
            return el.leader.is_leader()
        return self.dataplane.process == 0

    def leader_rank(self) -> int:
        el = self.elastic
        if el is not None and el.leader is not None:
            return el.leader.leader()
        return 0

    # --------------------------------------------------------------- training
    def fit(
        self,
        *,
        epochs: int | None = None,
        eval_fn: Callable[[Any], dict] | None | str = "auto",
        resume: bool = True,
        history_sink: list | None = None,
    ) -> tuple[Any, list[dict]]:
        """Train from ``init_params`` (copied; the caller's tensors are left
        as they were), or resume from ``loop.ckpt_dir``'s latest checkpoint
        when ``resume`` and one exists.  Returns ``(state, history)`` like
        ``run_training``.  ``eval_fn="auto"`` evaluates val-split MAE at
        every epoch end.  ``history_sink`` mirrors every logged row into a
        caller-owned list or :class:`~repro_torch.train.loop.JsonlHistorySink`
        on the leader only; a
        :class:`~repro_torch.distributed.LeaderHistorySink` is handed every
        row on every process (it decides who writes).  Every process returns
        the rows.

        With an :class:`ElasticConfig` attached (``loop.ckpt_dir`` required),
        worker loss mid-run re-meshes and resumes instead of ending the run
        (see the module docstring).  Every process that could become the
        leader then drives a
        :class:`~repro_torch.distributed.LeaderCheckpointer`: the leader's
        saves land on disk, standbys hold host snapshots for succession, and
        no save is a collective.
        """
        loop = self.config.loop
        if epochs is not None:
            loop = dataclasses.replace(loop, epochs=epochs)
        el = self.elastic
        if el is not None and not loop.ckpt_dir:
            raise ValueError("elastic fit needs loop.ckpt_dir: the re-mesh "
                             "path restores from the latest checkpoint")
        if el is not None and el.remesh == "inprocess" and self.dataplane.processes > 1:
            raise ValueError(
                "elastic remesh='inprocess' cannot run under a process group "
                f"of {self.dataplane.processes}: a dead peer's rows are gone and "
                "its collectives fail; use ElasticConfig(remesh='relaunch') so "
                "the launcher relaunches the fleet into the planned world")
        state = init_train_state(tree_map(lambda p: p.detach().clone(), self.init_params),
                                 self.config.adam)
        if el is None:
            checkpointer = Checkpointer(loop.ckpt_dir) if loop.ckpt_dir else None
        elif el.leader is not None or self.dataplane.process == 0:
            # Every process that could ever lead drives a leader-gated
            # checkpointer; without a tracker only process 0 can lead.
            checkpointer = LeaderCheckpointer(Checkpointer(loop.ckpt_dir),
                                              self.is_leader)
        else:
            checkpointer = None
        self._checkpointer = checkpointer
        start_step, start_epoch, start_done = 0, 0, None
        if resume and loop.ckpt_dir and latest_step(loop.ckpt_dir) is not None:
            state, start_step = restore(loop.ckpt_dir, state)
            # Prefer the checkpoint's own (epoch, done_in_epoch) coordinates
            # (after a re-mesh changed steps_per_epoch, deriving them from
            # the step would land elsewhere); start_step stays the raw,
            # monotonic step counter.
            meta = checkpoint_meta(loop.ckpt_dir)
            if "epoch" in meta:
                start_epoch = int(meta["epoch"])
                start_done = max(int(meta.get("done_in_epoch", 0)), 0)
            else:
                start_epoch = start_step // self.steps_per_epoch
        if eval_fn == "auto":
            eval_fn = (lambda st: {"val_mae": self.evaluate(st["params"])}) \
                if len(self.dataset.val_windows) > 0 else None
        if eval_fn is not None and el is not None and el.emitter is not None:
            # Epoch-end eval is a coordinated pause: nobody steps, so nobody
            # heartbeats, and an eval longer than heartbeat_timeout would
            # make the next poll read the healthy fleet as stale.  Every
            # process runs eval_fn, so every rank re-beats when it returns.
            inner_eval = eval_fn

            def eval_fn(st):
                out = inner_eval(st)
                self._beat(self._hb_step)
                return out
        if not isinstance(history_sink, LeaderHistorySink) and not self.is_leader():
            history_sink = None
        history: list[dict] = []
        self._hb_step = start_step
        monitor = self._make_monitor()
        restarts_this_fit = 0
        batch_stream = None
        if loop.prefetch_depth >= 1:
            plan = PrefetchPlan(depth=loop.prefetch_depth, staleness=loop.staleness,
                                chunk=loop.prefetch_chunk)

            def batch_stream(epoch: int, done: int) -> FeedPrefetcher:
                # reads self.dataplane at call time: after a re-mesh the next
                # stream is built over the new plane (run_training's finally
                # drained the old one when the RestartSignal unwound)
                dp = self.dataplane
                return FeedPrefetcher(
                    dp.grid_stream(epoch, start=done, chunk=plan.chunk),
                    dp.prefetch_transfer(plan.staleness), plan, device=dp.device)
        while True:
            # Hand the state over: run_training's reference is then the only
            # one, so each step's predecessor (parameters and moments) is
            # freed as the next one lands, not kept for the whole run.
            box, state = [state], None
            try:
                state, hist = run_training(
                    state=box.pop(), train_step=self.train_step, sampler=self.dataplane,
                    batch_of_starts=self.dataplane.batch_of_starts, loop=loop,
                    eval_fn=eval_fn, checkpointer=checkpointer,
                    start_epoch=start_epoch, start_step=start_step,
                    start_done_in_epoch=start_done,
                    health_cb=self._health_cb(monitor), history_sink=history_sink,
                    batch_stream=batch_stream)
                history.extend(hist)
                return state, history
            except RestartSignal as sig:
                if el is None:
                    raise
                history.extend(sig.history)
                sig.leader = self.is_leader()
                if el.remesh == "relaunch":
                    # The launcher relaunches the fleet: run_training already
                    # checkpointed the in-flight state with its coordinates.
                    raise
                if restarts_this_fit >= el.max_restarts:
                    raise RuntimeError(f"elastic restart budget exhausted "
                                       f"({el.max_restarts})") from sig
                restarts_this_fit += 1
                # Drop what pins the old plane's device series — the failed
                # run's frames (the old step closes over the series) and its
                # state — so the re-mesh below can free it first.
                sig.__traceback__ = None
                sig.state = state = None
                pending = sig
            except BaseException:
                # A failure that is not a plan (e.g. a collective erroring
                # out when a peer died) must not strand the in-flight async
                # checkpoint write: join it, with no collective, so a
                # relaunch resumes from the newest durable step.
                if checkpointer is not None:
                    try:
                        checkpointer.flush()
                    except Exception:
                        pass
                raise
            state, start_epoch, start_step, start_done = self._apply_plan(pending, loop)
            del pending
            monitor = self._make_monitor()
            # The re-mesh is a coordinated pause like eval: re-announce
            # liveness before resuming.
            self._beat(self._hb_step)

    def _beat(self, step: int) -> None:
        """This process's ranks heartbeat out, fire-and-forget."""
        el = self.elastic
        if el is not None and el.emitter is not None:
            try:
                el.emitter(step)
            except OSError:
                pass

    # ------------------------------------------------------------- evaluation
    @torch.no_grad()
    def evaluate(self, params, *, split: str = "val", max_batches: int = 4) -> float:
        """Window-weighted mean loss over up to ``max_batches`` eval chunks.

        Full chunks are the pool's global batches in pool order; the ragged
        tail is scored once as a small batch when the budget was not already
        spent on full chunks, so small splits are never silently truncated.
        Under several processes each scores its own rank-block of every chunk
        (gathered from its rows, or its block of what the exchange assembles)
        and the per-process losses are shared (:func:`_share`), so the
        ``(loss, windows)`` pairs — chunk by chunk, processes in rank order,
        then the tail — are the same on every rank.  They combine through
        :func:`repro_torch.train.loop.combine_weighted`.
        """
        dp = self.dataplane
        if len(dp.eval_pool(split)) == 0:
            return float("nan")
        rows, tail = dp.eval_grid(split)
        exchange = dp.eval_exchange
        losses = []
        for i in range(min(rows.shape[0], max_batches)):
            starts = dp.batch_of_starts(rows[i], exchange=exchange)
            loss, _ = (self._exchange_loss(params, starts, dp.block) if exchange
                       else self._eval_loss(params, starts))
            losses.append(float(loss))
        per_process = _share(losses, dp)
        pairs = [(value, dp.local_width) for chunk in zip(*per_process)
                 for value in chunk]
        if len(tail) and rows.shape[0] < max_batches:
            tail_len, tail_batch = dp.eval_tail_batch(split)
            loss, _ = (self._exchange_loss(params, tail_batch, slice(None))
                       if exchange else self._eval_loss(params, tail_batch))
            pairs.append((float(loss), tail_len))
        return combine_weighted(pairs)


    # ---------------------------------------------------------------- elastic
    def succeed_as_leader(self, dead_ranks) -> dict | None:
        """Leader succession after a failed collective.

        A peer's death surfaces to the survivors as a failed collective — a
        plain exception out of :meth:`fit` — and the launcher attributes WHO
        died through the transport's ``snapshot()`` (whose beats went
        silent).  It then hands the verdict here: the tracker marks the dead
        ranks (at once — the survivor must not wait out a heartbeat timeout
        to start writing), and if the lowest live rank is now ours, this
        process takes over every single-writer duty the dead leader held:

        - the warm-standby checkpoint (the exact failure-step state, copied
          to host while the device state was valid) is durably written —
          ``ckpt_step``;
        - the SHRINK plan is decided by the successor and returned for the
          launcher to relaunch against.

        Returns ``{"leader", "plan", "ckpt_step"}`` when this process is now
        the leader, else None.  (History succession is the sink's job: call
        ``LeaderHistorySink.flush_as_leader()`` alongside this.)
        """
        el = self.elastic
        dead = sorted({int(r) for r in dead_ranks})
        if el is not None and el.leader is not None:
            el.leader.note_dead(dead)
        if not self.is_leader():
            return None
        ckpt_step = None
        if isinstance(self._checkpointer, LeaderCheckpointer):
            try:
                self._checkpointer.wait()
            except Exception:
                pass  # an earlier async write failing must not block takeover
            ckpt_step = self._checkpointer.takeover()
        plan = None
        if el is not None and dead:
            try:
                plan = plan_remesh(self.world, dead,
                                   model_parallel=el.model_parallel,
                                   chips_per_host=el.chips_per_host,
                                   decided_by=self.leader_rank())
            except RuntimeError:
                plan = None  # no healthy TP group left: nothing to relaunch
        return {"leader": self.leader_rank(), "plan": plan, "ckpt_step": ckpt_step}

    def _make_monitor(self) -> HeartbeatMonitor | None:
        if self.elastic is None:
            return None
        el = self.elastic
        return HeartbeatMonitor(self.world, timeout=el.heartbeat_timeout,
                                straggler_factor=el.straggler_factor, clock=el.clock)

    def _health_cb(self, monitor: HeartbeatMonitor | None):
        if monitor is None:
            return None
        el = self.elastic
        world = self.world
        target = el.target_world or self._base_world
        returned: dict[int, list] = {}  # rank -> [poll count, last clock]
        announced: set[int] = set()     # out-of-world beats since last poll

        def cb(global_step: int) -> None:
            self._hb_step = global_step
            # Fire-and-forget, like the transports: a transient emit failure
            # makes this worker look late to the monitor; it must not crash
            # a healthy training process.
            self._beat(global_step)
            beats = (el.step_feed(global_step, world)
                     if el.step_feed is not None
                     else {r: (global_step, None) for r in range(world)})
            if el.leader is not None:
                # Leadership derives from the SAME seq-gated beat stream the
                # monitor consumes — every survivor reaches the same verdict.
                el.leader.observe(beats)
            for rank, (step, step_time) in beats.items():
                if rank in monitor.workers:
                    monitor.beat(rank, step, step_time)
                else:
                    # A beat from outside the current world: a dropped worker
                    # announcing its return.  It must use the TARGET fleet's
                    # numbering (an id >= world): a rebooted host re-using an
                    # id below the world is indistinguishable from the live
                    # rank that now owns it.
                    announced.add(rank)
            if el.check_every > 1 and global_step % el.check_every:
                return
            # A returned worker is re-admitted only once it has announced on
            # ``readmit_after_beats`` DISTINCT decision polls AND is still
            # fresh: a flapping worker would just shrink the world back.
            now = el.clock()
            for rank in announced:
                seen = returned.setdefault(rank, [0, 0.0])
                seen[0] += 1
                seen[1] = now
            announced.clear()
            unhealthy = monitor.unhealthy()
            fresh = sorted(r for r, (n, t) in returned.items()
                           if n >= el.readmit_after_beats
                           and now - t <= el.heartbeat_timeout)
            recovered = (fresh[: target - world]
                         if not unhealthy and world < target else [])
            if not unhealthy and not recovered:
                return
            # Only the CURRENT leader turns a verdict into a plan; every
            # survivor keeps polling (that is what keeps a successor primed).
            # When the leader itself died, the tracker times it out here and
            # the successor's next poll passes this gate.
            if not self.is_leader():
                return
            plan = plan_remesh(world, unhealthy, recovered=recovered,
                               model_parallel=el.model_parallel,
                               chips_per_host=el.chips_per_host,
                               decided_by=self.leader_rank())
            if plan is not None:
                raise RestartSignal(plan)

        return cb

    def _apply_plan(self, sig: RestartSignal, loop) -> tuple[Any, int, int, int]:
        """Re-mesh to the plan's world and restore the latest checkpoint.

        Shrink plans drop the plan's dead workers; grow plans re-admit the
        plan's returned workers (capped at ``target_world``).  Both re-scale
        the per-rank batch against the BASE global batch, so shrink→grow
        restores the original world and batch exactly.  The old step and
        plane give up the device series before the new plane places it.

        Returns ``(state, start_epoch, start_step, start_done_in_epoch)``:
        the same (seed, epoch) and completed-step count within the
        interrupted epoch, with ``start_step`` continuing the MONOTONIC
        global counter from the failure checkpoint.
        """
        el = self.elastic
        plan = sig.plan
        old_spe = self.steps_per_epoch
        if plan.kind == "grow":
            target = el.target_world or self._base_world
            new_world = min(self.world + len(set(plan.readmitted_workers)), target)
        else:
            new_world = self.world - len(set(plan.dropped_workers))
        per_new, _ = scale_batch_or_steps(
            self._base_global_batch, old_dp=self._base_world, new_dp=new_world,
            keep_global_batch=el.keep_global_batch)
        # the compiled step and losses close over the old device series
        self.train_step = self._eval_loss = self._exchange_loss = None
        self.dataplane = self.dataplane.remesh(world=new_world, batch_per_rank=per_new)
        if el.leader is not None:
            # Ranks renumber with the world; an in-process re-mesh is one
            # process (fit enforces it), which owns every rank and leads.
            el.leader.reset(new_world)
        self.train_step, self._eval_loss, self._exchange_loss = _compile(
            self.dataplane, self.loss_fn, self.config)
        template = init_train_state(
            tree_map(lambda p: p.detach().clone(), self.init_params), self.config.adam)
        state, ckpt_step = restore(loop.ckpt_dir, template)
        meta = checkpoint_meta(loop.ckpt_dir)
        epoch = int(meta.get("epoch", sig.epoch))
        done = max(int(meta.get("done_in_epoch", ckpt_step - epoch * old_spe)), 0)
        self.restarts.append({
            "plan": plan, "kind": plan.kind, "epoch": epoch,
            "step": ckpt_step, "world": new_world, "batch_per_rank": per_new,
            "global_batch": self.global_batch,
        })
        return state, epoch, ckpt_step, done


def _share(values: list[float], dp: DataPlane) -> list[list[float]]:
    """Every process's ``values`` (equal lengths), in rank order, on every
    process: one sum all-reduce of a zeroed float64 ``[processes, n]``
    matrix in which each process wrote its own row, so each entry is one
    process's value plus zeros — exact.  One process: ``[values]``."""
    if dp.processes == 1 or not values:
        return [values] * dp.processes
    table = torch.zeros((dp.processes, len(values)), dtype=torch.float64,
                        device=dp.device)
    table[dp.process] = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(table)
    return table.cpu().tolist()


def _compile(dataplane: DataPlane, loss_fn: Callable, config: PipelineConfig):
    """``(train_step, batch_loss, exchange_loss)`` with the window gather
    fused over THIS data plane's resident rows.

    ``batch_loss(params, starts)`` gathers the windows at the rebased
    ``starts`` from the resident rows.  ``exchange_loss(params, starts,
    keep)`` assembles a global batch with the exchange and scores its
    ``keep`` slice.  The train step takes the first, or, under
    ``ONDEMAND`` over several processes, assembles the global batch first
    and keeps this process's block (so microbatches slice what it trains
    on); over several processes it all-reduces its gradients."""
    gather = resolve_gather(config.gather)
    spec = dataplane.spec
    series = dataplane.dataset.series
    origin = dataplane.dataset.origin
    owned = tuple(r - origin for r in dataplane.owned)
    impl = EXCHANGE_IMPL.get(config.gather, "ref")

    def batch_loss(params, starts):
        x, y = gather(series, starts, input_len=spec.in_len, horizon=spec.horizon)
        return loss_fn(params, x, y)

    def exchanged(starts, keep):
        return exchange_windows(series, starts, span=spec.span, owned=owned,
                                impl=impl)[keep]

    def window_loss(params, windows):
        return loss_fn(params, *split_windows(config.gather, windows, spec.in_len))

    def exchange_loss(params, starts, keep):
        return window_loss(params, exchanged(starts, keep))

    schedule = config.schedule or (lambda s: config.adam.lr)
    loop = config.loop
    group = dist.group.WORLD if dataplane.processes > 1 else None
    step_kw = dict(microbatches=loop.microbatches, grad_dtype=loop.grad_dtype,
                   group=group)
    if dataplane.train_exchange:
        inner = make_train_step(window_loss, config.adam, schedule, **step_kw)
        block = dataplane.block

        def train_step(state, starts):
            return inner(state, exchanged(starts, block))
    else:
        train_step = make_train_step(batch_loss, config.adam, schedule, **step_kw)
    return train_step, batch_loss, exchange_loss


def build_engine(
    raw: np.ndarray | None,
    spec: WindowSpec,
    loss_fn: Callable[[Any, torch.Tensor, torch.Tensor], tuple[torch.Tensor, dict]],
    init_params: Any,
    config: PipelineConfig = PipelineConfig(),
    *,
    dataset: IndexDataset | None = None,
    elastic: ElasticConfig | None = None,
) -> Engine:
    """Assemble the placement-aware trainer (DataPlane + Engine) for this
    process: one device, or one rank of the ``torch.distributed`` group.

    ``loss_fn(params, x, y) -> (loss, metrics)`` is the only model-specific
    piece; the engine supplies (x, y) by fusing the selected window gather
    (and, where rows lie on other ranks, the exchange) into the step.  Pass
    ``dataset=`` to reuse a host ``IndexDataset``; pass ``elastic=`` to
    survive worker loss mid-fit.
    """
    dataplane = build_dataplane(raw, spec, config, dataset=dataset)
    train_step, eval_loss, exchange_loss = _compile(dataplane, loss_fn, config)
    return Engine(dataplane=dataplane, init_params=init_params,
                  train_step=train_step, _eval_loss=eval_loss,
                  _exchange_loss=exchange_loss, loss_fn=loss_fn, elastic=elastic)
