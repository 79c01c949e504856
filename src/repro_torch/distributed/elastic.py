"""Elastic runtime policy: heartbeats, straggler detection, re-mesh planning.

A data-parallel program steps in lock step, so it cannot steal work from a
slow or dead worker the way the paper's Dask scheduler does.  The policy is:

1. every worker heartbeats (step counter + wall time) to the monitor;
2. the monitor flags DEAD workers (no heartbeat past ``timeout``) and
   STRAGGLERS (per-step time > ``straggler_factor`` × fleet median, which in
   a lock-step program delays *everyone*);
3. on any flag, the planner computes the largest healthy fleet that keeps
   each model-parallel group whole (losing one member of a TP group kills
   the whole group), shrinking only the data-parallel world;
4. the run restores the latest checkpoint into the new world and resumes
   from the same (seed, epoch, step): samplers are deterministic, so no data
   is lost or repeated;
5. when a dropped worker heartbeats again (it rebooted, or its link
   healed), the planner emits the inverse GROW plan: the world re-expands
   by whole TP groups, the per-worker batch scales back down
   (``scale_batch_or_steps`` against the BASE global batch), and the latest
   checkpoint restores into the larger world — the same machinery as a
   shrink, run in reverse.

The module is pure policy (the standard library only, no collective), so it
is testable in one process; the launcher wires it to real transports
(:mod:`repro_torch.distributed.transport`: files for processes of one host,
TCP for a fleet — both emit the events :class:`HeartbeatMonitor` consumes).
It follows the JAX package's ``repro.distributed.elastic`` call for call.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class WorkerView:
    last_seen: float
    last_step: int
    step_time_ema: float | None = None
    seen_beat: bool = False


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    dropped_workers: tuple[int, ...]
    reason: str
    # Workers re-admitted by a GROW plan (empty on shrink).  A plan is one or
    # the other, never both: recovery is only planned from a healthy fleet.
    readmitted_workers: tuple[int, ...] = ()
    # The rank that decided this plan — rank 0 in the classic single-decider
    # setup, the leader-succession winner (lowest live rank, see
    # repro_torch.distributed.leader) after the original decider died.  None when
    # the caller did not thread leadership through.
    decided_by: int | None = None

    @property
    def kind(self) -> str:
        return "grow" if self.readmitted_workers else "shrink"


class HeartbeatMonitor:
    """Tracks per-worker liveness and step latency."""

    def __init__(self, n_workers: int, *, timeout: float = 60.0,
                 straggler_factor: float = 3.0, clock=time.monotonic):
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self._clock = clock
        now = clock()
        self.workers = {i: WorkerView(last_seen=now, last_step=0)
                        for i in range(n_workers)}
        # Set at the first liveness poll: a worker that has not beaten YET is
        # timed from here, not from construction — everything between
        # building the monitor and the first post-step poll (gloo init, the
        # first jit compile) would otherwise count against its first
        # heartbeat and a slow compile could flag live workers on poll one.
        self._first_poll: float | None = None

    def beat(self, worker: int, step: int, step_time: float | None = None) -> None:
        """``step_time``: the worker's self-measured COMPUTE time for the step.
        On a synchronous SPMD program wall time between beats is identical on
        every worker (all wait for the slowest), so straggler attribution
        requires self-reported compute durations; wall time is the fallback.
        """
        now = self._clock()
        w = self.workers[worker]
        if step > w.last_step:
            dt = (step_time if step_time is not None
                  else (now - w.last_seen) / max(step - w.last_step, 1))
            w.step_time_ema = dt if w.step_time_ema is None else 0.8 * w.step_time_ema + 0.2 * dt
        w.last_seen = now
        w.seen_beat = True
        # Monotonic: a beat reporting an OLDER step (a restarted process
        # re-announcing from 0, or reordered transport delivery) still
        # refreshes liveness but must not regress the step counter — the
        # next genuine advance would otherwise divide its wall time by an
        # inflated step delta and skew the straggler EMA.
        w.last_step = max(w.last_step, step)

    def dead(self) -> list[int]:
        now = self._clock()
        if self._first_poll is None:
            self._first_poll = now
        return [i for i, w in self.workers.items()
                if now - (w.last_seen if w.seen_beat
                          else max(w.last_seen, self._first_poll))
                > self.timeout]

    def stragglers(self) -> list[int]:
        times = sorted(w.step_time_ema for w in self.workers.values()
                       if w.step_time_ema is not None)
        if len(times) < max(3, len(self.workers) // 2):
            return []  # not enough signal yet
        median = times[len(times) // 2]
        return [i for i, w in self.workers.items()
                if w.step_time_ema is not None
                and w.step_time_ema > self.straggler_factor * median]

    def unhealthy(self) -> list[int]:
        return sorted(set(self.dead()) | set(self.stragglers()))


def plan_remesh(
    n_total: int,
    unhealthy: list[int],
    *,
    recovered: list[int] | tuple[int, ...] = (),
    model_parallel: int,
    chips_per_host: int = 4,
    axis_names: tuple[str, str] = ("data", "model"),
    decided_by: int | None = None,
) -> ElasticPlan | None:
    """Largest healthy mesh keeping TP groups whole.

    The planner is pure and rank-agnostic — ``unhealthy`` may include rank
    0 (the classic decider) like any other worker; WHO runs the planner is
    the leader-succession layer's problem (``repro_torch.distributed.leader``:
    lowest live rank), and ``decided_by`` merely records that rank on the
    emitted plan for attribution.

    Workers are hosts of ``chips_per_host`` chips; a TP group spans
    ``model_parallel`` chips, so losing a host removes
    ceil(model_parallel / chips_per_host)⁻¹… in practice we drop whole TP
    groups containing an unhealthy host and shrink the data axis.

    ``recovered`` lists workers heartbeating from OUTSIDE the current fleet
    (previously-dropped hosts asking to rejoin).  When the current fleet is
    healthy, the planner re-admits them in whole TP groups and GROWS the data
    axis — the inverse of a shrink.  An unhealthy fleet is shrunk first;
    recovery is re-planned on a later poll once the fleet is stable.
    Returns None when the fleet is unchanged.
    """
    hosts_per_group = max(model_parallel // chips_per_host, 1)
    if not unhealthy:
        if not recovered:
            return None
        # Grow: re-admit whole TP groups' worth of recovered workers only —
        # a partial group can't host a TP shard any more than it could on
        # the way down.
        n_groups = n_total // hosts_per_group
        back_groups = len(set(recovered)) // hosts_per_group
        if back_groups < 1:
            return None
        readmitted = tuple(sorted(set(recovered)))[: back_groups * hosts_per_group]
        return ElasticPlan(
            mesh_shape=(n_groups + back_groups, model_parallel),
            axis_names=axis_names,
            dropped_workers=(),
            readmitted_workers=readmitted,
            reason=f"re-admitted {back_groups} TP group(s) of recovered "
                   f"workers {sorted(set(recovered))}",
            decided_by=decided_by,
        )
    n_groups = n_total // hosts_per_group
    bad_groups = {w // hosts_per_group for w in unhealthy}
    healthy_groups = n_groups - len(bad_groups)
    if healthy_groups < 1:
        raise RuntimeError("no healthy TP group left — cannot re-mesh")
    dropped = tuple(w for g in sorted(bad_groups)
                    for w in range(g * hosts_per_group, (g + 1) * hosts_per_group))
    return ElasticPlan(
        mesh_shape=(healthy_groups, model_parallel),
        axis_names=axis_names,
        dropped_workers=dropped,
        reason=f"dropped {len(bad_groups)} TP group(s) containing unhealthy hosts "
               f"{sorted(unhealthy)}",
        decided_by=decided_by,
    )


def scale_batch_or_steps(global_batch: int, old_dp: int, new_dp: int,
                         *, keep_global_batch: bool = True) -> tuple[int, int]:
    """After re-meshing DP from old_dp to new_dp (either direction), either
    keep the global batch (per-worker batch scales inversely with the world —
    preserves convergence, costs memory on shrink) or keep the per-worker
    batch (global batch scales with the world — re-scale LR by the linear
    rule).  Returns (per_worker_batch, new_global_batch).

    Callers re-meshing more than once must always pass the ORIGINAL (base)
    ``global_batch``, not the previous re-mesh's output: the ceil rounding
    below is not idempotent, so feeding an inflated global batch back in
    compounds the inflation and a shrink→grow round trip would no longer
    restore the original per-worker batch (the engine's inverse-scaling
    contract)."""
    per = global_batch // old_dp
    if keep_global_batch:
        # Distribute the remainder by rounding up: SPMD batches are uniform
        # per rank, so the new global batch is per_new * new_dp — up to
        # new_dp − 1 windows LARGER than the old one (no ragged trim).
        per_new = -(-global_batch // new_dp)
        return per_new, per_new * new_dp
    return per, per * new_dp
