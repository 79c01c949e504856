"""Training loop: index-batched steps, microbatch accumulation, checkpointing.

The step is the paper's workflow on each rank:

    starts --(window gather from the RESIDENT series)--> (x, y) --> loss
           --> grads --(all-reduce over the process group)--> AdamW

The host only ever ships int32 window starts to the device; the series was
placed once (GPU-index-batching) and every step gathers its own batch there.
Microbatch gradient accumulation (``microbatches > 1``) sums gradients over
slices of the step's starts; ``grad_dtype="bfloat16"`` casts each gradient
tree before the sum.  With a process ``group`` (data parallel over
``torch.distributed``), the step all-reduces its gradients and its loss as
one flattened buffer and divides by the group's size — the collective the
JAX package's partitioner inserts — so every rank applies the same update
and logs the global mean loss.

Deterministic ``(seed, epoch)`` feeds and step-granular checkpoints
(:class:`repro_torch.distributed.Checkpointer`) mean a restart resumes
bit-identically mid-epoch; a ``health_cb`` may raise :class:`RestartSignal`
to checkpoint and hand the run back to its caller; a
:class:`JsonlHistorySink` keeps every logged row crash-durable; and a
``batch_stream`` (:class:`repro_torch.pipeline.prefetch.FeedPrefetcher`)
feeds the steps ahead of time.  The JAX package's ``donate`` option has no
PyTorch counterpart (the step returns new tensors and the caller drops the
old ones), so :class:`TrainLoopConfig` leaves it out.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim import AdamConfig, apply_updates, init_opt_state
from repro_torch.optim.adam import torch_dtype
from repro_torch.tracing import span
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class RestartSignal(Exception):
    """Raised by a ``health_cb`` to request a restart.

    ``run_training`` checkpoints the in-flight state (so no step is lost),
    annotates the signal with what a caller needs to resume — ``state``,
    ``history``, ``epoch``, ``step`` — and re-raises.
    """

    def __init__(self, plan=None, reason: str = ""):
        super().__init__(reason or getattr(plan, "reason", "restart requested"))
        self.plan = plan
        self.state = None
        self.history: list[dict] = []
        self.epoch = 0
        self.step = 0


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    epochs: int = 1
    log_every: int = 50
    ckpt_every: int = 0  # steps; 0 = only at end
    ckpt_dir: str | None = None
    microbatches: int = 1
    grad_dtype: str | None = None  # "bfloat16" compresses the gradient tree
    # Epoch-end eval cadence: run eval_fn after every N-th epoch (1 = every
    # epoch; 0 = never, even with an eval_fn).  Epoch-indexed, so a resume
    # keeps the cadence.
    eval_every: int = 1
    # Async feed prefetch (repro_torch.pipeline.prefetch).  prefetch_depth 0
    # keeps the synchronous pull-per-step path; >= 1 streams batches through
    # a FeedPrefetcher that materializes feed rows `depth` chunks ahead on a
    # background thread.  staleness 0 transfers at consume on the caller
    # thread — bit-identical to the synchronous path; staleness s >= 1 lets
    # the host→device copy for step k+s overlap step k's computation.
    prefetch_depth: int = 0
    staleness: int = 0
    prefetch_chunk: int = 8


def combine_weighted(pairs) -> float:
    """Reduce ``(metric, weight)`` pairs to their weighted mean.

    Each full eval chunk contributes ``(chunk_loss, chunk_windows)`` and the
    ragged tail ``(tail_loss, tail_windows)``.  Accumulated in float64 in
    pair order, as the JAX package does.
    """
    weighted_sum = np.float64(0.0)
    weight = np.float64(0.0)
    for value, w in pairs:
        weighted_sum += np.float64(value) * np.float64(w)
        weight += np.float64(w)
    return float(weighted_sum / weight) if weight else float("nan")


class JsonlHistorySink:
    """Crash-durable, resume-idempotent history sink (one JSON row per line).

    Drop-in for the plain-list ``history_sink``: every logged row is
    appended to ``path`` and flushed and fsynced as it lands, so rows
    survive hard crashes.  On construction it reloads the rows already
    durable from a previous incarnation and silently drops re-logged
    duplicates: a resume from a mid-epoch checkpoint re-RUNS the tail of the
    epoch, and its step rows and epoch summary carry the same
    ``(epoch, step)`` coordinates, which must not appear twice.

    ``rows`` holds only the rows ACCEPTED this incarnation; ``load()``
    returns the full durable history across all incarnations.  Dedup is
    FIRST-WINS on coordinates, which leans on deterministic resume: a
    re-run ``(epoch, step)`` recomputes the identical row.
    """

    def __init__(self, path: str):
        self.path = path
        self.rows: list[dict] = []
        self._seen: set = set()
        rows, durable_end = self._scan(path)
        for row in rows:
            self._seen.add(self._key(row))
        if durable_end is not None:
            # Drop the torn tail a crash mid-write left behind: it was never
            # durable (the row is re-logged on resume), and appending after a
            # partial line would corrupt the NEXT row too.
            with open(path, "r+") as f:
                f.truncate(durable_end)
        self._f = open(path, "a")

    @staticmethod
    def _key(row: dict) -> tuple:
        kind = "summary" if "epoch_time_s" in row else "step"
        return (kind, row.get("epoch"), row.get("step"))

    @staticmethod
    def _scan(path: str) -> tuple[list[dict], int | None]:
        """(durable rows, truncation offset): a row is durable only when its
        line parses AND is newline-terminated; the offset points past the
        last such line when anything torn follows, else None."""
        if not os.path.exists(path):
            return [], None
        with open(path, "rb") as f:
            data = f.read()
        rows, offset, pos = [], 0, 0
        for line in data.splitlines(keepends=True):
            pos += len(line)
            if not line.endswith(b"\n"):
                break
            text = line.decode("utf-8", "replace").strip()
            if not text:
                offset = pos
                continue
            try:
                rows.append(json.loads(text))
            except ValueError:
                break
            offset = pos
        return rows, (offset if offset < len(data) else None)

    def append(self, row: dict) -> bool:
        key = self._key(row)
        if key in self._seen:
            return False
        self._seen.add(key)
        self.rows.append(row)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        return True

    def load(self) -> list[dict]:
        """All durable rows, across every incarnation, in logged order."""
        return self._scan(self.path)[0]

    def close(self) -> None:
        self._f.close()


def zero_grads_like(params, grad_dtype: str | None):
    """Zero tree for microbatch gradient accumulation, in the dtype the
    gradients will have (``grad_dtype`` when set, else each param's own)."""
    return tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch_dtype(grad_dtype) if grad_dtype else p.dtype,
        device=p.device), params)


def all_reduce_mean(loss: torch.Tensor, grads, group) -> tuple[torch.Tensor, Any]:
    """``(loss, grads)`` averaged over ``group``: one sum all-reduce of a
    flat float32 buffer holding the loss and every gradient leaf, then a
    division by the group's size; each leaf comes back in its own dtype."""
    leaves = tree_leaves(grads)
    flat = torch.cat([loss.detach().reshape(1).float()]
                     + [g.reshape(-1).float() for g in leaves])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, off = [], 1
    for g in leaves:
        out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
        off += g.numel()
    return flat[0], tree_unflatten(grads, out)


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
    adam: AdamConfig,
    schedule: Callable[[int], Any],
    *,
    microbatches: int = 1,
    grad_dtype: str | None = None,
    group=None,
):
    """Build the train step.

    loss_fn(params, batch) -> (loss, metrics).  ``batch`` is a tensor whose
    leading per-step batch dim is divisible by ``microbatches``.
    Returns step(state, batch) -> (state, metrics); metrics stay on the
    device (reading them synchronises).  The returned state holds new
    parameters and the given state's AdamW moments, updated in place
    (``apply_updates(in_place=True)``).  ``group``: a process group whose
    ranks train one model on their own batches; the step averages the
    gradients and the loss over it (:func:`all_reduce_mean`) before AdamW.
    None: one process, no collective.
    """
    gdt = torch_dtype(grad_dtype) if grad_dtype is not None else None

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            with span("forward"):
                loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
            # A leaf the loss never reads gets a zero gradient, as under
            # jax.value_and_grad (AdamW then leaves it as it was).
            with span("backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
        if gdt is not None:
            grads = [g.to(gdt) for g in grads]
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    def step(state, batch):
        params, opt_state = state["params"], state["opt"]
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            mb = batch.reshape((microbatches, -1) + batch.shape[1:])
            loss = torch.zeros((), device=batch.device)
            grads = zero_grads_like(params, grad_dtype)
            for i in range(microbatches):
                loss_i, _, grads_i = grads_of(params, mb[i])
                loss = loss + loss_i
                grads = tree_map(torch.add, grads, grads_i)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {}
        if group is not None:
            loss, grads = all_reduce_mean(loss, grads, group)
        lr = schedule(opt_state["step"])
        with span("optimizer"):
            new_params, new_opt, gnorm = apply_updates(params, grads, opt_state, adam, lr,
                                                       in_place=True)
        out_metrics = {"loss": loss, "lr": lr, **metrics}
        if gnorm is not None:
            out_metrics["grad_norm"] = gnorm
        return {"params": new_params, "opt": new_opt}, out_metrics

    return step


def init_train_state(params, adam: AdamConfig):
    return {"params": params, "opt": init_opt_state(params, adam)}


def run_training(
    *,
    state,
    train_step,
    sampler,
    batch_of_starts: Callable[[np.ndarray], Any],
    loop: TrainLoopConfig,
    eval_fn: Callable[[Any], dict] | None = None,
    checkpointer=None,
    start_epoch: int = 0,
    start_step: int = 0,
    start_done_in_epoch: int | None = None,
    health_cb: Callable[[int], None] | None = None,
    history_sink: list | None = None,
    batch_stream: Callable[[int, int], Any] | None = None,
) -> tuple[Any, list[dict]]:
    """Generic epoch loop.

    ``sampler.epoch_grid(e)`` (or ``epoch_global(e)``) yields
    [steps, global_batch] window ids; ``batch_of_starts`` maps one row to
    the step's batch (the device tensor of window starts — the gather itself
    happens inside the step, from the resident series).  Every ``log_every``
    steps a row of float metrics is logged; each epoch ends with a summary
    row, carrying ``eval_fn``'s metrics on the ``eval_every`` cadence.

    Resume: ``start_epoch`` and ``start_step`` (the monotonic step counter)
    place the run; ``start_done_in_epoch``, when given, is the number of
    steps of ``start_epoch`` already done (later epochs start at 0), else
    the position is derived from ``start_step``.

    ``checkpointer`` saves every ``ckpt_every`` steps with the run's
    ``(epoch, done_in_epoch)`` coordinates as manifest meta, normalised so a
    complete epoch reads as the start of the next one, and once more at the
    end.  ``health_cb(global_step)`` runs after every step; it may raise
    :class:`RestartSignal`, and the loop then checkpoints the current state
    with its coordinates, annotates the signal and re-raises.

    ``history_sink``: a caller-owned list (or :class:`JsonlHistorySink`)
    mirroring every row as it is logged, so the rows survive a crash.

    ``batch_stream(epoch, done) -> iterator`` yields the epoch's remaining
    ``steps_per_epoch - done`` device-ready batches (the same values the
    synchronous path builds) in place of ``batch_of_starts(grid[i])``.  Its
    ``close()``, when it has one, runs on every exit from the epoch.
    """
    history: list[dict] = []
    global_step = start_step
    grid_of_epoch = getattr(sampler, "epoch_grid", sampler.epoch_global)

    def log_row(row: dict) -> None:
        history.append(row)
        if history_sink is not None:
            history_sink.append(row)

    def epoch_meta(epoch: int, done: int, steps: int) -> dict:
        if done >= steps:
            return {"epoch": epoch + 1, "done_in_epoch": 0}
        return {"epoch": epoch, "done_in_epoch": done}

    def check_health(done_now: int, steps: int) -> None:
        """Poll health_cb; on RestartSignal checkpoint-and-annotate."""
        if health_cb is None:
            return
        try:
            health_cb(global_step)
        except RestartSignal as sig:
            if checkpointer is not None:
                checkpointer.save(state, step=global_step,
                                  meta=epoch_meta(epoch, done_now, steps))
                checkpointer.wait()
            sig.state, sig.history = state, history
            sig.epoch, sig.step = epoch, global_step
            raise

    for epoch in range(start_epoch, loop.epochs):
        if batch_stream is None:
            grid = grid_of_epoch(epoch)
            steps = grid.shape[0]
        else:
            grid, steps = None, sampler.steps_per_epoch
        t0 = time.perf_counter()
        # Resume mid-epoch: skip the steps already done, clamped to
        # [0, steps] so a start past this epoch skips it wholesale.
        if start_done_in_epoch is not None:
            done_in_epoch = (min(start_done_in_epoch, steps)
                             if epoch == start_epoch else 0)
        else:
            done_in_epoch = min(
                max(global_step - epoch * sampler.steps_per_epoch, 0), steps)
        metrics = None
        batches = (batch_stream(epoch, done_in_epoch)
                   if batch_stream is not None and done_in_epoch < steps
                   else None)
        try:
            for i in range(done_in_epoch, steps):
                batch = (next(batches) if batches is not None
                         else batch_of_starts(grid[i]))
                state, metrics = train_step(state, batch)
                global_step += 1
                if loop.log_every and global_step % loop.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    log_row({"step": global_step, "epoch": epoch, **m})
                if (checkpointer is not None and loop.ckpt_every
                        and global_step % loop.ckpt_every == 0):
                    checkpointer.save(state, step=global_step,
                                      meta=epoch_meta(epoch, i + 1, steps))
                if i < steps - 1:
                    check_health(i + 1, steps)
        finally:
            # Drain the stream on every exit: epoch end, RestartSignal or
            # an error, so no prefetch thread is left running.
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        if metrics is None:
            continue  # every step was already done on resume: nothing to log
        epoch_metrics = {"epoch": epoch, "epoch_time_s": time.perf_counter() - t0,
                         "step": global_step, "loss": float(metrics["loss"])}
        if eval_fn is not None and loop.eval_every \
                and (epoch + 1) % loop.eval_every == 0:
            epoch_metrics.update(eval_fn(state))
        log_row(epoch_metrics)
        # The final step's health poll runs AFTER the epoch summary, so a
        # restart on the epoch boundary does not lose the summary row.
        check_health(steps, steps)
    if checkpointer is not None:
        checkpointer.save(state, step=global_step,
                          meta={"epoch": loop.epochs, "done_in_epoch": 0})
        checkpointer.wait()
    return state, history
