"""Training loop: index-batched steps and microbatch accumulation.

The step is the paper's workflow on one device:

    starts --(window gather from the RESIDENT series)--> (x, y) --> loss
           --> grads --> AdamW

The host only ever ships int32 window starts to the device; the series was
placed once (GPU-index-batching) and every step gathers its own batch there.
Microbatch gradient accumulation (``microbatches > 1``) sums gradients over
slices of the step's starts; ``grad_dtype="bfloat16"`` casts each gradient
tree before the sum.

Checkpointing, health callbacks, restart signals, durable history sinks and
streamed (prefetched) batches arrive with a later slice of the port;
:func:`run_training` raises if asked for them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.optim import AdamConfig, apply_updates, init_opt_state
from repro_torch.optim.adam import torch_dtype
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    epochs: int = 1
    log_every: int = 50
    microbatches: int = 1
    grad_dtype: str | None = None  # "bfloat16" compresses the gradient tree
    # Epoch-end eval cadence: run eval_fn after every N-th epoch (1 = every
    # epoch; 0 = never, even with an eval_fn).
    eval_every: int = 1
    # Checkpoint directory and async feed prefetch: not ported yet (later
    # slice); the pipeline raises when they are set.
    ckpt_dir: str | None = None
    prefetch_depth: int = 0


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


def zero_grads_like(params, grad_dtype: str | None):
    """Zero tree for microbatch gradient accumulation, in the dtype the
    gradients will have (``grad_dtype`` when set, else each param's own)."""
    return tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch_dtype(grad_dtype) if grad_dtype else p.dtype,
        device=p.device), params)


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
    adam: AdamConfig,
    schedule: Callable[[int], Any],
    *,
    microbatches: int = 1,
    grad_dtype: str | None = None,
):
    """Build the train step.

    loss_fn(params, batch) -> (loss, metrics).  ``batch`` is a tensor whose
    leading per-step batch dim is divisible by ``microbatches``.
    Returns step(state, batch) -> (state, metrics); metrics stay on the
    device (reading them synchronises).
    """
    gdt = torch_dtype(grad_dtype) if grad_dtype is not None else None

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        if gdt is not None:
            grads = [g.to(gdt) for g in grads]
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
        lr = schedule(opt_state["step"])
        new_params, new_opt, gnorm = apply_updates(params, grads, opt_state, adam, lr)
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
    health_cb=None,
    history_sink=None,
    batch_stream=None,
) -> tuple[Any, list[dict]]:
    """Generic epoch loop.

    ``sampler.epoch_global(e)`` yields [steps, global_batch] window ids;
    ``batch_of_starts`` maps one row to the step's batch (the device tensor
    of window starts — the gather itself happens inside the step, from the
    resident series).  Every ``log_every`` steps a row of float metrics is
    logged; each epoch ends with a summary row, carrying ``eval_fn``'s
    metrics on the ``eval_every`` cadence.
    """
    waiting = {"checkpointer": checkpointer, "health_cb": health_cb,
               "history_sink": history_sink, "batch_stream": batch_stream}
    for name, value in waiting.items():
        if value is not None:
            raise NotImplementedError(
                f"run_training({name}=...) is not ported yet; it arrives with "
                f"the checkpointing/prefetch slice of the port")
    history: list[dict] = []
    global_step = 0
    for epoch in range(loop.epochs):
        grid = sampler.epoch_global(epoch)
        t0 = time.perf_counter()
        metrics = None
        for row in grid:
            state, metrics = train_step(state, batch_of_starts(row))
            global_step += 1
            if loop.log_every and global_step % loop.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": global_step, "epoch": epoch, **m})
        if metrics is None:
            continue
        epoch_metrics = {"epoch": epoch, "epoch_time_s": time.perf_counter() - t0,
                         "step": global_step, "loss": float(metrics["loss"])}
        if eval_fn is not None and loop.eval_every \
                and (epoch + 1) % loop.eval_every == 0:
            epoch_metrics.update(eval_fn(state))
        history.append(epoch_metrics)
    return state, history
