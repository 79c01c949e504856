"""Engine — the execution half of the pipeline: the train step with the
window gather fused in, checkpoints, ``fit`` and ``evaluate``.

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
rank returns the same value.  Elastic restarts (``ROADMAP.md`` queue 1, item
4b) raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.index_dataset import IndexDataset
from repro_torch.core.windows import WindowSpec
from repro_torch.distributed import Checkpointer, checkpoint_meta, latest_step, restore
from repro_torch.pipeline.dataplane import DataPlane, PipelineConfig, build_dataplane
from repro_torch.pipeline.gathers import EXCHANGE_IMPL, exchange_windows, resolve_gather
from repro_torch.pipeline.prefetch import FeedPrefetcher, PrefetchPlan
from repro_torch.train.loop import (combine_weighted, init_train_state,
                                    make_train_step, run_training)
from repro_torch.tree import tree_map


@dataclasses.dataclass
class Engine:
    """Train step + evaluation over a DataPlane."""

    dataplane: DataPlane
    init_params: Any
    train_step: Callable
    _eval_loss: Callable  # (params, starts) -> (loss, metrics), gathered locally
    _exchange_loss: Callable  # (params, starts, keep) -> (loss, metrics)

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

    def is_leader(self) -> bool:
        """Whether this process writes checkpoints and history rows:
        process 0 (the JAX package's gate without a leader tracker)."""
        return self.dataplane.process == 0

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
        — on process 0 only; every process returns the rows.
        """
        loop = self.config.loop
        if epochs is not None:
            loop = dataclasses.replace(loop, epochs=epochs)
        params = tree_map(lambda p: p.detach().clone(), self.init_params)
        state = init_train_state(params, self.config.adam)
        checkpointer = Checkpointer(loop.ckpt_dir) if loop.ckpt_dir else None
        start_step, start_epoch, start_done = 0, 0, None
        if resume and loop.ckpt_dir and latest_step(loop.ckpt_dir) is not None:
            state, start_step = restore(loop.ckpt_dir, state)
            # Prefer the checkpoint's own (epoch, done_in_epoch) coordinates;
            # start_step stays the raw, monotonic step counter.
            meta = checkpoint_meta(loop.ckpt_dir)
            if "epoch" in meta:
                start_epoch = int(meta["epoch"])
                start_done = max(int(meta.get("done_in_epoch", 0)), 0)
            else:
                start_epoch = start_step // self.steps_per_epoch
        if eval_fn == "auto":
            eval_fn = (lambda st: {"val_mae": self.evaluate(st["params"])}) \
                if len(self.dataset.val_windows) > 0 else None
        if not self.is_leader():
            history_sink = None
        batch_stream = None
        if loop.prefetch_depth >= 1:
            plan = PrefetchPlan(depth=loop.prefetch_depth, staleness=loop.staleness,
                                chunk=loop.prefetch_chunk)

            def batch_stream(epoch: int, done: int) -> FeedPrefetcher:
                dp = self.dataplane
                return FeedPrefetcher(
                    dp.grid_stream(epoch, start=done, chunk=plan.chunk),
                    dp.prefetch_transfer(plan.staleness), plan, device=dp.device)
        try:
            return run_training(
                state=state, train_step=self.train_step, sampler=self.dataplane,
                batch_of_starts=self.dataplane.batch_of_starts, loop=loop,
                eval_fn=eval_fn, checkpointer=checkpointer,
                start_epoch=start_epoch, start_step=start_step,
                start_done_in_epoch=start_done, history_sink=history_sink,
                batch_stream=batch_stream)
        except BaseException:
            # Do not strand the in-flight async checkpoint write: flush it so
            # a restart resumes from the newest durable step.
            if checkpointer is not None:
                try:
                    checkpointer.flush()
                except Exception:
                    pass
            raise

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
        return loss_fn(params, windows[:, :spec.in_len], windows[:, spec.in_len:])

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
    elastic: Any = None,
) -> Engine:
    """Assemble the placement-aware trainer (DataPlane + Engine) for this
    process: one device, or one rank of the ``torch.distributed`` group.

    ``loss_fn(params, x, y) -> (loss, metrics)`` is the only model-specific
    piece; the engine supplies (x, y) by fusing the selected window gather
    (and, where rows lie on other ranks, the exchange) into the step.  Pass
    ``dataset=`` to reuse a host ``IndexDataset``.  ``elastic`` raises:
    elastic restarts are ``ROADMAP.md`` queue 1, item 4b.
    """
    if elastic is not None:
        raise NotImplementedError(
            "elastic is not ported yet: ROADMAP.md queue 1, item 4b "
            "(elastic restarts, heartbeats and leader succession)")
    dataplane = build_dataplane(raw, spec, config, dataset=dataset)
    train_step, eval_loss, exchange_loss = _compile(dataplane, loss_fn, config)
    return Engine(dataplane=dataplane, init_params=init_params,
                  train_step=train_step, _eval_loss=eval_loss,
                  _exchange_loss=exchange_loss)
