"""DataPlane — the per-rank half of the pipeline: placement → sampler → feeds.

The data plane owns everything that decides *which window ids reach which
worker*: the dataset placed on its device, the matching sampler, and the
deterministic feeds (the sampler's ``feed(rank, epoch)``), whole or as a
chunk stream for the prefetch pipeline (:meth:`DataPlane.grid_stream`).
It knows nothing about the train step; that is the
:class:`repro_torch.pipeline.engine.Engine`'s job.

This slice of the port runs one device with ``Placement.REPLICATED`` (the
series whole on the card, global shuffling).  The time-sharded placements
arrive with distributed-index-batching.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.distributed import Placement
from repro_torch.core.index_dataset import IndexDataset
from repro_torch.core.sampler import GlobalShuffleSampler, ShardInfo
from repro_torch.core.windows import WindowSpec
from repro_torch.device import resolve_device
from repro_torch.optim import AdamConfig
from repro_torch.train.loop import TrainLoopConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything the pipeline decides beyond the data/model themselves."""

    batch_per_rank: int = 8
    placement: Placement = Placement.REPLICATED
    gather: str = "slice"  # slice | take | fused | pallas | auto
    seed: int = 0
    adam: AdamConfig = AdamConfig()
    schedule: Callable[[Any], Any] | None = None  # step -> lr; None = adam.lr
    loop: TrainLoopConfig = TrainLoopConfig()
    device: str = "cuda"  # "cpu" only when asked for; no fallback


@dataclasses.dataclass
class DataPlane:
    """A placed dataset + matching sampler + deterministic feeds."""

    config: PipelineConfig
    spec: WindowSpec
    dataset: IndexDataset
    sampler: GlobalShuffleSampler
    device: torch.device
    # split -> (tail_len, device batch | None): the ragged eval tail is the
    # same every evaluate call, so its device row is built once.
    _eval_tail_cache: dict = dataclasses.field(default_factory=dict,
                                               repr=False, compare=False)

    # ------------------------------------------------------------- accessors
    @property
    def world(self) -> int:
        return 1

    @property
    def steps_per_epoch(self) -> int:
        return self.sampler.steps_per_epoch

    @property
    def global_batch(self) -> int:
        return self.config.batch_per_rank * self.world

    def describe(self) -> dict:
        """The placement contract this data plane instantiated (testable)."""
        return {
            "placement": self.config.placement,
            "sampler": type(self.sampler).__name__,
            "gather": self.config.gather,
            "world": self.world,
            "global_batch": self.global_batch,
            "device": str(self.device),
        }

    # ----------------------------------------------------------------- feeds
    def feed(self, rank: int, epoch: int) -> np.ndarray:
        """[steps, batch_per_rank] window ids for ``rank`` — a pure function
        of (seed, epoch, rank)."""
        return self.sampler.feed(rank, epoch)

    def epoch_global(self, epoch: int) -> np.ndarray:
        """[steps, world*batch] — single-host assembly of the feed columns."""
        return self.sampler.epoch_global(epoch)

    def epoch_grid(self, epoch: int) -> np.ndarray:
        """What the train loop iterates this epoch: on one process, the
        whole global grid."""
        return self.epoch_global(epoch)

    def feed_stream(self, rank: int, epoch: int, *, start: int = 0,
                    chunk: int = 8):
        """Chunk-iterable ``feed(rank, epoch)``: ``[<=chunk, batch]`` row
        blocks that concatenate exactly to the feed, from row ``start``."""
        return self.sampler.feed_stream(rank, epoch, start=start, chunk=chunk)

    def grid_stream(self, epoch: int, *, start: int = 0, chunk: int = 8):
        """Chunk-iterable :meth:`epoch_grid`: ``[<=chunk, width]`` row blocks
        from row ``start`` (a mid-epoch resume).  The host half of the
        prefetch pipeline — pure numpy, safe to drain from a background
        thread; the blocks reassemble exactly to ``epoch_grid(epoch)``."""
        grid = self.epoch_grid(epoch)
        for lo in range(start, grid.shape[0], chunk):
            yield grid[lo:lo + chunk]

    # ------------------------------------------------------------ eval feeds
    def eval_pool(self, split: str = "val") -> np.ndarray:
        """The split's window-id pool (``val_windows``/``test_windows``)."""
        return np.asarray(getattr(self.dataset, f"{split}_windows"))

    def eval_grid(self, split: str = "val") -> tuple[np.ndarray, np.ndarray]:
        """``(rows, tail)``: the pool's full ``[steps, global_batch]`` chunks
        in pool order, and the ragged remainder."""
        pool = self.eval_pool(split)
        return self.sampler.eval_global(pool), self.sampler.eval_tail(pool)

    def eval_tail_batch(self, split: str = "val"):
        """``(tail_len, device batch | None)`` for the split's ragged eval
        tail — built once per data plane and cached."""
        hit = self._eval_tail_cache.get(split)
        if hit is None:
            tail = self.sampler.eval_tail(self.eval_pool(split))
            hit = (len(tail), self.batch_of_starts(tail) if len(tail) else None)
            self._eval_tail_cache[split] = hit
        return hit

    # --------------------------------------------------------- data plumbing
    def host_batch_of_starts(self, window_ids: np.ndarray) -> np.ndarray:
        """Window ids -> HOST int32 array of start steps: the batch before
        its copy to the device.  The prefetcher's transfer thread builds it
        at staleness >= 1 and copies it to the device from a pinned buffer on
        a side stream (:class:`repro_torch.pipeline.prefetch.FeedPrefetcher`);
        the bytes equal :meth:`batch_of_starts`'s."""
        return np.asarray(self.dataset.starts[np.asarray(window_ids)], np.int32)

    def can_defer_transfer(self) -> bool:
        """Whether the prefetcher may take host batches and copy them to the
        device itself: always, on the one device this plane places on (the
        JAX package's multi-process and sharded planes cannot)."""
        return True

    def prefetch_transfer(self, staleness: int):
        """The transfer fn the prefetcher runs at this staleness: at 0,
        :meth:`batch_of_starts` on the consumer thread — the synchronous
        path's exact op order; at >= 1, :meth:`host_batch_of_starts` on the
        transfer thread, which then copies the row to the device."""
        if staleness >= 1 and self.can_defer_transfer():
            return self.host_batch_of_starts
        return self.batch_of_starts

    def batch_of_starts(self, window_ids: np.ndarray) -> torch.Tensor:
        """Window ids (one epoch grid row) -> int32 tensor of start steps on
        the plane's device."""
        starts = np.asarray(self.dataset.starts[np.asarray(window_ids)])
        return torch.as_tensor(starts, dtype=torch.int32).to(self.device)


def build_dataplane(
    raw: np.ndarray | None,
    spec: WindowSpec,
    config: PipelineConfig = PipelineConfig(),
    *,
    dataset: IndexDataset | None = None,
) -> DataPlane:
    """Place the dataset on ``config.device`` and pair it with the sampler.

    Pass ``dataset=`` to reuse an already-built ``IndexDataset``; otherwise
    ``raw`` is windowed/standardised into one.
    """
    if config.placement is not Placement.REPLICATED:
        raise NotImplementedError(
            f"placement {config.placement.value!r} is not ported yet; it "
            f"arrives with the distributed-index-batching slice")
    device = resolve_device(config.device)
    ds = dataset if dataset is not None else IndexDataset.from_raw(raw, spec)
    ds = ds.to_device(device)
    sampler = GlobalShuffleSampler(ds.train_windows, config.batch_per_rank,
                                   ShardInfo(0, 1), seed=config.seed)
    return DataPlane(config=config, spec=spec, dataset=ds, sampler=sampler,
                     device=device)
