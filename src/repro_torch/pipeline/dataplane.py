"""DataPlane — the per-rank half of the pipeline: placement → sampler → feeds.

The data plane owns everything that decides *which window ids reach which
worker*: the dataset placed on its device (the placement's resident rows),
the matching sampler, and the deterministic per-rank feed
``feed(rank, epoch) -> [steps, batch_per_rank]``, whole or as a chunk stream
for the prefetch pipeline (:meth:`DataPlane.grid_stream`).  It knows nothing
about the train step; that is the
:class:`repro_torch.pipeline.engine.Engine`'s job.

==============  ==============================  =============================
Placement       rows a rank keeps               sampler
==============  ==============================  =============================
REPLICATED      every row                       GlobalShuffleSampler
PARTITIONED     its time shard (+ halo, or the  ShardAlignedBatchSampler
                extent of a count-split         (falls back to the contiguous
                partition)                      count-split when a rank's
                                                shard holds too few windows)
ONDEMAND        its time shard                  GlobalShuffleSampler (global
                                                draws: the exchange brings
                                                the other ranks' rows)
==============  ==============================  =============================

One process is one rank of ``torch.distributed`` (or a contiguous block of
``world / processes`` feed ranks, :attr:`DataPlane.process_ranks`).  Without
a process group the plane is the JAX package's single-host lock-step
simulation: ``PipelineConfig(world=w)`` feeds one device the rank-major
global grid (``epoch_global``), the whole series resident, and no collective
is ever issued.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.distributed import (Placement, local_time_range,
                                          process_info, resident_rows)
from repro_torch.core.index_dataset import IndexDataset
from repro_torch.core.sampler import (GlobalShuffleSampler,
                                      LocalBatchShuffleSampler, ShardInfo)
from repro_torch.core.windows import WindowSpec
from repro_torch.device import resolve_device
from repro_torch.optim import AdamConfig
from repro_torch.pipeline.samplers import ShardAlignedBatchSampler
from repro_torch.tracing import span
from repro_torch.train.loop import TrainLoopConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything the pipeline decides beyond the data/model themselves."""

    batch_per_rank: int = 8
    placement: Placement = Placement.REPLICATED
    gather: str = "slice"  # slice | take | fused | pallas | auto | lm
    seed: int = 0
    # Worker count for the sampler.  None = the process group's size; set it
    # in one process to simulate w lock-step workers (the global batch is
    # then world × batch_per_rank, all on one device).
    world: int | None = None
    # PARTITIONED partitioning: "aligned" places each rank's windows on its
    # series shard (falls back to the count-split when a rank's shard holds
    # too few train windows); "count" forces the equal count-split (the
    # paper's Table-5 local-batch-shuffling arm).
    partition: str = "aligned"
    # PARTITIONED window domain (core/distributed.local_window_ids):
    # halo=True lets a rank's windows spill span−1 steps into the next shard,
    # whose first span−1 rows the rank then also keeps; halo=False keeps
    # windows strictly interior (slightly fewer samples).
    halo: bool = True
    adam: AdamConfig = AdamConfig()
    schedule: Callable[[Any], Any] | None = None  # step -> lr; None = adam.lr
    loop: TrainLoopConfig = TrainLoopConfig()
    device: str = "cuda"  # "cpu" only when asked for; no fallback


def _make_sampler(config: PipelineConfig, ds: IndexDataset, world: int):
    shard = ShardInfo(0, world)
    if config.placement is Placement.PARTITIONED:
        if config.partition == "aligned":
            # Per-rank partitions aligned to the series time-shards, so each
            # rank's gathers stay inside the rows it keeps (§5.4).
            try:
                return ShardAlignedBatchSampler(
                    ds.entries, ds.spec, ds.train_windows,
                    config.batch_per_rank, world, seed=config.seed,
                    halo=config.halo)
            except ValueError:
                # A rank's shard holds too few train windows (the 70/10/20
                # split leaves the val/test-tail ranks empty), or stride > 1:
                # fall back to the contiguous count-split; those ranks keep
                # the rows their partition spans (resident_rows).
                pass
        elif config.partition != "count":
            raise ValueError(f"unknown partition {config.partition!r}; "
                             "expected 'aligned' or 'count'")
        return LocalBatchShuffleSampler(ds.train_windows, config.batch_per_rank,
                                        shard, seed=config.seed)
    # REPLICATED: the paper's communication-free global shuffle.
    # ONDEMAND: the same global draws over a time-sharded series.
    return GlobalShuffleSampler(ds.train_windows, config.batch_per_rank, shard,
                                seed=config.seed)


@dataclasses.dataclass
class DataPlane:
    """A placed dataset + matching sampler + deterministic per-rank feeds."""

    config: PipelineConfig
    spec: WindowSpec
    dataset: IndexDataset  # its series: this process's resident rows
    sampler: Any
    device: torch.device
    world: int
    process: int = 0     # this process's rank in the process group
    processes: int = 1   # the group's size (1: no collective is issued)
    owned: tuple[int, int] | None = None  # global rows this process owns
    # split -> (tail_len, device batch | None): the ragged eval tail is the
    # same every evaluate call, so its device row is built once.
    _eval_tail_cache: dict = dataclasses.field(default_factory=dict,
                                               repr=False, compare=False)

    # ------------------------------------------------------------- accessors
    @property
    def steps_per_epoch(self) -> int:
        return self.sampler.steps_per_epoch

    @property
    def global_batch(self) -> int:
        return self.config.batch_per_rank * self.world

    @property
    def process_ranks(self) -> list[int] | None:
        """Feed ranks this process owns under ``torch.distributed``: the
        contiguous block of ``world / processes`` ranks at its index; None
        for one process (the lock-step simulation over ``epoch_global``)."""
        return _process_ranks(self.world, self.process, self.processes)

    @property
    def local_width(self) -> int:
        """Windows this process trains on each step."""
        ranks = self.process_ranks
        return self.global_batch if ranks is None else \
            len(ranks) * self.config.batch_per_rank

    @property
    def train_exchange(self) -> bool:
        """Whether train batches are assembled by the exchange:
        ``ONDEMAND`` over several processes (windows drawn globally)."""
        return self.processes > 1 and self.config.placement is Placement.ONDEMAND

    @property
    def eval_exchange(self) -> bool:
        """Whether eval batches are assembled by the exchange: the val/test
        pools are drawn globally, so under either time-sharded placement
        over several processes."""
        return self.processes > 1 and \
            self.config.placement is not Placement.REPLICATED

    @property
    def block(self) -> slice:
        """This process's columns of a global (rank-major) grid row."""
        ranks = self.process_ranks
        if ranks is None:
            return slice(0, self.global_batch)
        b = self.config.batch_per_rank
        return slice(ranks[0] * b, (ranks[-1] + 1) * b)

    @property
    def exchange_bytes(self) -> int:
        """Payload bytes the exchange all-reduces each train step (0 unless
        :attr:`train_exchange`)."""
        if not self.train_exchange:
            return 0
        series = self.dataset.series
        return self.global_batch * self.spec.span * \
            int(series[0].numel()) * series.element_size()

    def describe(self) -> dict:
        """The placement contract this data plane instantiated (testable)."""
        return {
            "placement": self.config.placement,
            "sampler": type(self.sampler).__name__,
            "gather": self.config.gather,
            "world": self.world,
            "global_batch": self.global_batch,
            "halo": self.config.halo,
            "device": str(self.device),
            "resident_rows": self.dataset.resident_rows,
            "resident_bytes": int(self.dataset.series.nbytes),
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
        """What the train loop iterates this epoch: the whole global grid in
        one process; under several processes, the concatenation of this
        process's own feed columns (no process builds the global grid) —
        except under ``ONDEMAND``, whose exchange needs every rank's starts:
        there the global grid, which the global shuffle derives whole for
        any one rank's feed anyway."""
        ranks = self.process_ranks
        if ranks is None or self.train_exchange:
            return self.epoch_global(epoch)
        return np.concatenate([self.feed(r, epoch) for r in ranks], axis=1)

    def feed_stream(self, rank: int, epoch: int, *, start: int = 0,
                    chunk: int = 8):
        """Chunk-iterable ``feed(rank, epoch)``: ``[<=chunk, batch]`` row
        blocks that concatenate exactly to the feed, from row ``start``."""
        return self.sampler.feed_stream(rank, epoch, start=start, chunk=chunk)

    def grid_stream(self, epoch: int, *, start: int = 0, chunk: int = 8):
        """Chunk-iterable :meth:`epoch_grid`: ``[<=chunk, width]`` row blocks
        from row ``start`` (a mid-epoch resume).  The host half of the
        prefetch pipeline — pure numpy, safe to drain from a background
        thread.  Under several processes each block concatenates this
        process's per-rank ``feed_stream`` blocks (row-aligned: they share
        start and chunk); the blocks reassemble exactly to
        ``epoch_grid(epoch)``."""
        ranks = self.process_ranks
        if ranks is None or self.train_exchange:
            grid = self.epoch_global(epoch)
            for lo in range(start, grid.shape[0], chunk):
                yield grid[lo:lo + chunk]
            return
        streams = [self.sampler.feed_stream(r, epoch, start=start, chunk=chunk)
                   for r in ranks]
        for blocks in zip(*streams):
            yield np.concatenate(blocks, axis=1)

    # ------------------------------------------------------------ eval feeds
    def eval_pool(self, split: str = "val") -> np.ndarray:
        """The split's window-id pool (``val_windows``/``test_windows``)."""
        return np.asarray(getattr(self.dataset, f"{split}_windows"))

    def eval_feed(self, rank: int, split: str = "val") -> np.ndarray:
        """[steps, batch_per_rank] eval window ids for ``rank``: its column
        block of the split pool's full global chunks, in pool order."""
        return self.sampler.eval_feed(rank, self.eval_pool(split))

    def eval_tail(self, split: str = "val") -> np.ndarray:
        """The split's ragged remainder — global, identical on every rank."""
        return self.sampler.eval_tail(self.eval_pool(split))

    def eval_grid(self, split: str = "val") -> tuple[np.ndarray, np.ndarray]:
        """``(rows, tail)`` — what THIS process iterates when evaluating.

        ``rows``: the pool's full global chunks in one process, and under
        :attr:`eval_exchange` (each process keeps its :attr:`block` of what
        the exchange assembles); otherwise this process's own ``eval_feed``
        columns.  ``tail``: the global ragged remainder, scored once."""
        pool = self.eval_pool(split)
        tail = self.sampler.eval_tail(pool)
        ranks = self.process_ranks
        if ranks is None or self.eval_exchange:
            return self.sampler.eval_global(pool), tail
        return np.concatenate(
            [self.sampler.eval_feed(r, pool) for r in ranks], axis=1), tail

    def eval_tail_batch(self, split: str = "val"):
        """``(tail_len, device batch | None)`` for the split's ragged eval
        tail — built once per data plane and cached."""
        hit = self._eval_tail_cache.get(split)
        if hit is None:
            tail = self.eval_tail(split)
            batch = (self.batch_of_starts(tail, exchange=self.eval_exchange)
                     if len(tail) else None)
            hit = (len(tail), batch)
            self._eval_tail_cache[split] = hit
        return hit

    # --------------------------------------------------------- data plumbing
    def host_batch_of_starts(self, window_ids: np.ndarray, *,
                             exchange: bool | None = None) -> np.ndarray:
        """Window ids -> HOST int32 array of start steps rebased to the
        resident rows' origin: the batch before its copy to the device.

        Gathered locally (``exchange`` False; default: not
        :attr:`train_exchange`), every start must leave a whole window inside
        the resident rows, ``[0, rows - span]``: the gathers clamp, so a
        start outside would silently read other rows.  Checked here, on the
        host, before the copy; a start outside raises ``ValueError``.
        Exchanged starts may lie anywhere (the exchange masks by owner)."""
        if exchange is None:
            exchange = self.train_exchange
        starts = np.asarray(self.dataset.starts[np.asarray(window_ids)],
                            np.int64) - self.dataset.origin
        rows = self.dataset.series.shape[0]
        if not exchange and len(starts) and \
                (starts.min() < 0 or starts.max() > rows - self.spec.span):
            lo, hi = self.dataset.resident_rows
            bad = starts[(starts < 0) | (starts > rows - self.spec.span)] + lo
            raise ValueError(
                f"window starts {bad[:8].tolist()} leave the resident rows "
                f"[{lo}, {hi}) of a {self.config.placement.value} placement "
                f"(span {self.spec.span})")
        return starts.astype(np.int32)

    def can_defer_transfer(self) -> bool:
        """Whether the prefetcher may take host batches and copy them to the
        device itself: always, on the one device a process places on (the
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

    def batch_of_starts(self, window_ids: np.ndarray, *,
                        exchange: bool | None = None) -> torch.Tensor:
        """Window ids (one grid row) -> int32 tensor of rebased start steps
        on the plane's device (see :meth:`host_batch_of_starts`)."""
        with span("starts"):
            starts = self.host_batch_of_starts(window_ids, exchange=exchange)
            return torch.as_tensor(starts).to(self.device)

    # --------------------------------------------------------------- elastic
    def remesh(self, *, world: int, batch_per_rank: int) -> "DataPlane":
        """This plane rebuilt for a new logical world (an elastic shrink or
        grow): the same windows, splits and scaler, a sampler for ``world``
        ranks of ``batch_per_rank``, and the series placed again on the
        plane's device, so (seed, epoch) determinism holds.

        One process only: the whole series is resident there, and its host
        copy is what the new plane places.  A fleet of processes relaunches
        into the new world instead (``ElasticConfig(remesh="relaunch")``).
        This plane gives up its device series BEFORE the new one is
        allocated, so the re-mesh never holds two copies on the device; the
        caller must hold no other reference to it (the engine drops its
        compiled step first).  This plane is unusable afterwards.
        """
        if self.processes > 1:
            raise ValueError(
                f"DataPlane.remesh rebuilds a one-process plane; under a "
                f"process group of {self.processes} the fleet relaunches into "
                f"the new world instead")
        config = dataclasses.replace(self.config, world=world,
                                     batch_per_rank=batch_per_rank)
        host_ds = dataclasses.replace(
            self.dataset, series=self.dataset.series.detach().cpu().numpy())
        self.dataset = dataclasses.replace(self.dataset, series=None)
        self._eval_tail_cache.clear()
        return build_dataplane(None, self.spec, config, dataset=host_ds)


def _process_ranks(world: int, process: int, processes: int) -> list[int] | None:
    if processes <= 1:
        return None
    if world % processes:
        raise NotImplementedError(
            f"world {world} is not divisible by the process count "
            f"{processes}; per-process feeds need world % processes == 0")
    per = world // processes
    return list(range(process * per, (process + 1) * per))


def _feed_rows(config: PipelineConfig, ds: IndexDataset, sampler, world: int,
               ranks: list[int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """``(owned, resident)`` global rows of the process that owns ``ranks``:
    the union of its ranks' shards, and the hull of their
    :func:`~repro_torch.core.distributed.resident_rows`, widened under
    PARTITIONED to each rank's actual feed domain."""
    entries = ds.entries
    owned = (local_time_range(entries, ranks[0], world)[0],
             local_time_range(entries, ranks[-1], world)[1])
    # the halo belongs to the shard-aligned placement; a count-split
    # partition's own windows set its extent
    halo = config.halo and isinstance(sampler, ShardAlignedBatchSampler)
    spans = []
    for r in ranks:
        feed_ids = None
        if config.placement is Placement.PARTITIONED:
            feed_ids = ds.starts[sampler.domain(r)]
        spans.append(resident_rows(config.placement, entries, ds.spec, r, world,
                                   halo=halo, feed_ids=feed_ids))
    return owned, (min(lo for lo, _ in spans), max(hi for _, hi in spans))


def build_dataplane(
    raw: np.ndarray | None,
    spec: WindowSpec,
    config: PipelineConfig = PipelineConfig(),
    *,
    dataset: IndexDataset | None = None,
) -> DataPlane:
    """Place this process's resident rows on ``config.device`` and pair them
    with the placement's sampler.

    Pass ``dataset=`` to reuse a host ``IndexDataset``; otherwise ``raw`` is
    windowed/standardised into one (statistics of the whole train split).
    Only the resident rows reach the device, and the plane keeps no
    reference to the host series.
    """
    device = resolve_device(config.device)
    process, processes = process_info()
    world = config.world if config.world is not None else processes
    ds = dataset if dataset is not None else IndexDataset.from_raw(raw, spec)
    sampler = _make_sampler(config, ds, world)
    ranks = _process_ranks(world, process, processes)
    if ranks is None:
        owned = rows = (0, ds.entries)
    else:
        owned, rows = _feed_rows(config, ds, sampler, world, ranks)
    ds = ds.to_device(device, rows=rows)
    return DataPlane(config=config, spec=spec, dataset=ds, sampler=sampler,
                     device=device, world=world, process=process,
                     processes=processes, owned=owned)
