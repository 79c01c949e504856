"""Shard-aligned local batch sampler for the PARTITIONED placement.

``local_time_range`` splits the series' TIME axis evenly across the ranks,
and under PARTITIONED each rank keeps only its shard on its device
(``core/distributed.resident_rows``).  For the §5.4 communication-free
contract to hold, each rank's sampled windows must lie inside the rows it
holds — a plain count-split of the train windows lands on different
boundaries.

``ShardAlignedBatchSampler`` draws rank r's windows from
``local_window_ids(entries, spec, r, world) ∩ train`` — the same definition
the placement math uses — so gathers stay on the rank's rows (halo windows
included: their rows are resident too).  Batch ORDER shuffles between epochs;
partition content is fixed (local batch shuffling, Table 5).

Alignment is only possible when every rank's local train-window count covers
at least one batch; with the standard 70/10/20 contiguous split, ranks owning
the val/test tail of the series may have none.  ``build_dataplane`` falls
back to the contiguous count-split (``LocalBatchShuffleSampler``) in that
case, and those ranks then keep the rows their partition spans.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.distributed import local_window_ids
from repro_torch.core.sampler import EvalFeeds, _rng
from repro_torch.core.windows import WindowSpec


class ShardAlignedBatchSampler(EvalFeeds):
    """Per-rank fixed partitions aligned to ``local_time_range`` boundaries."""

    def __init__(
        self,
        entries: int,
        spec: WindowSpec,
        train_ids: np.ndarray,
        batch_per_rank: int,
        world: int,
        *,
        seed: int = 0,
        halo: bool = True,
    ):
        if spec.stride != 1:
            raise ValueError("shard alignment requires stride=1 "
                             "(window id == start step)")
        train = np.asarray(train_ids, dtype=np.int32)
        self.rank_ids = []
        for r in range(world):
            ids = local_window_ids(entries, spec, r, world, halo=halo)
            self.rank_ids.append(ids[np.isin(ids, train)])
        counts = [len(ids) for ids in self.rank_ids]
        self.batch = batch_per_rank
        self.world = world
        self.seed = seed
        # Batch CONTENT is fixed once per rank (local batch shuffling); the
        # lock-step step count is set by the smallest rank.  Larger ranks draw
        # a cyclically-rotating window over a fixed permutation of their
        # batches each epoch, so every batch is visited at least once every
        # ceil(n_batches / steps_per_epoch) epochs.
        self.rank_batches = []
        for ids in self.rank_ids:
            n_b = len(ids) // batch_per_rank
            self.rank_batches.append(
                ids[:n_b * batch_per_rank].reshape(n_b, batch_per_rank))
        self.steps_per_epoch = min(b.shape[0] for b in self.rank_batches)
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"rank partition too small for one batch (counts={counts}); "
                "widen the train split or use the count-split sampler")

    def feed(self, rank: int, epoch: int) -> np.ndarray:
        """[steps, batch] window ids for ``rank``, deterministic in
        (seed, epoch): a cyclic window of ``steps_per_epoch`` entries over a
        FIXED per-rank permutation of the rank's batches, advanced by
        ``steps_per_epoch`` each epoch; order within the epoch reshuffles
        per (seed, epoch)."""
        batches = self.rank_batches[rank]
        n_b = batches.shape[0]
        steps = self.steps_per_epoch
        # fixed per-rank permutation (epoch-independent; rank offsets the seed)
        base = _rng(self.seed, 1_000_003 + rank).permutation(n_b)
        start = (epoch * steps) % n_b
        chosen = base[np.arange(start, start + steps) % n_b]
        order = _rng(self.seed, epoch).permutation(steps)
        return batches[chosen[order]]

    def domain(self, rank: int) -> np.ndarray:
        """Every window id ``feed(rank, e)`` can hold, for any epoch."""
        return self.rank_batches[rank].reshape(-1)

    def epoch_rank(self, epoch: int, rank: int) -> np.ndarray:
        """Transposed-argument alias of :meth:`feed` (the JAX package keeps
        it for callers that predate the feed contract)."""
        return self.feed(rank, epoch)

    def epoch(self, epoch: int) -> np.ndarray:
        return self.feed(0, epoch)

    def epoch_global(self, epoch: int) -> np.ndarray:
        """[steps, world*batch] rank-major assembly of the per-rank feeds."""
        return np.concatenate(
            [self.feed(r, epoch) for r in range(self.world)], axis=1)
