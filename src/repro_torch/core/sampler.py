"""Epoch samplers: global shuffling vs local batch shuffling (paper §4.2, §5.4).

*Global shuffling* (distributed-index-batching): every epoch draws a fresh
permutation of **all** training windows; rank r takes the r-th slice.  Because
each worker holds the full series, this costs zero communication — the paper's
key scalability win.

*Local batch shuffling* (generalized-distributed-index-batching): each rank owns
a fixed, contiguous window partition; only the *order of batches* inside the
partition is shuffled between epochs (Table 5 shows accuracy parity).

Samplers are deterministic functions of (seed, epoch), pure numpy, and draw
exactly the permutations of the JAX package's samplers, so both packages
train on the same feeds.  The first-class primitive is
``feed(rank, epoch) -> [steps, batch_per_rank]``; ``epoch_global(epoch)`` is
the single-host assembly of the per-rank feed columns (rank-major).

Evaluation mirrors the same contract through :class:`EvalFeeds`
(``eval_feed(rank, pool)``): val/test pools are carved into the same
rank-major column blocks, deterministically and without shuffling.

Feeds are also CHUNK-ITERABLE (:class:`FeedStream`): ``feed_stream(rank,
epoch)`` yields successive row blocks that concatenate exactly to
``feed(rank, epoch)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    rank: int
    world: int

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside world {self.world}")


def _rng(seed: int, epoch: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, epoch]))


class FeedStream:
    """Chunk-iterable view of the per-rank feed.

    ``feed_stream(rank, epoch)`` yields successive ``[<=chunk, batch]``
    row blocks whose concatenation is EXACTLY ``feed(rank, epoch)`` — same
    values, same order.
    """

    def feed_stream(self, rank: int, epoch: int, *, start: int = 0,
                    chunk: int = 8):
        """Yield ``[<=chunk, batch]`` blocks of ``feed(rank, epoch)`` rows,
        beginning at row ``start`` (mid-epoch resume)."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        feed = self.feed(rank, epoch)
        for lo in range(start, feed.shape[0], chunk):
            yield feed[lo:lo + chunk]


class EvalFeeds(FeedStream):
    """Deterministic per-rank EVAL feeds — the evaluation mirror of the
    ``feed(rank, epoch)`` contract.

    Eval pools (val/test window ids) are scored in POOL ORDER: no shuffling,
    no epoch argument.  The pool's full global chunks ``[steps, world*batch]``
    are carved rank-major like the train grid: ``eval_feed(rank, pool)`` is
    column block ``rank``, and ``concat([eval_feed(r, pool) for r in ranks],
    axis=1).ravel()`` followed by ``eval_tail(pool)`` reproduces the pool
    exactly once.

    The ragged tail (``len(pool) % (world*batch)`` windows) stays GLOBAL:
    every rank sees all of it and scores it as one small replicated batch.
    """

    def _eval_world(self) -> int:
        shard = getattr(self, "shard", None)
        return shard.world if shard is not None else self.world

    def eval_feed(self, rank: int, pool: np.ndarray) -> np.ndarray:
        """[steps, batch_per_rank] eval window ids for ``rank``: its column
        block of the pool's full global chunks, in pool order."""
        pool = np.asarray(pool)
        world, b = self._eval_world(), self.batch
        steps = len(pool) // (world * b)
        return pool[:steps * world * b].reshape(steps, world, b)[:, rank, :]

    def eval_tail(self, pool: np.ndarray) -> np.ndarray:
        """The ragged remainder after the full chunks — global, identical on
        every rank (scored once as a replicated small batch)."""
        pool = np.asarray(pool)
        world, b = self._eval_world(), self.batch
        return pool[(len(pool) // (world * b)) * world * b:]

    def eval_global(self, pool: np.ndarray) -> np.ndarray:
        """[steps, world*batch] single-host assembly of the eval feed columns
        — exactly the pool's full chunks, in order."""
        pool = np.asarray(pool)
        world, b = self._eval_world(), self.batch
        steps = len(pool) // (world * b)
        return pool[:steps * world * b].reshape(steps, world * b)


class GlobalShuffleSampler(EvalFeeds):
    """Paper default: communication-free global shuffle across all windows."""

    def __init__(self, window_ids: np.ndarray, batch_per_rank: int, shard: ShardInfo, *, seed: int = 0,
                 drop_remainder: bool = True):
        self.window_ids = np.asarray(window_ids, dtype=np.int32)
        self.batch = batch_per_rank
        self.shard = shard
        self.seed = seed
        global_batch = batch_per_rank * shard.world
        self.steps_per_epoch = len(self.window_ids) // global_batch
        if not drop_remainder and len(self.window_ids) % global_batch:
            raise NotImplementedError("padding of ragged final batch not supported")
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"{len(self.window_ids)} windows < global batch {global_batch}")

    def feed(self, rank: int, epoch: int) -> np.ndarray:
        """[steps, batch_per_rank] window ids for ``rank`` — the per-process
        feed.  Any rank derives any feed from (seed, epoch) alone."""
        perm = _rng(self.seed, epoch).permutation(self.window_ids)
        n = self.steps_per_epoch * self.batch * self.shard.world
        grid = perm[:n].reshape(self.steps_per_epoch, self.shard.world, self.batch)
        return grid[:, rank, :]

    def epoch(self, epoch: int) -> np.ndarray:
        """[steps, batch_per_rank] window ids for this rank."""
        return self.feed(self.shard.rank, epoch)

    def epoch_global(self, epoch: int) -> np.ndarray:
        """[steps, world*batch] — the whole global batch per step, rank-major:
        the single-host assembly of the per-rank ``feed`` columns."""
        perm = _rng(self.seed, epoch).permutation(self.window_ids)
        n = self.steps_per_epoch * self.batch * self.shard.world
        return perm[:n].reshape(self.steps_per_epoch, self.shard.world * self.batch)


class LocalBatchShuffleSampler(EvalFeeds):
    """Generalized variant: fixed per-rank partition, shuffled batch order."""

    def __init__(self, window_ids: np.ndarray, batch_per_rank: int, shard: ShardInfo, *, seed: int = 0):
        ids = np.asarray(window_ids, dtype=np.int32)
        parts = np.array_split(ids, shard.world)
        self.window_ids = ids
        self.batch = batch_per_rank
        self.shard = shard
        self.seed = seed
        self.steps_per_epoch = min(len(p) for p in parts) // batch_per_rank
        if self.steps_per_epoch == 0:
            raise ValueError("partition smaller than one batch")
        n = self.steps_per_epoch * batch_per_rank
        self._rank_batches = [p[:n].reshape(self.steps_per_epoch, batch_per_rank)
                              for p in parts]

    def feed(self, rank: int, epoch: int) -> np.ndarray:
        """[steps, batch] for ``rank``: its fixed partition's batches in the
        (seed, epoch) order — identical on every host that derives it."""
        order = _rng(self.seed, epoch).permutation(self.steps_per_epoch)
        return self._rank_batches[rank][order]

    def domain(self, rank: int) -> np.ndarray:
        """Every window id ``feed(rank, e)`` can hold, for any epoch."""
        return self._rank_batches[rank].reshape(-1)

    def epoch(self, epoch: int) -> np.ndarray:
        return self.feed(self.shard.rank, epoch)

    def epoch_global(self, epoch: int) -> np.ndarray:
        """[steps, world*batch] rank-major assembly of every rank's feed:
        column block r is exactly ``feed(r, epoch)``."""
        return np.concatenate(
            [self.feed(r, epoch) for r in range(self.shard.world)], axis=1)


def local_shuffle_sampler(window_ids, batch_per_rank, shard, *, seed=0):
    """Classic local shuffling (shuffle *samples* within a fixed partition) —
    included for the Table-5 comparison axis."""

    class _S(LocalBatchShuffleSampler):
        def feed(self, rank: int, epoch: int) -> np.ndarray:
            flat = self._rank_batches[rank].reshape(-1)
            perm = _rng(self.seed, epoch).permutation(flat)
            return perm.reshape(self.steps_per_epoch, self.batch)

    return _S(window_ids, batch_per_rank, shard, seed=seed)
