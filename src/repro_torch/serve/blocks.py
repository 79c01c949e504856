"""BlockPool: the paged KV-cache allocator (host-side bookkeeping).

Instead of materialising ``max_len`` of contiguous cache per slot up front,
cache lines are paged from a shared pool of fixed-size sequence blocks and a
per-request *block table* maps logical positions to physical blocks.  Slot
memory then scales with live tokens, not ``max_len x slots``, and admission
becomes a block-accounting decision: a request that does not fit raises
``Backpressure`` instead of running the device out of memory.

Physical block 0 is the NULL block and is never allocated: retired lanes keep
all-zero block tables, so their (masked, ignored) decode writes land in block
0 and can never corrupt a live request's blocks.  The allocator hands out
blocks ``1..num_blocks``.

Allocation is up-front at admission: a request needs
``blocks_for(min(prompt + budget, max_len))`` blocks for its whole lifetime,
so decode never allocates mid-flight and a prefilled request can always run
to its budget.  Freed blocks return to the free list in retirement order and
are reused at once (their stale contents are masked by per-lane lengths
until overwritten).
"""
from __future__ import annotations

from collections import deque

from repro_torch.serve.router import Backpressure

#: physical block id reserved as the write sink for retired/masked lanes
NULL_BLOCK = 0


class BlockPool:
    """Free-list allocator over ``num_blocks`` usable KV-cache blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 usable block, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        #: usable blocks (excludes the null block 0)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: deque[int] = deque(range(1, self.num_blocks + 1))
        self._owned: set[int] = set()

    @property
    def available(self) -> int:
        """Blocks free for allocation right now."""
        return len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` cache positions (ceil)."""
        return -(-int(tokens) // self.block_size)

    def alloc(self, n: int) -> list[int]:
        """Allocate ``n`` blocks.  Raises ``Backpressure`` on exhaustion (the
        clean admission failure: the caller retries after retirements free
        blocks) and allocates nothing then."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise Backpressure(
                f"block pool exhausted ({len(self._free)}/{self.num_blocks} "
                f"free, need {n}); retry after retirements")
        blocks = [self._free.popleft() for _ in range(n)]
        self._owned.update(blocks)
        return blocks

    def free(self, blocks: list[int]) -> None:
        """Return blocks to the pool.  Double-free, foreign ids and
        duplicates within one call raise ``ValueError`` with the pool
        unchanged: a block on the free list twice would be handed to two
        requests."""
        if len(set(blocks)) != len(blocks):
            dupes = sorted({b for b in blocks if blocks.count(b) > 1})
            raise ValueError(
                f"duplicate block ids in one free call: {dupes}; the pool "
                f"is unchanged")
        for b in blocks:
            if b not in self._owned:
                raise ValueError(f"free of unallocated block {b}")
        for b in blocks:
            self._owned.remove(b)
            self._free.append(b)
