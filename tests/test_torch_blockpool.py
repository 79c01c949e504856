"""Port parity for the paged-KV allocator (``serve/blocks.py``): the cases of
tests/test_blockpool.py on the port's ``BlockPool``, and the same alloc/free
churn through both packages' pools giving the same block ids.

- alloc/free round-trip: every freed block is reusable, capacity conserved;
- no double-assignment under arbitrary churn;
- exhaustion is ``Backpressure`` (the port's class), allocating nothing;
- block 0 is the NULL block and is never handed out;
- duplicate ids in one free, double frees and foreign ids raise
  ``ValueError`` with the pool unchanged;
- the block-table gather reassembles exactly the contiguous token line at
  every block size, dividing ``max_len`` or not.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import Backpressure as JaxBackpressure
from repro.serve import BlockPool as JaxBlockPool
from repro_torch.serve import NULL_BLOCK, Backpressure, BlockPool


def test_null_block_reserved():
    pool = BlockPool(4, 8)
    got = pool.alloc(4)
    assert NULL_BLOCK not in got
    assert sorted(got) == [1, 2, 3, 4]


def test_blocks_for_ceil_division():
    pool = BlockPool(8, 4)
    assert [pool.blocks_for(t) for t in (1, 3, 4, 5, 8, 9)] == [1, 1, 1, 2, 2, 3]


def test_exhaustion_is_backpressure_and_atomic():
    pool = BlockPool(4, 8)
    pool.alloc(2)
    with pytest.raises(Backpressure):
        pool.alloc(3)
    assert pool.available == 2  # untouched by the failed alloc
    pool.alloc(2)
    assert pool.available == 0


def test_double_free_and_foreign_ids_rejected():
    pool = BlockPool(4, 8)
    blocks = pool.alloc(2)
    pool.free(blocks)
    with pytest.raises(ValueError, match="unallocated"):
        pool.free(blocks)
    with pytest.raises(ValueError, match="unallocated"):
        pool.free([NULL_BLOCK])  # the null block is never owned
    with pytest.raises(ValueError):
        BlockPool(0, 8)
    with pytest.raises(ValueError):
        BlockPool(4, 0)
    with pytest.raises(ValueError):
        pool.alloc(-1)


def test_duplicate_ids_in_one_free_atomic():
    pool = BlockPool(4, 8)
    blocks = pool.alloc(3)
    with pytest.raises(ValueError, match="duplicate"):
        pool.free([blocks[0], blocks[1], blocks[0]])
    assert pool.available == 1  # nothing was freed by the failed call
    pool.free(blocks)
    assert pool.available == 4


@settings(max_examples=60, deadline=None)
@given(num_blocks=st.integers(1, 24), block_size=st.integers(1, 16),
       seed=st.integers(0, 2**16))
def test_churn_never_double_assigns_and_matches_jax(num_blocks, block_size, seed):
    """Random alloc/free churn through both pools: the same block ids, the
    same ``Backpressure`` verdicts, live requests never share a block, and
    capacity is conserved."""
    rng = np.random.default_rng(seed)
    pool, jpool = BlockPool(num_blocks, block_size), JaxBlockPool(num_blocks, block_size)
    live: list[list[int]] = []
    for _ in range(60):
        if live and rng.random() < 0.45:
            blocks = live.pop(int(rng.integers(0, len(live))))
            pool.free(blocks)
            jpool.free(blocks)
        else:
            want = int(rng.integers(1, num_blocks + 1))
            try:
                got = pool.alloc(want)
            except Backpressure:
                assert want > pool.available
                with pytest.raises(JaxBackpressure):
                    jpool.alloc(want)
            else:
                assert got == jpool.alloc(want)
                live.append(got)
        held = [b for blocks in live for b in blocks]
        assert len(held) == len(set(held)), "block double-assigned"
        assert NULL_BLOCK not in held
        assert pool.available == jpool.available == num_blocks - len(held)
    for blocks in live:
        pool.free(blocks)
    assert pool.available == num_blocks


@settings(max_examples=60, deadline=None)
@given(block_size=st.integers(1, 12), max_len=st.integers(4, 48),
       batch=st.integers(1, 4), seed=st.integers(0, 2**16))
def test_block_table_gather_matches_contiguous(block_size, max_len, batch, seed):
    """pool[table].reshape(b, -1)[:, :len] == the contiguous line at every
    block size, including sizes that do NOT divide max_len."""
    rng = np.random.default_rng(seed)
    max_blocks = -(-max_len // block_size)
    pool = BlockPool(batch * max_blocks, block_size)
    store = np.zeros((1 + pool.num_blocks, block_size), np.int64)
    tables = np.zeros((batch, max_blocks), np.int32)
    lines, lens = [], []
    for lane in range(batch):
        n = int(rng.integers(1, max_len + 1))
        line = rng.integers(1, 10**6, size=n)
        blocks = pool.alloc(pool.blocks_for(n))
        tables[lane, :len(blocks)] = blocks
        padded = np.zeros((len(blocks) * block_size,), np.int64)
        padded[:n] = line
        store[blocks] = padded.reshape(len(blocks), block_size)
        lines.append(line)
        lens.append(n)
    gathered = store[tables].reshape(batch, -1)
    for lane in range(batch):
        np.testing.assert_array_equal(gathered[lane, :lens[lane]], lines[lane])
    assert np.all(store[NULL_BLOCK] == 0)  # null block never written
