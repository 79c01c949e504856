"""The port's feed prefetch pipeline (mirroring tests/test_prefetch.py):
``PrefetchPlan`` validation; ``FeedPrefetcher`` yields every row in order at
every (depth, staleness, chunk), transfers on the caller thread at
staleness 0 and on one transfer thread above, bounds stage 1's run-ahead,
surfaces errors at the consumer and drains on ``close()``; the data plane's
``grid_stream`` resumes mid-epoch; and a pipelined ``fit`` at staleness 0
and 1 is bit-identical to the synchronous ``fit``, from the start and
resumed from a mid-epoch checkpoint.  The side-stream copy of staleness
>= 1 on a card is held in tests/test_torch_cuda.py."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import WindowSpec
from repro_torch.data import make_traffic_series
from repro_torch.distributed import checkpoint_meta
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import (FeedPrefetcher, PipelineConfig, PrefetchPlan,
                                  build_dataplane, build_pipeline)
from repro_torch.train import TrainLoopConfig
from repro_torch.tree import tree_leaves


def test_plan_defaults_and_validation():
    plan = PrefetchPlan()
    assert (plan.depth, plan.staleness, plan.chunk) == (2, 0, 8)
    with pytest.raises(ValueError, match="depth"):
        PrefetchPlan(depth=0)
    with pytest.raises(ValueError, match="staleness"):
        PrefetchPlan(staleness=-1)
    with pytest.raises(ValueError, match="chunk"):
        PrefetchPlan(chunk=0)


def _blocks(n_rows: int, chunk: int, width: int = 3):
    """A grid_stream-shaped iterator: [<=chunk, width] blocks of row ids."""
    grid = np.arange(n_rows * width).reshape(n_rows, width)
    for lo in range(0, n_rows, chunk):
        yield grid[lo:lo + chunk]


@pytest.mark.parametrize("staleness", [0, 1, 3])
@pytest.mark.parametrize("depth,chunk", [(1, 1), (2, 4), (3, 7)])
def test_yields_every_row_in_order(staleness, depth, chunk):
    n_rows = 17  # not a multiple of any chunk above
    got = list(FeedPrefetcher(_blocks(n_rows, chunk), lambda row: row * 10,
                              PrefetchPlan(depth=depth, staleness=staleness, chunk=chunk)))
    assert np.array_equal(np.stack(got), np.arange(n_rows * 3).reshape(n_rows, 3) * 10)


@pytest.mark.parametrize("staleness", [1, 2])
def test_host_rows_land_on_the_device_at_staleness_1_and_above(staleness):
    """With ``device=`` the transfer thread turns each host row into a
    tensor there (on the CPU with no stream)."""
    got = list(FeedPrefetcher(_blocks(9, 4), lambda row: row.astype(np.int32),
                              PrefetchPlan(staleness=staleness), device="cpu"))
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.int32 for t in got)
    assert np.array_equal(torch.stack(got).numpy(), np.arange(27).reshape(9, 3))


@pytest.mark.parametrize("staleness,same_thread", [(0, True), (1, False)])
def test_transfer_thread_matches_staleness_contract(staleness, same_thread):
    idents = set()

    def transfer(row):
        idents.add(threading.get_ident())
        return row

    list(FeedPrefetcher(_blocks(6, 2), transfer, PrefetchPlan(staleness=staleness)))
    assert (threading.get_ident() in idents) == same_thread
    assert len(idents) == 1


def test_host_stage_runahead_bounded_by_depth():
    pulled = [0]

    def counting_blocks():
        for b in _blocks(100, 1):
            pulled[0] += 1
            yield b

    depth = 3
    pf = FeedPrefetcher(counting_blocks(), lambda r: r,
                        PrefetchPlan(depth=depth, staleness=0, chunk=1))
    deadline = time.monotonic() + 2.0
    while pulled[0] < depth + 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)  # would overshoot here if the bound were broken
    assert pulled[0] == depth + 1
    pf.close()
    assert pulled[0] <= depth + 2


@pytest.mark.parametrize("staleness", [0, 1])
def test_source_and_transfer_errors_surface_at_consumer(staleness):
    def broken():
        yield np.zeros((2, 3), np.int32)
        raise RuntimeError("feed exploded")

    with pytest.raises(RuntimeError, match="feed exploded"):
        list(FeedPrefetcher(broken(), lambda r: r, PrefetchPlan(staleness=staleness)))

    def bad_transfer(row):
        raise ValueError("transfer exploded")

    with pytest.raises(ValueError, match="transfer exploded"):
        list(FeedPrefetcher(_blocks(4, 2), bad_transfer, PrefetchPlan(staleness=staleness)))


@pytest.mark.parametrize("staleness", [0, 2])
def test_close_is_idempotent_and_closes_source(staleness):
    closed = []

    def tracked():
        try:
            yield from _blocks(50, 2)
        finally:
            closed.append(True)

    pf = FeedPrefetcher(tracked(), lambda r: r, PrefetchPlan(staleness=staleness))
    next(pf)  # the pipeline is live
    pf.close()
    pf.close()  # a second drain is a no-op, not an error
    assert closed == [True]
    with pytest.raises(StopIteration):
        next(pf)
    for t in (pf._host_thread, pf._dev_thread):
        assert t is None or not t.is_alive()


# --------------------------------------------------- the data plane and fit
NODES, ENTRIES, B = 3, 120, 4
SPEC = WindowSpec(horizon=2, input_len=2)


def _plane():
    return build_dataplane(make_traffic_series(ENTRIES, NODES), SPEC,
                           PipelineConfig(batch_per_rank=B, seed=7, device="cpu"))


def test_grid_stream_resumes_mid_epoch_and_transfers_select_the_mode():
    dp = _plane()
    grid = dp.epoch_grid(3)
    assert np.array_equal(grid, dp.epoch_global(3))
    assert np.array_equal(np.concatenate(list(dp.grid_stream(3, start=2, chunk=3))),
                          grid[2:])
    assert np.array_equal(np.concatenate(list(dp.feed_stream(0, 3, chunk=5))),
                          dp.feed(0, 3))
    assert dp.prefetch_transfer(0) == dp.batch_of_starts
    assert dp.can_defer_transfer() and dp.prefetch_transfer(1) == dp.host_batch_of_starts
    host = dp.host_batch_of_starts(grid[0])
    assert host.dtype == np.int32
    assert np.array_equal(host, dp.batch_of_starts(grid[0]).numpy())


def _loss_fn(p, x, y):
    pred = x[:, -1] * p["w"]
    return torch.mean((pred - y[:, 0]) ** 2), {}


def _fit(depth, stale, *, chunk=8, ckpt_dir=None):
    pipe = build_pipeline(
        make_traffic_series(ENTRIES, NODES), SPEC, _loss_fn,
        {"w": torch.full((NODES, 2), 0.1)},
        PipelineConfig(batch_per_rank=B, seed=7, adam=AdamConfig(lr=1e-2), device="cpu",
                       loop=TrainLoopConfig(epochs=2, log_every=1, eval_every=0,
                                            prefetch_depth=depth, staleness=stale,
                                            prefetch_chunk=chunk, ckpt_dir=ckpt_dir,
                                            ckpt_every=5)))
    state, hist = pipe.fit(eval_fn=None)
    return state, [(h["step"], h["loss"]) for h in hist if "epoch_time_s" not in h]


@pytest.mark.parametrize("stale,chunk", [(0, 8), (0, 3), (1, 8), (2, 5)])
def test_pipelined_fit_bit_identical_to_synchronous(stale, chunk):
    ref_state, ref_losses = _fit(0, 0)
    state, losses = _fit(2, stale, chunk=chunk)
    assert losses == ref_losses and len(losses) > 20
    for a, b in zip(tree_leaves(ref_state), tree_leaves(state)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


@pytest.mark.parametrize("stale", [0, 1])
def test_pipelined_resume_mid_epoch_is_bit_identical(tmp_path, stale):
    """A resume from a mid-epoch checkpoint streams the epoch's suffix
    through the prefetcher (grid_stream(start=done))."""
    ref_state, ref_losses = _fit(0, 0, ckpt_dir=str(tmp_path / "ref"))
    # resume from the reference run's step-35 checkpoint: 15 of epoch 1's 20
    mid, run = 35, tmp_path / "run"
    run.mkdir()
    (tmp_path / "ref" / f"step_{mid:010d}").rename(run / f"step_{mid:010d}")
    assert checkpoint_meta(str(run)) == {"epoch": 1, "done_in_epoch": 15}
    state, losses = _fit(2, stale, ckpt_dir=str(run))
    assert losses == [r for r in ref_losses if r[0] > mid]
    for a, b in zip(tree_leaves(ref_state), tree_leaves(state)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
