"""Port parity: data, windows, IndexDataset and samplers are bit-equal to the
JAX package's for the same seeds (both packages fed the same numpy inputs)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.core import windows as jwin
from repro.core.index_dataset import IndexDataset as JIndexDataset
from repro.core.sampler import GlobalShuffleSampler as JSampler
from repro.core.sampler import ShardInfo as JShard
from repro_torch import data as tdata
from repro_torch.core import windows as twin
from repro_torch.core.index_dataset import IndexDataset as TIndexDataset
from repro_torch.core.sampler import GlobalShuffleSampler as TSampler
from repro_torch.core.sampler import ShardInfo as TShard


@pytest.mark.parametrize("nodes,entries,features,seed", [
    (12, 200, 2, 0), (33, 150, 3, 7), (64, 97, 1, 3)])
def test_synthetic_and_graph_bit_equal(nodes, entries, features, seed):
    coords_j = jdata.random_sensor_coords(nodes, seed=seed)
    coords_t = tdata.random_sensor_coords(nodes, seed=seed)
    assert np.array_equal(coords_j, coords_t)
    adj = jdata.gaussian_adjacency(coords_j)
    assert np.array_equal(adj, tdata.gaussian_adjacency(coords_t))
    for a, b in zip(jdata.transition_matrices(adj), tdata.transition_matrices(adj)):
        assert np.array_equal(a, b)
    assert np.array_equal(jdata.sym_norm_adjacency(adj), tdata.sym_norm_adjacency(adj))
    for kw in ({}, {"adjacency": adj}):
        a = jdata.make_traffic_series(entries, nodes, features, seed=seed, **kw)
        b = tdata.make_traffic_series(entries, nodes, features, seed=seed, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jdata.make_token_stream(300, 50, seed=seed),
                          tdata.make_token_stream(300, 50, seed=seed))


def test_registry_and_window_math_equal():
    assert {k: dataclasses.asdict(v) for k, v in jdata.TABLE1.items()} == \
           {k: dataclasses.asdict(v) for k, v in tdata.TABLE1.items()}
    for entries, h, il, stride in [(100, 12, None, 1), (57, 4, 6, 3), (10, 8, 8, 1)]:
        js, ts = jwin.WindowSpec(h, il, stride), twin.WindowSpec(h, il, stride)
        for counting in ("exact", "paper", "table"):
            assert jwin.num_windows(entries, js, counting) == \
                twin.num_windows(entries, ts, counting)
            assert np.array_equal(jwin.window_starts(entries, js, counting),
                                  twin.window_starts(entries, ts, counting))
        assert jwin.materialized_bytes(entries, 7, 2, js) == \
            twin.materialized_bytes(entries, 7, 2, ts)
        assert jwin.index_batching_bytes(entries, 7, 2, js) == \
            twin.index_batching_bytes(entries, 7, 2, ts)
    for n in (0, 1, 10, 333):
        for a, b in zip(jwin.split_windows(n, 0.6, 0.2), twin.split_windows(n, 0.6, 0.2)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("scale_feature", [0, None])
def test_index_dataset_from_raw_bit_equal(scale_feature):
    raw = jdata.make_traffic_series(240, 10, 2, seed=5)
    kw = dict(train=0.6, val=0.2, scale_feature=scale_feature)
    j = JIndexDataset.from_raw(raw, jwin.WindowSpec(6, 4), **kw)
    t = TIndexDataset.from_raw(raw, twin.WindowSpec(6, 4), **kw)
    for field in ("series", "starts", "train_windows", "val_windows", "test_windows"):
        a, b = getattr(j, field), getattr(t, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (j.scaler.mean, j.scaler.std) == (t.scaler.mean, t.scaler.std)
    assert j.nbytes_index() == t.nbytes_index()
    assert j.nbytes_materialized() == t.nbytes_materialized()
    placed = t.to_device("cpu")
    assert isinstance(placed.series, torch.Tensor)
    assert np.array_equal(placed.series.numpy(), t.series)
    assert placed.nbytes_index() == t.nbytes_index()
    assert placed.nbytes_materialized() == t.nbytes_materialized()


def test_apply_scaler_device_matches_jax():
    raw = jdata.make_traffic_series(50, 6, 3, seed=2)
    sc = jdata.fit_scaler(raw, 40)
    tsc = tdata.Scaler(sc.mean, sc.std)
    for feature in (0, 2, None):
        a = np.asarray(jdata.apply_scaler_device(jnp.asarray(raw), sc, feature))
        src = torch.as_tensor(raw)
        b = tdata.apply_scaler_device(src, tsc, feature).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert np.array_equal(b, tdata.apply_scaler(raw, tsc, feature))
        assert np.array_equal(src.numpy(), raw)  # input left as it was


@pytest.mark.parametrize("n_ids,batch,world,seed", [
    (100, 8, 1, 0), (257, 5, 3, 11), (64, 4, 4, 2)])
def test_global_shuffle_feeds_bit_equal(n_ids, batch, world, seed):
    ids = np.arange(3, 3 + n_ids, dtype=np.int32)
    pool = np.arange(1000, 1000 + n_ids // 2 + 3, dtype=np.int32)
    for rank in range(world):
        j = JSampler(ids, batch, JShard(rank, world), seed=seed)
        t = TSampler(ids, batch, TShard(rank, world), seed=seed)
        assert j.steps_per_epoch == t.steps_per_epoch
        for epoch in (0, 1, 5):
            assert np.array_equal(j.feed(rank, epoch), t.feed(rank, epoch))
            assert np.array_equal(j.epoch(epoch), t.epoch(epoch))
            assert np.array_equal(j.epoch_global(epoch), t.epoch_global(epoch))
            blocks = list(t.feed_stream(rank, epoch, start=1, chunk=3))
            assert np.array_equal(np.concatenate(blocks), j.feed(rank, epoch)[1:])
        assert np.array_equal(j.eval_feed(rank, pool), t.eval_feed(rank, pool))
        assert np.array_equal(j.eval_global(pool), t.eval_global(pool))
        assert np.array_equal(j.eval_tail(pool), t.eval_tail(pool))
