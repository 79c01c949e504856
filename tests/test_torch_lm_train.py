"""LM training in the port: the ``lm`` gather, bit-equal to the JAX
package's ``lm_window_batch``; the pipeline on an int32 token stream through
every place that resolves a gather by name (the data plane's train step,
``evaluate``, the feed prefetcher at staleness 0 and 1, the lock-step
simulation of a time-sharded world); and ``rwkv6-1.6b`` through
``repro_torch.launch.train.main(["--smoke", ...])`` against the JAX
launcher's history under both ``--shuffle`` settings (the other archs:
tests/test_torch_lm_launcher.py).

The launcher check and its tolerances are ``tests/lm_parity.py``'s
``launcher_history_matches_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.batching import gather_x_batch as jax_gather_x
from repro.core.batching import lm_window_batch as jax_lm_window_batch
from repro.models.lm import model as jm
from repro.pipeline.gathers import lm_gather as jax_lm_gather
from repro_torch.configs import get_arch
from repro_torch.core import IndexDataset, Placement, WindowSpec
from repro_torch.core.batching import gather_x_batch, lm_window_batch
from repro_torch.data import make_token_stream
from lm_parity import launcher_history_matches_jax
from repro_torch.interop import params_from_jax
from repro_torch.models.lm import model as tm
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.pipeline.gathers import resolve_gather, split_windows
from repro_torch.train import TrainLoopConfig

SEQ = 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The smoke steps are far too small to share among threads, and the
    tier-1 run puts several test workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -------------------------------------------------------------------- gather
def _stream_and_starts(seed=0, n=60, vocab=50):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, vocab, n).astype(np.int32)
    # in range, at both ends, and out of range on both sides (placed as
    # dynamic_slice places them)
    starts = np.array([0, 3, n - SEQ - 1, n - SEQ, n, -2, 17, 44], np.int32)
    return stream, starts


def test_lm_gather_is_bit_equal_to_lm_window_batch():
    stream, starts = _stream_and_starts()
    jx, jy = jax_lm_window_batch(jnp.asarray(stream), jnp.asarray(starts), seq_len=SEQ)
    tx, ty = lm_window_batch(torch.as_tensor(stream), torch.as_tensor(starts), seq_len=SEQ)
    assert tx.dtype == torch.int32 and tx.shape == (len(starts), SEQ)
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    gx, gy = resolve_gather("lm")(torch.as_tensor(stream), torch.as_tensor(starts),
                                  input_len=SEQ, horizon=1)
    jgx, jgy = jax_lm_gather(jnp.asarray(stream), jnp.asarray(starts), input_len=SEQ,
                             horizon=1)
    assert np.array_equal(gx.numpy(), np.asarray(jgx))
    assert np.array_equal(gy.numpy(), np.asarray(jgy))


def test_gather_x_batch_is_bit_equal_to_jax():
    stream, starts = _stream_and_starts(1)
    series = np.random.default_rng(2).standard_normal((60, 3)).astype(np.float32)
    for s in (stream, series):
        got = gather_x_batch(torch.as_tensor(s), torch.as_tensor(starts), length=SEQ + 1)
        want = jax_gather_x(jnp.asarray(s), jnp.asarray(starts), length=SEQ + 1)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_split_windows_cuts_whole_windows_as_each_gather_does():
    """The exchange assembles whole windows (of starts in range, checked on
    the host); the split is the gather's own."""
    stream, starts = _stream_and_starts(3)
    starts = starts[(starts >= 0) & (starts <= len(stream) - SEQ - 1)]
    t = torch.as_tensor(stream)
    whole = gather_x_batch(t, torch.as_tensor(starts), length=SEQ + 1)
    for name in ("lm", "slice"):
        want = resolve_gather(name)(t, torch.as_tensor(starts), input_len=SEQ, horizon=1)
        got = split_windows(name, whole, SEQ)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------------ pipeline
@pytest.fixture(scope="module")
def lm_setup():
    cfg = get_arch("qwen1.5-4b").smoke_config()
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                     jax_get_arch("qwen1.5-4b").smoke_config()))
    stream = make_token_stream(240, cfg.vocab, seed=0)
    return cfg, params_from_jax(jparams, device="cpu"), stream


def _lm_pipe(lm_setup, *, world=None, placement=Placement.REPLICATED, **loop):
    cfg, params, stream = lm_setup
    spec = WindowSpec(horizon=1, input_len=SEQ)
    ds = dataclasses.replace(IndexDataset.from_raw(stream, spec, scale_feature=None),
                             series=stream)
    return build_pipeline(
        stream, spec, lambda p, x, y: tm.loss_fn(p, cfg, x, y), params,
        PipelineConfig(batch_per_rank=4, placement=placement, partition="count",
                       gather="lm", seed=0, world=world, adam=AdamConfig(lr=1e-3),
                       loop=TrainLoopConfig(epochs=1, log_every=1, **loop), device="cpu"),
        dataset=ds)


def _losses(history):
    return [h["loss"] for h in history if "val_loss" not in h and "epoch_time_s" not in h]


def test_lm_pipeline_is_bit_identical_through_the_prefetcher(lm_setup):
    """The ``lm`` gather fused into the train step, on the synchronous feed
    path and through the prefetcher at staleness 0 and 1: the same losses,
    bit for bit, and the same val loss through ``evaluate``."""
    runs = {}
    for depth, stale in ((0, 0), (2, 0), (2, 1)):
        pipe = _lm_pipe(lm_setup, prefetch_depth=depth, staleness=stale)
        state, hist = pipe.fit(eval_fn=None)
        runs[(depth, stale)] = (_losses(hist), pipe.evaluate(state["params"], split="val"))
        assert pipe.describe()["resident_rows"] == (0, 240)
        assert pipe.dataset.series.dtype == torch.int32
    (l0, v0), *rest = runs.values()
    assert len(l0) > 10 and all(np.isfinite(l0)) and np.isfinite(v0)
    for losses, val in rest:
        assert losses == l0 and val == v0


def test_lm_pipeline_on_time_shards_in_one_process(lm_setup):
    """``--shuffle local-batch``'s placement, PARTITIONED with the count
    split, as the lock-step simulation of a world of 2: each rank keeps its
    own rows of the int32 stream, and the losses are finite."""
    pipe = _lm_pipe(lm_setup, world=2, placement=Placement.PARTITIONED)
    state, hist = pipe.fit(eval_fn=None)
    assert all(np.isfinite(_losses(hist)))
    assert np.isfinite(pipe.evaluate(state["params"], split="test"))


# --------------------------------------------------------------- the launcher
@pytest.mark.parametrize("shuffle", ["global", "local-batch"])
def test_rwkv6_history_matches_the_jax_launcher(tmp_path, monkeypatch, shuffle):
    launcher_history_matches_jax(tmp_path, monkeypatch, "rwkv6-1.6b", shuffle)
