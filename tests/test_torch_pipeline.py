"""The slice end to end: a quickstart-sized ``build_pipeline(...).fit()`` in
both packages on the same data, parameters and feeds, with the ``pallas``
gather on both sides (JAX in interpret mode, the port on ``device="cpu"``,
where the gather takes its kernel's plain version).  Also the sharded
placements in one process, the port's device rule and the elastic
fit's need of a checkpoint directory."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Placement as JPlacement
from repro.core import WindowSpec as JWindowSpec
from repro.data import (gaussian_adjacency, make_traffic_series,
                        random_sensor_coords, transition_matrices)
from repro.launch.mesh import make_host_mesh
from repro.models import pgt_dcrnn as jm
from repro.optim import AdamConfig as JAdam
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jax_build_pipeline
from repro.train import TrainLoopConfig as JLoop
from repro_torch.core import IndexDataset, Placement, WindowSpec
from repro_torch.interop import params_from_jax
from repro_torch.models import pgt_dcrnn as tm
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import ElasticConfig, PipelineConfig, build_pipeline
from repro_torch.train import TrainLoopConfig

NODES, ENTRIES, HORIZON, BATCH, HIDDEN, LR = 16, 300, 4, 8, 8, 5e-3
# Loss trajectory and evaluate() agree within rtol 1e-4.  Measured by
# test_fit_and_evaluate_match_jax (it prints them; run with -s) on this setup,
# 2 epochs of 25 steps, 52 logged rows, on the CPU: max relative deviation of
# the logged losses 5.6e-7; of evaluate 1.5e-7 (val) and 4.2e-7 (test), and
# 3.9e-7 (test) through the hop kernel's path.
RTOL = 1e-4


@pytest.fixture(scope="module")
def slice_setup():
    series = make_traffic_series(ENTRIES, NODES)
    adj = gaussian_adjacency(random_sensor_coords(NODES))
    sup = transition_matrices(adj)
    kw = dict(num_nodes=NODES, hidden=HIDDEN, input_len=HORIZON, horizon=HORIZON)
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0), jm.PGTDCRNNConfig(**kw)))
    return series, sup, kw, jparams


def _torch_pipe(series, sup, kw, params, *, use_pallas=False, **cfg):
    tcfg = tm.PGTDCRNNConfig(**kw, use_pallas=use_pallas)
    tsup = tuple(torch.as_tensor(s) for s in sup)

    def loss_fn(p, x, y):
        return tm.loss_fn(p, tcfg, tsup, x, y), {}

    config = dict(batch_per_rank=BATCH, gather="pallas", seed=3, device="cpu",
                  adam=AdamConfig(lr=LR), loop=TrainLoopConfig(epochs=2, log_every=1))
    config.update(cfg)
    return build_pipeline(series, WindowSpec(horizon=HORIZON), loss_fn, params,
                          PipelineConfig(**config))


def test_fit_and_evaluate_match_jax(slice_setup):
    series, sup, kw, jparams = slice_setup
    jcfg = jm.PGTDCRNNConfig(**kw)
    jsup = tuple(jnp.asarray(s) for s in sup)

    def jloss(p, x, y):
        return jm.loss_fn(p, jcfg, jsup, x, y), {}

    jpipe = jax_build_pipeline(
        series, JWindowSpec(horizon=HORIZON), make_host_mesh(), jloss, jparams,
        JPipelineConfig(batch_per_rank=BATCH, gather="pallas", seed=3,
                        adam=JAdam(lr=LR), loop=JLoop(epochs=2, log_every=1)))
    jstate, jhist = jpipe.fit()

    tpipe = _torch_pipe(series, sup, kw, params_from_jax(jparams, device="cpu"))
    tstate, thist = tpipe.fit()

    assert tpipe.steps_per_epoch == jpipe.steps_per_epoch >= 10
    assert [h.keys() for h in thist] == [h.keys() for h in jhist]

    def rel(ours, theirs):
        ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
        return float(np.max(np.abs(ours - theirs) / np.abs(theirs)))

    tl = [h["loss"] for h in thist]
    devs = {key: rel([h[key] for h in thist if key in h],
                     [h[key] for h in jhist if key in h])
            for key in ("loss", "grad_norm", "val_mae")}
    for split in ("val", "test"):
        devs[f"evaluate {split}"] = rel(tpipe.evaluate(tstate["params"], split=split),
                                        jpipe.evaluate(jstate["params"], split=split))
    # the forecast through the hop kernel's path scores the same windows
    fpipe = _torch_pipe(series, sup, kw, tstate["params"], use_pallas=True)
    devs["evaluate test, use_pallas"] = rel(
        fpipe.evaluate(tstate["params"], split="test"),
        jpipe.evaluate(jstate["params"], split="test"))
    print(f"max relative deviation from the JAX package over {len(tl)} rows: {devs}")
    assert all(d <= RTOL for d in devs.values()), devs
    assert tl[-1] < tl[0]  # it trains


def test_pipeline_surface_and_ragged_eval_tail(slice_setup):
    series, sup, kw, jparams = slice_setup
    pipe = _torch_pipe(series, sup, kw, params_from_jax(jparams, device="cpu"),
                       gather="slice", batch_per_rank=7)
    d = pipe.describe()
    assert d["placement"] is Placement.REPLICATED and d["device"] == "cpu"
    assert d["global_batch"] == 7 and pipe.world == 1
    rows, tail = pipe.dataplane.eval_grid("val")
    pool = pipe.dataplane.eval_pool("val")
    assert np.array_equal(np.concatenate([rows.ravel(), tail]), pool) and len(tail)
    starts = pipe.batch_of_starts(rows[0])
    assert starts.dtype == torch.int32 and starts.device.type == "cpu"
    params = pipe.init_params
    # every chunk plus the tail, window-weighted, equals one big batch
    full = pipe.evaluate(params, split="val", max_batches=10**6)
    with torch.no_grad():
        one, _ = pipe._eval_loss(params, pipe.batch_of_starts(pool))
    np.testing.assert_allclose(full, float(one), rtol=1e-5)
    assert pipe.dataplane.eval_tail_batch("val") is pipe.dataplane.eval_tail_batch("val")


def test_default_device_is_cuda_and_never_falls_back(slice_setup):
    series, sup, kw, jparams = slice_setup
    spec = WindowSpec(horizon=HORIZON)
    ds = IndexDataset.from_raw(series, spec)
    cfg = tm.PGTDCRNNConfig(**kw)
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert ds.to_device().series.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline(series, spec, lambda p, x, y: (x.sum(), {}), {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.to_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init(gen, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(jparams)


@pytest.mark.parametrize("placement", [Placement.PARTITIONED, Placement.ONDEMAND])
def test_sharded_placements_in_one_process_match_jax(slice_setup, placement):
    """One process is one rank: it keeps every row, trains the placement's
    feed and issues no collective, as the JAX package's one-device mesh."""
    series, sup, kw, jparams = slice_setup
    jcfg = jm.PGTDCRNNConfig(**kw)
    jsup = tuple(jnp.asarray(s) for s in sup)

    def jloss(p, x, y):
        return jm.loss_fn(p, jcfg, jsup, x, y), {}

    jpipe = jax_build_pipeline(
        series, JWindowSpec(horizon=HORIZON), make_host_mesh(), jloss, jparams,
        JPipelineConfig(batch_per_rank=BATCH, placement=JPlacement(placement.value),
                        gather="pallas", seed=3, adam=JAdam(lr=LR),
                        loop=JLoop(epochs=1, log_every=1)))
    jstate, jhist = jpipe.fit()
    tpipe = _torch_pipe(series, sup, kw, params_from_jax(jparams, device="cpu"),
                        placement=placement, loop=TrainLoopConfig(epochs=1, log_every=1))
    tstate, thist = tpipe.fit()
    d = tpipe.describe()
    assert d["sampler"] == jpipe.describe()["sampler"] and d["world"] == 1
    assert d["resident_rows"] == (0, ENTRIES)
    assert np.array_equal(tpipe.dataplane.epoch_global(0), jpipe.dataplane.epoch_global(0))
    for key in ("loss", "val_mae"):
        np.testing.assert_allclose([h[key] for h in thist if key in h],
                                   [h[key] for h in jhist if key in h], rtol=RTOL)
    np.testing.assert_allclose(tpipe.evaluate(tstate["params"], split="test"),
                               jpipe.evaluate(jstate["params"], split="test"), rtol=RTOL)


def test_elastic_raises(slice_setup):
    """An elastic fit needs ``loop.ckpt_dir`` (the re-mesh restores from it),
    as JAX tests/test_elastic_engine.py holds."""
    series, sup, kw, jparams = slice_setup
    pipe = build_pipeline(series, WindowSpec(horizon=HORIZON),
                          lambda p, x, y: ((x.sum() * p["w"]).sum(), {}),
                          {"w": torch.ones(1)}, PipelineConfig(device="cpu", world=4),
                          elastic=ElasticConfig(clock=lambda: 0.0))
    with pytest.raises(ValueError, match="ckpt_dir"):
        pipe.fit(eval_fn=None)
