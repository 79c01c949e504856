"""Port parity for A3T-GCN, the paper's §5.5 model: the parameter tree,
forward, MSE loss and every gradient leaf against ``jax.value_and_grad``,
Table 6's base and index arms in the port, and ``build_pipeline``
trajectories and ``evaluate`` against the JAX package's ``build_pipeline``
under each placement — with bridged parameters and seeded numpy inputs, in
float32 on the CPU, at test_torch_dcrnn.py's tolerance (atol 1e-5,
rtol 1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Placement as JPlacement
from repro.core import WindowSpec as JWindowSpec
from repro.launch.mesh import make_host_mesh
from repro.models import a3tgcn as jm
from repro.optim import AdamConfig as JAdam
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jax_build_pipeline
from repro.train import TrainLoopConfig as JLoop
from repro_torch.core import IndexDataset, Placement, WindowSpec
from repro_torch.core.batching import materialize_windows
from repro_torch.data import (gaussian_adjacency, make_traffic_series,
                              random_sensor_coords, sym_norm_adjacency)
from repro_torch.interop import params_from_jax
from repro_torch.models import a3tgcn as tm
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.train import TrainLoopConfig
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_paths

ATOL, RTOL = 1e-5, 1e-4
NODES, HORIZON, HIDDEN, BATCH, ENTRIES, LR = 16, 4, 8, 8, 300, 5e-3
CFG = dict(num_nodes=NODES, in_features=2, hidden=HIDDEN, input_len=HORIZON,
           horizon=HORIZON)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    a_hat = sym_norm_adjacency(gaussian_adjacency(random_sensor_coords(NODES)))
    x = rng.standard_normal((3, HORIZON, NODES, 2)).astype(np.float32)
    y = rng.standard_normal((3, HORIZON, NODES, 2)).astype(np.float32)
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0), jm.A3TGCNConfig(**CFG)))
    return a_hat.astype(np.float32), x, y, jparams


def _close(got, want, path=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=path)


def _jax_paths(tree):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_init_tree_matches_jax(setup):
    *_, jparams = setup
    tparams = tm.init(torch.Generator().manual_seed(0), tm.A3TGCNConfig(**CFG),
                      device="cpu")
    assert tree_paths(tparams) == _jax_paths(jparams)
    assert [tuple(t.shape) for t in tree_leaves(tparams)] == \
        [a.shape for a in jax.tree.leaves(jparams)]
    # the initialisation rules: zero biases but gcn_ru.b2, which is ones
    assert torch.equal(tparams["gcn_ru"]["b2"], torch.ones(2 * HIDDEN))
    for path, leaf in zip(tree_paths(tparams), tree_leaves(tparams)):
        if path.endswith(("b", "b1")) or path == "gcn_c/b2":
            assert not leaf.any(), path


def test_default_device_is_cuda_and_never_falls_back():
    gen, cfg = torch.Generator().manual_seed(0), tm.A3TGCNConfig(**CFG)
    if torch.cuda.is_available():
        assert tm.init(gen, cfg)["proj"]["w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init(gen, cfg)


def test_apply_and_loss_match_jax(setup):
    a_hat, x, y, jparams = setup
    jcfg, tcfg = jm.A3TGCNConfig(**CFG), tm.A3TGCNConfig(**CFG)
    tparams = params_from_jax(jparams, device="cpu")
    with torch.no_grad():
        pred = tm.apply(tparams, tcfg, torch.as_tensor(a_hat), torch.as_tensor(x))
        loss = tm.loss_fn(tparams, tcfg, torch.as_tensor(a_hat), torch.as_tensor(x),
                          torch.as_tensor(y))
    assert pred.shape == (3, HORIZON, NODES, 1)
    _close(pred.numpy(), jm.apply(jparams, jcfg, jnp.asarray(a_hat), jnp.asarray(x)))
    _close(float(loss), float(jm.loss_fn(jparams, jcfg, jnp.asarray(a_hat),
                                         jnp.asarray(x), jnp.asarray(y))))


def test_every_gradient_leaf_matches_jax(setup):
    a_hat, x, y, jparams = setup
    jcfg, tcfg = jm.A3TGCNConfig(**CFG), tm.A3TGCNConfig(**CFG)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        jparams, jcfg, jnp.asarray(a_hat), jnp.asarray(x), jnp.asarray(y))
    tparams = params_from_jax(jparams, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tloss = tm.loss_fn(tparams, tcfg, torch.as_tensor(a_hat), torch.as_tensor(x),
                       torch.as_tensor(y))
    grads = torch.autograd.grad(tloss, leaves)
    _close(float(tloss.detach()), float(jloss))
    for path, g, jg in zip(tree_paths(tparams), grads, jax.tree.leaves(jgrads)):
        _close(g.numpy(), jg, path)


def _data():
    raw = make_traffic_series(ENTRIES, NODES)
    a_hat = sym_norm_adjacency(gaussian_adjacency(random_sensor_coords(NODES)))
    return raw, a_hat.astype(np.float32)


def test_table6_base_and_index_arms_give_equal_losses(setup):
    """Table 6 in the port: the same 3 batches of window ids through the
    index-batched pipeline (gather from the resident series) and through
    ``make_train_step`` over the materialised windows give the same losses
    and parameters bit for bit: the gather is exact."""
    *_, jparams = setup
    raw, a_hat = _data()
    cfg, spec = tm.A3TGCNConfig(**CFG), WindowSpec(horizon=HORIZON)
    ta = torch.as_tensor(a_hat)
    params = params_from_jax(jparams, device="cpu")
    ds = IndexDataset.from_raw(raw, spec)
    ds = dataclasses.replace(ds, train_windows=ds.train_windows[:3 * BATCH])
    adam = AdamConfig(lr=LR)

    def loss_fn(p, x, y):
        return tm.loss_fn(p, cfg, ta, x, y), {}

    pipe = build_pipeline(None, spec, loss_fn, params, PipelineConfig(
        batch_per_rank=BATCH, gather="pallas", seed=2, device="cpu", adam=adam,
        loop=TrainLoopConfig(epochs=1, log_every=1)), dataset=ds)
    index_state, hist = pipe.fit(eval_fn=None)
    index_losses = [h["loss"] for h in hist if "epoch_time_s" not in h]

    xs, ys = (torch.as_tensor(a) for a in materialize_windows(
        np.asarray(ds.series), ds.starts, HORIZON, HORIZON))

    def loss_base(p, ids):
        return tm.loss_fn(p, cfg, ta, xs[ids], ys[ids]), {}

    step = make_train_step(loss_base, adam, lambda s: LR)
    state, base_losses = init_train_state(params, adam), []
    for ids in pipe.dataplane.epoch_global(0):
        state, m = step(state, torch.as_tensor(ids))
        base_losses.append(float(m["loss"]))
    assert len(base_losses) == 3 and base_losses == index_losses
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(index_state["params"])):
        assert torch.equal(a, b)


PLACEMENTS = [("replicated", None), ("partitioned", 2), ("ondemand", 2)]


@pytest.mark.parametrize("placement,world", PLACEMENTS)
def test_pipeline_trajectory_and_evaluate_match_jax(setup, placement, world):
    """One epoch of ``build_pipeline(...).fit()`` in both packages on the
    same data, parameters and feeds (the sharded placements as two
    lock-step ranks in one process), then ``evaluate`` of both splits."""
    *_, jparams = setup
    raw, a_hat = _data()
    jcfg, tcfg = jm.A3TGCNConfig(**CFG), tm.A3TGCNConfig(**CFG)
    ja, ta = jnp.asarray(a_hat), torch.as_tensor(a_hat)

    def jloss(p, x, y):
        return jm.loss_fn(p, jcfg, ja, x, y), {}

    def tloss(p, x, y):
        return tm.loss_fn(p, tcfg, ta, x, y), {}

    jpipe = jax_build_pipeline(
        raw, JWindowSpec(horizon=HORIZON), make_host_mesh(), jloss, jparams,
        JPipelineConfig(batch_per_rank=BATCH, placement=JPlacement(placement),
                        world=world, gather="pallas", seed=3, adam=JAdam(lr=LR),
                        loop=JLoop(epochs=1, log_every=1)))
    jstate, jhist = jpipe.fit(eval_fn=None)
    tpipe = build_pipeline(
        raw, WindowSpec(horizon=HORIZON), tloss, params_from_jax(jparams, device="cpu"),
        PipelineConfig(batch_per_rank=BATCH, placement=Placement(placement),
                       world=world, gather="pallas", seed=3, device="cpu",
                       adam=AdamConfig(lr=LR), loop=TrainLoopConfig(epochs=1, log_every=1)))
    tstate, thist = tpipe.fit(eval_fn=None)
    assert tpipe.describe()["sampler"] == jpipe.describe()["sampler"]
    assert np.array_equal(tpipe.dataplane.epoch_global(0), jpipe.dataplane.epoch_global(0))
    tl = [h["loss"] for h in thist if "epoch_time_s" not in h]
    jl = [h["loss"] for h in jhist if "epoch_time_s" not in h]
    assert len(tl) == len(jl) >= 5
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    for split in ("val", "test"):
        np.testing.assert_allclose(tpipe.evaluate(tstate["params"], split=split),
                                   jpipe.evaluate(jstate["params"], split=split),
                                   rtol=RTOL)
