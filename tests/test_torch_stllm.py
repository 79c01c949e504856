"""Port parity for ST-LLM, the paper's §5.5 scaling-study model, and for the
LM ``backbone`` it runs its node tokens through: the parameter tree,
``backbone`` (remat off and on), ``apply`` with and without ``tod_index``,
the MAE loss and every gradient leaf against ``jax.value_and_grad`` — where
``tod``, ``backbone.embed`` and ``backbone.lm_head`` get exactly zero — the
train step on a loss that leaves leaves unused, a 3-step ``build_pipeline``
trajectory with its checkpoint, and the blockwise-attention graphs: both
packages where 512 divides N; where it does not, the JAX package refuses
and the port's ragged last chunk equals full attention, with gradients.  Bridged parameters and seeded numpy inputs, float32
on the CPU, at test_torch_dcrnn.py's tolerance (atol 1e-5, rtol 1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexDataset as JIndexDataset
from repro.core import WindowSpec as JWindowSpec
from repro.distributed import restore as jax_restore
from repro.launch.mesh import make_host_mesh
from repro.models import stllm as jm
from repro.models.lm import model as jlm
from repro.optim import AdamConfig as JAdam
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jax_build_pipeline
from repro.train import TrainLoopConfig as JLoop
from repro.train.loop import init_train_state as jax_init_train_state
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.core import IndexDataset, WindowSpec
from repro_torch.data import make_traffic_series
from repro_torch.interop import params_from_jax
from repro_torch.models import stllm as tm
from repro_torch.models.lm import model as tlm
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.train import TrainLoopConfig
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

ATOL, RTOL = 1e-5, 1e-4
NODES, HORIZON, BATCH, ENTRIES, LR = 16, 4, 8, 300, 1e-3
CFG = dict(num_nodes=NODES, in_features=2, out_features=1, input_len=HORIZON,
           horizon=HORIZON, d_model=32, layers=2, n_heads=4, d_ff=64)
#: the leaves no ST-LLM loss reads: no tod_index, no token embedding, no logits
UNUSED = ("backbone/embed", "backbone/lm_head/w", "tod")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, HORIZON, NODES, 2)).astype(np.float32)
    y = rng.standard_normal((3, HORIZON, NODES, 2)).astype(np.float32)
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0), jm.STLLMConfig(**CFG)))
    return x, y, jparams


def _close(got, want, path=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=path)


def _jax_paths(tree):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_init_tree_matches_jax(setup):
    *_, jparams = setup
    tparams = tm.init(torch.Generator().manual_seed(0), tm.STLLMConfig(**CFG),
                      device="cpu")
    assert tree_paths(tparams) == _jax_paths(jparams)
    assert [tuple(t.shape) for t in tree_leaves(tparams)] == \
        [a.shape for a in jax.tree.leaves(jparams)]
    assert isinstance(tparams["backbone"]["stages"], list)


def test_default_device_is_cuda_and_never_falls_back():
    gen, cfg = torch.Generator().manual_seed(0), tm.STLLMConfig(**CFG)
    if torch.cuda.is_available():
        assert tm.init(gen, cfg)["head"]["w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init(gen, cfg)


@pytest.mark.parametrize("remat", [False, True])
def test_backbone_matches_jax(setup, remat):
    *_, jparams = setup
    bcfg = jm.STLLMConfig(**CFG).backbone_config()
    x = np.random.default_rng(1).standard_normal((2, NODES, 32)).astype(np.float32)
    jh, jaux = jlm.backbone(jparams["backbone"], bcfg, jnp.asarray(x), remat=remat)
    tparams = params_from_jax(jparams["backbone"], device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    th, taux = tlm.backbone(tparams, tm.STLLMConfig(**CFG).backbone_config(),
                            torch.as_tensor(x), remat=remat)
    assert th.shape == (2, NODES, 32) and th.dtype == torch.float32
    assert taux.dtype == torch.float32 and taux.shape == () and float(taux) == float(jaux)
    _close(th.detach().numpy(), jh)
    # differentiable, remat or not: the gradient of a readout matches JAX's
    w = np.random.default_rng(2).standard_normal((2, NODES, 32)).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(
        jlm.backbone(p, bcfg, jnp.asarray(x), remat=remat)[0] * w))(jparams["backbone"])
    grads = torch.autograd.grad((th * torch.as_tensor(w)).sum(), leaves,
                                allow_unused=True, materialize_grads=True)
    for path, g, jg in zip(tree_paths(tparams), grads, jax.tree.leaves(jgrads)):
        _close(g.numpy(), jg, path)


@pytest.mark.parametrize("with_tod", [False, True])
def test_apply_matches_jax(setup, with_tod):
    x, _, jparams = setup
    tod = np.array([0, 17, 287], np.int32) if with_tod else None
    want = jm.apply(jparams, jm.STLLMConfig(**CFG), jnp.asarray(x),
                    tod_index=None if tod is None else jnp.asarray(tod))
    with torch.no_grad():
        got = tm.apply(params_from_jax(jparams, device="cpu"), tm.STLLMConfig(**CFG),
                       torch.as_tensor(x),
                       tod_index=None if tod is None else torch.as_tensor(tod).long())
    assert got.shape == (3, HORIZON, NODES, 1)
    _close(got.numpy(), want)


def test_loss_and_every_gradient_leaf_match_jax(setup):
    x, y, jparams = setup
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        jparams, jm.STLLMConfig(**CFG), jnp.asarray(x), jnp.asarray(y))
    tparams = params_from_jax(jparams, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tloss = tm.loss_fn(tparams, tm.STLLMConfig(**CFG), torch.as_tensor(x),
                       torch.as_tensor(y))
    grads = torch.autograd.grad(tloss, leaves, allow_unused=True, materialize_grads=True)
    _close(float(tloss.detach()), float(jloss))
    paths = tree_paths(tparams)
    for path, g, jg in zip(paths, grads, jax.tree.leaves(jgrads)):
        _close(g.numpy(), jg, path)
        if path in UNUSED:
            assert not g.any() and not np.asarray(jg).any(), path
    assert set(UNUSED) <= set(paths)


def test_train_step_with_unused_leaves_matches_jax(setup):
    """A loss that never reads some leaves trains: their gradient is zero,
    so their AdamW moments stay zero and the leaves keep their values, as
    in the JAX package; every other leaf moves as JAX's does."""
    x, y, jparams = setup
    adam, jadam = AdamConfig(lr=LR), JAdam(lr=LR)
    jcfg, tcfg = jm.STLLMConfig(**CFG), tm.STLLMConfig(**CFG)
    xs, ys = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)

    jstep = jax_make_train_step(lambda p, i: (jm.loss_fn(p, jcfg, xs[i], ys[i]), {}),
                                jadam, lambda s: LR, donate=False)
    step = make_train_step(lambda p, i: (tm.loss_fn(p, tcfg, tx[i], ty[i]), {}),
                           adam, lambda s: LR)
    jstate = jax_init_train_state(jparams, jadam)
    state = init_train_state(params_from_jax(jparams, device="cpu"), adam)
    for ids in ([0, 1], [2, 0], [1, 2]):
        jstate, jm_ = jstep(jstate, jnp.asarray(ids))
        state, m = step(state, torch.as_tensor(ids))
        _close(float(m["loss"]), float(jm_["loss"]))
    paths = tree_paths(state["params"])
    for tree in ("params", "m", "v"):
        ours = tree_leaves(state[tree] if tree == "params" else state["opt"][tree])
        theirs = jax.tree.leaves(jstate[tree] if tree == "params" else jstate["opt"][tree])
        for path, a, b in zip(paths, ours, theirs):
            _close(a.numpy(), b, f"{tree}/{path}")
    init = dict(zip(paths, tree_leaves(params_from_jax(jparams, device="cpu"))))
    for path, p, m, v in zip(paths, tree_leaves(state["params"]),
                             tree_leaves(state["opt"]["m"]), tree_leaves(state["opt"]["v"])):
        if path in UNUSED:
            assert torch.equal(p, init[path]) and not m.any() and not v.any(), path
        else:
            assert not torch.equal(p, init[path]), path


def test_pipeline_three_steps_and_checkpoint_match_jax(setup, tmp_path):
    """3 steps of ``build_pipeline(...).fit()`` in both packages on the same
    data, parameters and feed; the port's final checkpoint, restored by the
    JAX package, holds the unused leaves as they were and zero moments."""
    *_, jparams = setup
    raw = make_traffic_series(ENTRIES, NODES)
    jcfg, tcfg = jm.STLLMConfig(**CFG), tm.STLLMConfig(**CFG)
    jds = JIndexDataset.from_raw(raw, JWindowSpec(horizon=HORIZON))
    jds = dataclasses.replace(jds, train_windows=jds.train_windows[:3 * BATCH])
    ds = IndexDataset.from_raw(raw, WindowSpec(horizon=HORIZON))
    ds = dataclasses.replace(ds, train_windows=ds.train_windows[:3 * BATCH])

    jpipe = jax_build_pipeline(
        None, JWindowSpec(horizon=HORIZON), make_host_mesh(),
        lambda p, x, y: (jm.loss_fn(p, jcfg, x, y), {}), jparams,
        JPipelineConfig(batch_per_rank=BATCH, gather="pallas", seed=3, adam=JAdam(lr=LR),
                        loop=JLoop(epochs=1, log_every=1)), dataset=jds)
    jstate, jhist = jpipe.fit(eval_fn=None)
    tpipe = build_pipeline(
        None, WindowSpec(horizon=HORIZON), lambda p, x, y: (tm.loss_fn(p, tcfg, x, y), {}),
        params_from_jax(jparams, device="cpu"),
        PipelineConfig(batch_per_rank=BATCH, gather="pallas", seed=3, device="cpu",
                       adam=AdamConfig(lr=LR),
                       loop=TrainLoopConfig(epochs=1, log_every=1, ckpt_dir=str(tmp_path))),
        dataset=ds)
    tstate, thist = tpipe.fit(eval_fn=None)
    tl = [h["loss"] for h in thist if "epoch_time_s" not in h]
    jl = [h["loss"] for h in jhist if "epoch_time_s" not in h]
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    np.testing.assert_allclose(tpipe.evaluate(tstate["params"], split="test"),
                               jpipe.evaluate(jstate["params"], split="test"), rtol=RTOL)

    restored, step = jax_restore(str(tmp_path), jstate)
    assert step == 3
    paths = tree_paths(tstate["params"])
    for tree in ("params", "m", "v"):
        got = jax.tree.leaves(restored[tree] if tree == "params" else restored["opt"][tree])
        want = jax.tree.leaves(jstate[tree] if tree == "params" else jstate["opt"][tree])
        for path, a, b in zip(paths, got, want):
            if path in UNUSED:
                assert np.array_equal(np.asarray(a), np.asarray(b)), f"{tree}/{path}"
            else:
                _close(a, b, f"{tree}/{path}")
    for path, a, b in zip(paths, jax.tree.leaves(restored["params"]),
                          jax.tree.leaves(jparams)):
        if path in UNUSED:
            assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _wide(nodes):
    kw = dict(CFG, num_nodes=nodes, layers=1)
    jcfg, tcfg = jm.STLLMConfig(**kw), tm.STLLMConfig(**kw)
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(3).standard_normal((1, HORIZON, nodes, 2)).astype(np.float32)
    return jcfg, tcfg, jparams, x


def test_blockwise_graph_matches_jax():
    """Above 2,048 nodes the backbone's attention is blockwise in chunks of
    512: at 2,560 nodes (5 chunks) both packages run it and agree."""
    jcfg, tcfg, jparams, x = _wide(2_560)
    assert 2_560 > tlm.BLOCKWISE_THRESHOLD == jlm.BLOCKWISE_THRESHOLD
    want = jm.apply(jparams, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = tm.apply(params_from_jax(jparams, device="cpu"), tcfg, torch.as_tensor(x))
    _close(got.numpy(), want)


def _blockwise_equals_full(tcfg, tparams, x, monkeypatch):
    """The port's forward and every gradient leaf at ``tcfg``'s node count,
    blockwise (the last chunk ragged where 512 does not divide N), against
    the same model with its attention forced to the full ``[N, N]`` one."""
    tx = torch.as_tensor(x)
    y = torch.as_tensor(np.random.default_rng(4).standard_normal(x.shape).astype(np.float32))

    def run():
        leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tparams)]
        params = tree_unflatten(tparams, leaves)
        pred = tm.apply(params, tcfg, tx)
        grads = torch.autograd.grad(torch.mean(torch.abs(pred - y[..., :1])), leaves,
                                    allow_unused=True, materialize_grads=True)
        return pred.detach(), grads

    blockwise = run()
    monkeypatch.setattr(tlm, "BLOCKWISE_THRESHOLD", 10 ** 9)
    full = run()
    _close(blockwise[0].numpy(), full[0].numpy())
    for path, a, b in zip(tree_paths(tparams), blockwise[1], full[1]):
        _close(a.numpy(), b.numpy(), path)


def test_graph_blockwise_attention_cannot_chunk_is_refused_by_both(monkeypatch):
    """At 2,600 nodes 512 does not divide N: the JAX package asserts, while
    the port runs its blockwise attention with a ragged last chunk and
    equals full attention, forward and every gradient."""
    jcfg, tcfg, jparams, x = _wide(2_600)
    with pytest.raises(AssertionError):
        jm.apply(jparams, jcfg, jnp.asarray(x))
    _blockwise_equals_full(tcfg, params_from_jax(jparams, device="cpu"), x, monkeypatch)


def test_blockwise_attention_trains_at_pems_all_la_nodes(monkeypatch):
    """At PeMS-All-LA's 2,716 nodes (5 chunks of 512 and one of 156) the
    port's blockwise attention equals full attention, forward and every
    gradient."""
    _, tcfg, jparams, x = _wide(2_716)
    _blockwise_equals_full(tcfg, params_from_jax(jparams, device="cpu"), x, monkeypatch)
