"""Port parity: PGT-DCRNN forward, loss and every gradient leaf, one AdamW
update, the LR schedule and the microbatched train step, against the JAX
package with bridged parameters, in float32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import pgt_dcrnn as jm
from repro.optim import AdamConfig as JAdam
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.interop import params_from_jax
from repro_torch.models import pgt_dcrnn as tm
from repro_torch.optim import AdamConfig, apply_updates, init_opt_state, warmup_cosine
from repro_torch.train.loop import make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_paths

# float32 through 2·K hops and T recurrent steps in two frameworks: sums in
# another order, so a few float32 ulps per op add up.
ATOL, RTOL = 1e-5, 1e-4
CFG = dict(num_nodes=9, in_features=2, out_features=1, hidden=6,
           max_diffusion_step=2, input_len=4, horizon=4)


def _setup(seed=0, batch=3):
    rng = np.random.default_rng(seed)
    adj = rng.uniform(0, 1, (9, 9)).astype(np.float32)
    adj[adj < 0.4] = 0
    np.fill_diagonal(adj, 1.0)
    sup = (adj / adj.sum(1, keepdims=True), adj.T / adj.T.sum(1, keepdims=True))
    x = rng.standard_normal((batch, 4, 9, 2)).astype(np.float32)
    y = rng.standard_normal((batch, 4, 9, 2)).astype(np.float32)
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(seed), jm.PGTDCRNNConfig(**CFG)))
    return sup, x, y, jparams


def _numpy_leaves(tparams):
    return tree_leaves(tree_map(lambda t: t.detach().cpu().numpy(), tparams))


def _assert_tree_close(tparams, jtree, atol=ATOL, rtol=RTOL):
    ours = _numpy_leaves(tparams)
    theirs = tree_leaves(jax.tree.map(np.asarray, jtree))
    assert len(ours) == len(theirs)
    for path, a, b in zip(tree_paths(tparams), ours, theirs):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=path)


def test_params_from_jax_is_an_exact_copy():
    _, _, _, jparams = _setup()
    tparams = params_from_jax(jparams, device="cpu")
    assert tree_paths(tparams) == ["c/b", "c/w", "proj/b", "proj/w", "ru/b", "ru/w"]
    for a, b in zip(_numpy_leaves(tparams),
                    jax.tree.leaves(jparams)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


def test_init_shapes_match_jax():
    cfg = tm.PGTDCRNNConfig(**CFG)
    tparams = tm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0), jm.PGTDCRNNConfig(**CFG))
    assert [tuple(t.shape) for t in tree_leaves(tparams)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jparams)]
    assert all(t.dtype == torch.float32 for t in tree_leaves(tparams))


@pytest.mark.parametrize("remat,use_pallas", [(False, False), (True, False), (False, True)])
def test_forward_loss_and_every_gradient_leaf_match_jax(remat, use_pallas):
    sup, x, y, jparams = _setup()
    jcfg = jm.PGTDCRNNConfig(**CFG, remat=remat)
    tcfg = tm.PGTDCRNNConfig(**CFG, remat=remat, use_pallas=use_pallas)
    jsup = tuple(map(jnp.asarray, sup))
    tsup = tuple(map(torch.as_tensor, sup))
    tparams = params_from_jax(jparams, device="cpu")

    jpred = np.asarray(jm.apply(jparams, jcfg, jsup, jnp.asarray(x)))
    with torch.no_grad():
        tpred = tm.apply(tparams, tcfg, tsup, torch.as_tensor(x)).numpy()
    assert tpred.shape == (3, 4, 9, 1)
    np.testing.assert_allclose(tpred, jpred, atol=ATOL, rtol=RTOL)
    if use_pallas:
        return  # the kernel path is forward-only, as in the JAX package

    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jparams, jcfg, jsup,
                                                   jnp.asarray(x), jnp.asarray(y))
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tloss = tm.loss_fn(tparams, tcfg, tsup, torch.as_tensor(x), torch.as_tensor(y))
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=ATOL, rtol=RTOL)
    for path, g, jg in zip(tree_paths(tparams), grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATOL, rtol=RTOL,
                                   err_msg=path)


@pytest.mark.parametrize("weight_decay,grad_clip,state_dtype", [
    (0.0, 1.0, "float32"), (0.01, None, "float32"), (0.0, 0.05, "bfloat16")])
def test_one_adam_update_matches_jax_leaf_by_leaf(weight_decay, grad_clip, state_dtype):
    _, _, _, jparams = _setup(seed=1)
    rng = np.random.default_rng(9)
    jgrads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                          jparams)
    jcfg = JAdam(lr=3e-3, weight_decay=weight_decay, grad_clip=grad_clip,
                 state_dtype=state_dtype)
    tcfg = AdamConfig(lr=3e-3, weight_decay=weight_decay, grad_clip=grad_clip,
                      state_dtype=state_dtype)
    jstate = jax_init_opt_state(jparams, jcfg)
    tparams = params_from_jax(jparams, device="cpu")
    tgrads = params_from_jax(jgrads, device="cpu")
    tstate = init_opt_state(tparams, tcfg)
    for _ in range(3):  # a few steps so bias correction moves
        jparams, jstate, jnorm = jax_apply_updates(jparams, jgrads, jstate, jcfg, 3e-3)
        tparams, tstate, tnorm = apply_updates(tparams, tgrads, tstate, tcfg, 3e-3)
    assert tstate["step"] == int(jstate["step"]) == 3
    _assert_tree_close(tparams, jparams, atol=1e-6, rtol=1e-5)
    # bf16 moments: one bf16 rounding step apart at most
    m_tol = dict(atol=1e-6, rtol=1e-5) if state_dtype == "float32" else dict(atol=1e-6, rtol=8e-3)
    for key in ("m", "v"):
        _assert_tree_close({k: {n: t.float() for n, t in d.items()}
                            for k, d in tstate[key].items()},
                           jax.tree.map(lambda a: a.astype(jnp.float32), jstate[key]),
                           **m_tol)
    if grad_clip is None:
        assert tnorm is None and jnorm is None
    else:
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)


def test_warmup_cosine_matches_jax():
    for step in (0, 1, 5, 10, 37, 100, 250):
        kw = dict(base_lr=2e-3, warmup_steps=10, total_steps=200)
        np.testing.assert_allclose(float(warmup_cosine(step, **kw)),
                                   float(jax_warmup_cosine(step, **kw)), rtol=1e-6)


@pytest.mark.parametrize("microbatches,grad_dtype", [(1, None), (2, None), (3, "bfloat16")])
def test_train_step_matches_jax(microbatches, grad_dtype):
    sup, x, y, jparams = _setup(seed=2, batch=6)
    jcfg, tcfg = jm.PGTDCRNNConfig(**CFG), tm.PGTDCRNNConfig(**CFG)
    jsup, tsup = tuple(map(jnp.asarray, sup)), tuple(map(torch.as_tensor, sup))

    def jloss(p, idx):
        return jm.loss_fn(p, jcfg, jsup, jnp.asarray(x)[idx], jnp.asarray(y)[idx]), {}

    def tloss(p, idx):
        return tm.loss_fn(p, tcfg, tsup, torch.as_tensor(x)[idx],
                          torch.as_tensor(y)[idx]), {}

    sched = lambda s: 1e-2
    jstep = jax_make_train_step(jloss, JAdam(lr=1e-2), sched, microbatches=microbatches,
                                grad_dtype=grad_dtype, donate=False)
    tstep = make_train_step(tloss, AdamConfig(lr=1e-2), sched,
                            microbatches=microbatches, grad_dtype=grad_dtype)
    idx = np.arange(6)
    tparams = params_from_jax(jparams, device="cpu")
    jstate = {"params": jparams, "opt": jax_init_opt_state(jparams, JAdam(lr=1e-2))}
    tstate = {"params": tparams, "opt": init_opt_state(tparams, AdamConfig(lr=1e-2))}
    for _ in range(2):
        jstate, jm_ = jstep(jstate, jnp.asarray(idx))
        tstate, tm_ = tstep(tstate, torch.as_tensor(idx))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   atol=ATOL, rtol=RTOL)
    tol = dict(atol=ATOL, rtol=RTOL) if grad_dtype is None else dict(atol=1e-4, rtol=1e-3)
    _assert_tree_close(tstate["params"], jstate["params"], **tol)


@pytest.mark.parametrize("step", [0, 3, 250])
def test_constant_schedule_matches_jax(step):
    from repro.optim import constant as jax_constant
    from repro_torch.optim import constant

    got = constant(step, base_lr=3e-4, warmup_steps=10, total_steps=200)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(jax_constant(step, base_lr=3e-4))


@pytest.mark.parametrize("global_batch,base_batch,cap", [
    (64, 64, 16.0), (1024, 64, 16.0), (4096, 64, 16.0), (96, 64, 1.0), (32, 64, 16.0)])
def test_linear_scaled_lr_matches_jax(global_batch, base_batch, cap):
    from repro.optim import linear_scaled_lr as jax_linear_scaled_lr
    from repro_torch.optim import linear_scaled_lr

    assert (linear_scaled_lr(1e-3, global_batch, base_batch, cap)
            == jax_linear_scaled_lr(1e-3, global_batch, base_batch, cap))


def test_tree_unflatten_leaves_no_reference_cycle():
    """A rebuilt tree holds its leaves only through itself: dropping it frees
    them with the cyclic collector off.  (A recursive closure over the
    leaves' iterator used to keep every rebuild's leaves, such as a train
    step's gradients, alive until the collector ran.)"""
    import gc
    import weakref

    from repro_torch.tree import tree_unflatten

    like = {"a": [torch.zeros(2), {"b": torch.zeros(3)}], "c": torch.zeros(1)}
    leaves = [torch.ones(2), torch.full((3,), 2.0), torch.full((1,), 3.0)]
    refs = [weakref.ref(t) for t in leaves]
    gc.disable()
    try:
        tree = tree_unflatten(like, leaves)
        assert tree_paths(tree) == tree_paths(like)
        assert all(a is b for a, b in zip(tree_leaves(tree), leaves))
        del tree, leaves
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
