"""Port parity for DCRNN, the paper's baseline: forward, MAE loss and every
gradient leaf (remat off and on), the teacher-forced rollout with the JAX
coin pinned, the ``use_pallas=True`` forward against the JAX package's
Pallas path in interpret mode, ``diffusion_conv`` past the hop kernel's C
limit, and the ST-GNN arch registry — with bridged parameters, in float32
on the CPU, at test_torch_model.py's tolerance (atol 1e-5, rtol 1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.diffusion_conv import diffusion_conv as jax_diffusion_conv
from repro.models import dcrnn as jm
from repro_torch.configs import get_arch
from repro_torch.interop import params_from_jax
from repro_torch.kernels.diffusion_conv import diffusion_conv
from repro_torch.kernels.diffusion_conv.kernel import MAX_C, column_tiles
from repro_torch.models import dcrnn as tm
from repro_torch.tree import tree_leaves, tree_paths

ATOL, RTOL = 1e-5, 1e-4
CFG = dict(num_nodes=9, in_features=2, out_features=1, hidden=6, layers=2,
           max_diffusion_step=2, input_len=4, horizon=4)


def _supports(rng, n):
    adj = rng.uniform(0, 1, (n, n)).astype(np.float32)
    adj[adj < 0.4] = 0
    np.fill_diagonal(adj, 1.0)
    return (adj / adj.sum(1, keepdims=True), adj.T / adj.T.sum(1, keepdims=True))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    sup = _supports(rng, 9)
    x = rng.standard_normal((3, 4, 9, 2)).astype(np.float32)
    y = rng.standard_normal((3, 4, 9, 2)).astype(np.float32)
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0), jm.DCRNNConfig(**CFG)))
    return sup, x, y, jparams


def _close(got, want, path=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=path)


def test_init_tree_matches_jax(setup):
    *_, jparams = setup
    tparams = tm.init(torch.Generator().manual_seed(0), tm.DCRNNConfig(**CFG), device="cpu")
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert tree_paths(tparams) == jpaths
    assert isinstance(tparams["encoder"], list) and len(tparams["decoder"]) == 2
    assert [tuple(t.shape) for t in tree_leaves(tparams)] == \
        [a.shape for a in jax.tree.leaves(jparams)]


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_every_gradient_leaf_match_jax(setup, remat):
    sup, x, y, jparams = setup
    jcfg, tcfg = jm.DCRNNConfig(**CFG, remat=remat), tm.DCRNNConfig(**CFG, remat=remat)
    jsup, tsup = tuple(map(jnp.asarray, sup)), tuple(map(torch.as_tensor, sup))
    tparams = params_from_jax(jparams, device="cpu")
    with torch.no_grad():
        tpred = tm.apply(tparams, tcfg, tsup, torch.as_tensor(x))
    assert tpred.shape == (3, 4, 9, 1)
    _close(tpred.numpy(), jm.apply(jparams, jcfg, jsup, jnp.asarray(x)))

    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.mae_loss(jm.apply(p, jcfg, jsup, jnp.asarray(x)),
                              jnp.asarray(y)[..., :1]))(jparams)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tloss = tm.loss_fn(tparams, tcfg, tsup, torch.as_tensor(x), torch.as_tensor(y))
    grads = torch.autograd.grad(tloss, leaves)
    _close(float(tloss.detach()), float(jloss))
    _close(float(tloss.detach()),
           float(jm.loss_fn(jparams, jcfg, jsup, jnp.asarray(x), jnp.asarray(y))))
    for path, g, jg in zip(tree_paths(tparams), grads, jax.tree.leaves(jgrads)):
        _close(g.numpy(), jg, path)


def test_teacher_forced_rollout_with_the_jax_coin(setup):
    sup, x, y, jparams = setup
    jcfg, tcfg = jm.DCRNNConfig(**CFG), tm.DCRNNConfig(**CFG)
    key = jax.random.PRNGKey(5)
    coin = np.array(jax.random.bernoulli(key, 0.5, (CFG["horizon"],)))
    assert 0 < coin.sum() < len(coin)  # both branches of the coin run
    yt = y[..., :1]
    jpred = jm.apply(jparams, jcfg, tuple(map(jnp.asarray, sup)), jnp.asarray(x),
                     y_teacher=jnp.asarray(yt), teacher_prob=0.5, rng=key)
    tparams = params_from_jax(jparams, device="cpu")
    tsup, tx, tyt = tuple(map(torch.as_tensor, sup)), torch.as_tensor(x), torch.as_tensor(yt)
    with torch.no_grad():
        tpred = tm.apply(tparams, tcfg, tsup, tx, y_teacher=tyt,
                         coin=torch.as_tensor(coin))
        _close(tpred.numpy(), jpred)
        free = tm.apply(tparams, tcfg, tsup, tx)
        assert not torch.allclose(tpred, free)
        # without a pinned coin the draw comes from an explicit generator
        drawn = [tm.apply(tparams, tcfg, tsup, tx, y_teacher=tyt, teacher_prob=0.5,
                          generator=torch.Generator().manual_seed(1)) for _ in range(2)]
        assert torch.equal(*drawn)
        with pytest.raises(ValueError, match="generator"):
            tm.apply(tparams, tcfg, tsup, tx, y_teacher=tyt, teacher_prob=0.5)


def test_use_pallas_forward_matches_the_jax_pallas_path(setup):
    """Both packages route every hop through their kernel: the JAX Pallas
    kernel in interpret mode, the port's hop_project on its plain version."""
    sup, x, y, jparams = setup
    jcfg = jm.DCRNNConfig(**CFG, use_pallas=True)
    tcfg = tm.DCRNNConfig(**CFG, use_pallas=True)
    jloss = jm.loss_fn(jparams, jcfg, tuple(map(jnp.asarray, sup)), jnp.asarray(x),
                       jnp.asarray(y))
    tparams = params_from_jax(jparams, device="cpu")
    with torch.no_grad():
        tloss = tm.loss_fn(tparams, tcfg, tuple(map(torch.as_tensor, sup)),
                           torch.as_tensor(x), torch.as_tensor(y))
    _close(float(tloss), float(jloss))


def test_column_tiles_cover_c_in_equal_tiles_of_at_most_max_c():
    assert column_tiles(66) == [(0, 66)] and column_tiles(MAX_C) == [(0, MAX_C)]
    assert column_tiles(130) == [(0, 65), (65, 130)]
    assert column_tiles(192) == [(0, 96), (96, 192)]
    for c in range(1, 600, 7):
        tiles = column_tiles(c)
        assert tiles[0][0] == 0 and tiles[-1][1] == c
        assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
        assert all(0 < hi - lo <= MAX_C for lo, hi in tiles)
        assert len(tiles) == -(-c // MAX_C)


@pytest.mark.parametrize("c", [130, 192])
def test_diffusion_conv_past_the_kernel_c_limit_matches_jax(c):
    """C > MAX_C runs the hops as column tiles, each tile's Y feeding the
    next; the JAX Pallas hop (interpret mode) takes any C in one call."""
    rng = np.random.default_rng(c)
    sup = _supports(rng, 12)
    x = rng.standard_normal((2, 12, c)).astype(np.float32)
    w = (rng.standard_normal((5 * c, 8)) / np.sqrt(c)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    jout = jax_diffusion_conv(jnp.asarray(x), tuple(map(jnp.asarray, sup)),
                              jnp.asarray(w), jnp.asarray(b), k_hops=2, use_pallas=True)
    args = (torch.as_tensor(x), tuple(map(torch.as_tensor, sup)), torch.as_tensor(w),
            torch.as_tensor(b))
    for kw in (dict(use_pallas=True), dict(impl="pallas"), dict(impl="ref")):
        _close(diffusion_conv(*args, k_hops=2, **kw).numpy(), jout, str(kw))


@pytest.mark.parametrize("arch_id", ["dcrnn-pems", "pgt-dcrnn-pems-all-la"])
def test_stgnn_archs_match_the_jax_specs(arch_id):
    ours, theirs = get_arch(arch_id), jax_get_arch(arch_id)
    assert type(ours.model).__name__ == type(theirs.model).__name__
    # use_pallas: the port's default runs the hand-written hop kernels on a
    # card (their plain versions on the CPU); the JAX package's, the plain hops
    mine, jax_cfg = dataclasses.asdict(ours.model), dataclasses.asdict(theirs.model)
    assert (mine.pop("use_pallas"), jax_cfg.pop("use_pallas")) == (True, False)
    assert mine == jax_cfg
    assert [dataclasses.asdict(s) for s in ours.shapes] == \
        [dataclasses.asdict(s) for s in theirs.shapes]
    for field in ("id", "family", "lm", "dataset", "source", "notes"):
        assert getattr(ours, field) == getattr(theirs, field), field
    with pytest.raises(ValueError, match="not an LM arch"):
        ours.smoke_config()
