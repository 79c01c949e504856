"""Port parity for the RWKV-6 "Finch" block (``models/lm/rwkv6.py``) and
rwkv6-1.6b's smoke config.

The port's WKV scan is a Python loop over time with a float32 state, and
takes ``r·(S + (u ⊙ k) vᵀ)`` as ``r·S + (Σ r ⊙ u ⊙ k) v`` (the same sum in
another order; autograd keeps one state a step).  Outputs, states and
gradients of the block are held within atol 1e-5 plus rtol 1e-4 of the JAX
package's ``lax.scan``, in float32, on the JAX draws bridged into the port.

The whole smoke model is held within atol 1e-4 (rtol 1e-4): two stacked
blocks carry float32 rounding through 12 steps of a 16 x 16 state a head,
and the JAX package's own logits lie 8.8e-5 from a float64 evaluation of
the same parameters on the same tokens (the port's lie 4.9e-5 from it;
``test_rwkv6_logits_are_no_further_from_float64_than_jax``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import bridge, check_forward_loss_and_grads, check_init_tree, \
    check_prefill_and_decode, close, t_
from repro.models.lm import model as jm
from repro.models.lm import rwkv6 as jrwkv
from repro_torch.configs import get_arch
from repro_torch.models.lm import model as tm
from repro_torch.models.lm import rwkv6 as trwkv
from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

ARCH = "rwkv6-1.6b"
MODEL_ATOL = 1e-4


@pytest.fixture(scope="module")
def block():
    """(jcfg, tcfg, JAX block params, port block params) of layer 0."""
    jcfg, tcfg, jparams, tparams = bridge(ARCH)
    return (jcfg, tcfg, jax.tree.map(lambda a: a[0], jparams["stages"][0]["sub0"]["rwkv"]),
            tree_map(lambda t: t[0], tparams["stages"][0]["sub0"]["rwkv"]))


def _cache(rng, cfg, b):
    hs = cfg.rwkv_head_size
    n_h = cfg.d_model // hs
    return {"shift": rng.standard_normal((b, cfg.d_model)).astype(np.float32),
            "state": rng.standard_normal((b, n_h, hs, hs)).astype(np.float32) * 0.3}


@pytest.mark.parametrize("s", [1, 9])
def test_wkv_scan_matches_jax(s):
    rng = np.random.default_rng(s)
    b, h, hs = 2, 3, 8
    r, k, v = (rng.standard_normal((b, s, h, hs)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.2, 0.99, (b, s, h, hs)).astype(np.float32)
    u = rng.standard_normal((h, hs)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((b, h, hs, hs)).astype(np.float32)
    jout, jlast = jrwkv._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    tout, tlast = trwkv._wkv_scan(*map(t_, (r, k, v, w, u, s0)))
    close(tout, jout)
    close(tlast, jlast)


@pytest.mark.parametrize("with_cache", [False, True], ids=["train", "cached"])
def test_time_mix_matches_jax(block, with_cache):
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    cache = _cache(rng, tcfg, 2) if with_cache else None
    jy, jc = jrwkv.time_mix(jp, jcfg, jnp.asarray(x),
                            cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    ty, tc = trwkv.time_mix(tp, tcfg, t_(x), cache=None if cache is None else tree_map(t_, cache))
    close(ty, jy)
    close(tc["shift"], jc["shift"])
    close(tc["state"], jc["state"])


@pytest.mark.parametrize("with_cache", [False, True], ids=["train", "cached"])
def test_channel_mix_matches_jax(block, with_cache):
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, tcfg.d_model)).astype(np.float32)
    jy, jc = jrwkv.channel_mix(jp, jcfg, jnp.asarray(x),
                               cache={"shift": jnp.asarray(last)} if with_cache else None)
    ty, tc = trwkv.channel_mix(tp, tcfg, t_(x),
                               cache={"shift": t_(last)} if with_cache else None)
    close(ty, jy)
    close(tc["shift"], jc["shift"])


def test_time_mix_gradients_match_jax(block):
    """Through the scan's loop: every parameter of the block and x."""
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)

    def jobj(p, xx):
        return jnp.sum(jrwkv.time_mix(p, jcfg, xx)[0] * r)

    jgp, jgx = jax.grad(jobj, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tx = t_(x).requires_grad_(True)
    y, _ = trwkv.time_mix(tree_unflatten(tp, leaves), tcfg, tx)
    grads = torch.autograd.grad((y * t_(r)).sum(), leaves + [tx], allow_unused=True,
                                materialize_grads=True)
    for path, g, j in zip(tree_paths(tp), grads, jax.tree.leaves(jgp)):
        close(g, j, err_msg=path)
    close(grads[-1], jgx, err_msg="dx")


def test_block_init_shares_the_mu_draws_and_keeps_w0_and_u_float32():
    """As in the JAX package: the five time-mix μ are one draw, the two
    channel-mix μ another, all in [0.25, 0.75); ``w0`` and ``u`` stay
    float32 under a bf16 parameter dtype."""
    cfg = get_arch(ARCH).smoke_config()
    p = trwkv.init_rwkv_block(lambda shape: torch.randn(shape), cfg, torch.bfloat16,
                              lead=(2,))
    mus = [p["mu"][n] for n in ("r", "k", "v", "g", "w")]
    assert all(torch.equal(m, mus[0]) for m in mus)
    assert torch.equal(p["cm_mu_k"], p["cm_mu_r"])
    assert float(mus[0].min()) >= 0.25 and float(mus[0].max()) <= 0.75
    assert p["w0"].dtype == p["u"].dtype == torch.float32
    assert p["wr"]["w"].dtype == torch.bfloat16
    assert torch.all(p["w0"] == -0.6)


# ---------------------------------------------------------------- rwkv6-1.6b
def test_rwkv6_init_tree_matches_jax():
    check_init_tree(ARCH)


def test_rwkv6_forward_loss_and_grads_match_jax():
    check_forward_loss_and_grads(ARCH, atol=MODEL_ATOL)


def test_rwkv6_prefill_and_decode_match_jax():
    """The recurrent state crosses decode steps through the cache."""
    check_prefill_and_decode(ARCH, atol=MODEL_ATOL)


def test_rwkv6_logits_are_no_further_from_float64_than_jax():
    """The reason for MODEL_ATOL: against the port run in float64 on the same
    parameters and tokens, the port's float32 logits are at most twice as
    far as the JAX package's float32 logits (4.9e-5 and 8.8e-5 here)."""
    jcfg, tcfg, jparams, tparams = bridge(ARCH)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    ref, _ = tm.forward(tree_map(lambda t: t.double(), tparams),
                        dataclasses.replace(tcfg, dtype="float64"), t_(toks, torch.long))
    ours, _ = tm.forward(tparams, tcfg, t_(toks, torch.long))
    theirs, _ = jm.forward(jparams, jcfg, jnp.asarray(toks))
    ours_err = float((ours.double() - ref).abs().max())
    jax_err = float(np.abs(np.asarray(theirs, np.float64) - ref.numpy()).max())
    assert ours_err <= 2 * jax_err and jax_err < MODEL_ATOL


def test_rwkv6_cache_layout_and_bf16_state():
    """``init_cache`` mirrors JAX's (tm: shift, state; cm: shift), and a
    bf16 cache stores the state in bf16 between decode steps, as JAX does."""
    _, tcfg, _, tparams = bridge(ARCH)
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    cache = tm.init_cache(bf, 2, 16, device="cpu")
    hs = tcfg.rwkv_head_size
    st = cache[0]["sub0"]["tm"]["state"]
    assert tuple(st.shape) == (tcfg.layers, 2, tcfg.d_model // hs, hs, hs)
    assert st.dtype == torch.bfloat16
    params = tm.compute_copy(tparams, bf, device="cpu")
    toks = torch.tensor([[3, 5, 7], [1, 2, 4]])
    _, cache, lengths = tm.prefill(params, bf, toks, cache)
    logits, cache = tm.decode_step(params, bf, toks[:, :1], cache, lengths)
    assert cache[0]["sub0"]["tm"]["state"].dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())
    assert float(cache[0]["sub0"]["tm"]["state"].abs().sum()) > 0
