"""Port parity for the Mixture-of-Experts FFN (``models/lm/moe.py``) and
grok-1-314b's smoke config.

Dispatch indices are integer math and must be bit-equal to the JAX
package's wherever no expert overflows.  Where one does, the JAX version
writes each dropped assignment's sentinel at slot ``(e, 0)`` as well, a
duplicate index whose ``.at[].set`` result the backend chooses (on the CPU
the last write wins, and the expert's first kept token is lost); the port
writes only the kept assignments, and the overflow test shows both.  Float
results are held within atol 1e-5 plus rtol 1e-4, in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import as_jax_dict, bridge, check_forward_loss_and_grads, check_init_tree, \
    check_prefill_and_decode, close, t_
from repro.models.lm import moe as jmoe
from repro.models.lm.config import MoEConfig as JMoEConfig
from repro_torch.interop import params_from_jax
from repro_torch.models.lm import moe as tmoe
from repro_torch.models.lm.config import MoEConfig
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

D = 16


# ------------------------------------------------------------------ dispatch
@pytest.mark.parametrize("t,k,e,capacity", [
    (6, 2, 4, 128), (40, 2, 8, 128), (300, 6, 64, 128), (130, 1, 2, 256),
])
def test_dispatch_indices_match_jax_when_dropless(t, k, e, capacity):
    rng = np.random.default_rng(t)
    # distinct experts per token, as top-k gives
    top_ix = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    want = np.asarray(jmoe._dispatch_indices(jnp.asarray(top_ix), e, capacity))
    got = tmoe._dispatch_indices(t_(top_ix, torch.long), e, capacity)
    assert got.shape == (e, capacity)
    assert np.array_equal(got.numpy(), want)


def test_dispatch_overflow_keeps_every_kept_token():
    """Three tokens for expert 0 at capacity 2: the third is dropped.  The
    port keeps tokens 0 and 1 in expert 0's queue; the JAX version's
    sentinel write for the dropped one lands on slot (0, 0) as well."""
    top_ix = np.array([[0], [0], [0], [1]], np.int32)
    got = tmoe._dispatch_indices(t_(top_ix, torch.long), 2, 2)
    assert got.tolist() == [[0, 1], [3, 4]]
    want = np.asarray(jmoe._dispatch_indices(jnp.asarray(top_ix), 2, 2))
    assert want.tolist() == [[4, 1], [3, 4]]


def test_top_k_breaks_ties_toward_the_lower_index_as_jax_does():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.4, 0.0]], np.float32)
    vals, idx = tmoe._top_k(t_(probs), 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("tokens,cf,want", [
    (16, 1.25, 128), (4096, 1.25, 512), (8, 1.0, 128), (1000, 2.0, 256)])
def test_capacity_rounds_up_to_128(tokens, cf, want):
    moe = MoEConfig(n_experts=64, top_k=6, capacity_factor=cf)
    assert tmoe.capacity_of(tokens, moe) == want


# ------------------------------------------------------------------- moe_ffn
def _moe_setup(kind, n_shared, seed=0, e=4, k=2, cf=2.0):
    kw = dict(n_experts=e, top_k=k, n_shared=n_shared, d_expert=24, capacity_factor=cf)
    jparams = jmoe.init_moe(jax.random.PRNGKey(seed), D, JMoEConfig(**kw), 32, kind)
    return (JMoEConfig(**kw), MoEConfig(**kw), jparams,
            params_from_jax(jax.device_get(jparams), device="cpu"))


def _ffn_parity(kind, n_shared, groups, b=2, s=10, **kw):
    """y, aux and the gradients of ``sum(y * r) + aux`` with respect to
    every parameter and to x."""
    jcfg, tcfg, jparams, tparams = _moe_setup(kind, n_shared, **kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    r = rng.standard_normal((b, s, D)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jparams, jnp.asarray(x), jcfg, kind, groups=groups)
    ty, taux = tmoe.moe_ffn(tparams, t_(x), tcfg, kind, groups=groups)
    close(ty, jy)
    close(taux, jaux)

    def jobj(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, jcfg, kind, groups=groups)
        return jnp.sum(y * jnp.asarray(r)) + aux

    jgp, jgx = jax.grad(jobj, argnums=(0, 1))(jparams, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tparams)]
    tx = t_(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tree_unflatten(tparams, leaves), tx, tcfg, kind, groups=groups)
    grads = torch.autograd.grad((y * t_(r)).sum() + aux, leaves + [tx],
                                allow_unused=True, materialize_grads=True)
    for path, g, j in zip(tree_paths(tparams), grads, jax.tree.leaves(jgp)):
        close(g, j, err_msg=path)
    close(grads[-1], jgx, err_msg="dx")


@pytest.mark.parametrize("kind,n_shared", [
    ("swiglu", 0), ("swiglu", 1), ("geglu", 0), ("gelu", 2), ("relu_sq", 1)])
def test_moe_ffn_matches_jax(kind, n_shared):
    """Every MLP kind (a non-gated kind other than gelu runs the experts
    through gelu, as in JAX), with and without shared experts."""
    _ffn_parity(kind, n_shared, groups=1)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_grouped_dispatch_matches_jax_at_two_groups(kind):
    _ffn_parity(kind, 1, groups=2)


def test_moe_ffn_overflow_drops_the_queue_tail_and_keeps_its_head():
    """300 equal tokens all route to one of 2 experts (top-1, capacity 256):
    both packages drop tokens 256..299.  The JAX version's sentinel writes
    for them land on slot (e, 0) too, so it also loses token 0; the port
    keeps it, and every other token agrees."""
    jcfg, tcfg, jparams, tparams = _moe_setup("swiglu", 0, e=2, k=1, cf=1.0)
    x = np.ones((1, 300, D), np.float32)
    ty, _ = tmoe.moe_ffn(tparams, t_(x), tcfg, "swiglu")
    jy, _ = jmoe.moe_ffn(jparams, jnp.asarray(x), jcfg, "swiglu")
    ty, jy = ty.numpy()[0], np.asarray(jy)[0]
    kept = np.abs(ty).sum(-1) > 0
    assert kept.sum() == 256 and kept[:256].all()  # FIFO: the first 256 tokens
    np.testing.assert_allclose(ty[1:], jy[1:], atol=1e-5, rtol=1e-4)
    assert np.abs(jy[0]).sum() == 0 and np.abs(ty[0]).sum() > 0


def test_init_moe_keeps_the_router_float32():
    moe = MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=8)
    p = tmoe.init_moe(lambda shape: torch.randn(shape), D, moe, 32, "swiglu",
                      dtype=torch.bfloat16, lead=(3,))
    jp = jmoe.init_moe(jax.random.PRNGKey(0), D, JMoEConfig(**as_jax_dict(moe)),
                       32, "swiglu", dtype=jnp.bfloat16)
    jp = jax.tree.map(lambda a: jnp.broadcast_to(a, (3,) + a.shape), jp)
    for t, j in zip(tree_leaves(p), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and str(t.dtype).endswith(str(j.dtype))
    assert p["router"]["w"].dtype == torch.float32


# -------------------------------------------------------------- grok-1-314b
def test_grok_init_tree_matches_jax():
    check_init_tree("grok-1-314b")


def test_grok_forward_loss_and_grads_match_jax():
    check_forward_loss_and_grads("grok-1-314b")


def test_grok_prefill_and_decode_match_jax():
    check_prefill_and_decode("grok-1-314b")


def test_grok_params_bridge_stacked_experts():
    """The stacked expert weights cross over as [R, E, d, f]."""
    _, tcfg, jparams, tparams = bridge("grok-1-314b")
    moe = tparams["stages"][0]["sub0"]["moe"]
    e, de = tcfg.moe.n_experts, tcfg.moe.d_expert or tcfg.d_ff
    assert tuple(moe["wi"].shape) == (tcfg.layers, e, tcfg.d_model, de)
    assert tuple(moe["wo"].shape) == (tcfg.layers, e, de, tcfg.d_model)
    assert np.array_equal(moe["wg"].numpy(),
                          np.asarray(jparams["stages"][0]["sub0"]["moe"]["wg"]))
