"""Port parity for Multi-head Latent Attention (``models/lm/mla.py``) and
deepseek-v2-lite-16b's smoke config (MLA with a leading dense layer and MoE
layers with a shared expert).

The decompressed train/prefill attention and the absorbed decode against a
contiguous latent cache are held within atol 1e-5 plus rtol 1e-4 of the
JAX package, in float32, on the JAX draws bridged into the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import bridge, check_forward_loss_and_grads, check_init_tree, \
    check_prefill_and_decode, close, t_
from repro.models.lm import mla as jmla
from repro_torch.models.lm import mla as tmla
from repro_torch.models.lm import model as tm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def layer():
    """(jcfg, tcfg, JAX MLA params, port MLA params) of the first layer."""
    jcfg, tcfg, jparams, tparams = bridge(ARCH)
    jp = jax.tree.map(lambda a: a[0], jparams["stages"][0]["sub0"]["attn"])
    tp = tree_map(lambda t: t[0], tparams["stages"][0]["sub0"]["attn"])
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("s", [1, 7, 16])
def test_mla_attention_matches_jax(layer, s):
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s) + 3, (2, s)).astype(np.int32)
    jy, (jc, jk) = jmla.mla_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    ty, (tc, tk) = tmla.mla_attention(tp, tcfg, t_(x), t_(pos, torch.long))
    close(ty, jy)
    close(tc, jc)
    close(tk, jk)


def test_mla_attention_gradients_match_jax(layer):
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)

    def jobj(p, xx):
        return jnp.sum(jmla.mla_attention(p, jcfg, xx, jnp.asarray(pos))[0] * r)

    jgp, jgx = jax.grad(jobj, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tx = t_(x).requires_grad_(True)
    y, _ = tmla.mla_attention(tree_unflatten(tp, leaves), tcfg, tx, t_(pos, torch.long))
    grads = torch.autograd.grad((y * t_(r)).sum(), leaves + [tx])
    for g, j in zip(grads, jax.tree.leaves(jgp)):
        close(g, j)
    close(grads[-1], jgx)


@pytest.mark.parametrize("lengths", [(0, 0), (3, 11), (15, 1)])
def test_mla_decode_matches_jax(layer, lengths):
    """The absorbed decode at per-lane lengths against a random latent
    cache: output and the written caches."""
    jcfg, tcfg, jp, tp = layer
    m = tcfg.mla
    rng = np.random.default_rng(sum(lengths))
    x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((2, 16, m.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((2, 16, m.qk_rope_head_dim)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    jy, jc, jk = jmla.mla_decode(jp, jcfg, jnp.asarray(x1), jnp.asarray(ckv),
                                 jnp.asarray(kpe), jnp.asarray(lens))
    tc, tk = t_(ckv), t_(kpe)
    ty, tc2, tk2 = tmla.mla_decode(tp, tcfg, t_(x1), tc, tk, t_(lens, torch.long))
    assert tc2 is tc and tk2 is tk  # written in place
    close(ty, jy)
    close(tc, jc)
    close(tk, jk)


def test_mla_decode_agrees_with_the_decompressed_attention(layer):
    """The absorbed decode of token t over the cache of tokens 0..t equals
    the decompressed causal attention's row t (the JAX package's identity)."""
    _, tcfg, _, tp = layer
    m = tcfg.mla
    x = torch.randn(1, 6, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(6)[None]
    y, (c_kv, k_pe) = tmla.mla_attention(tp, tcfg, x, pos)
    ckv = torch.zeros(1, 8, m.kv_lora_rank)
    kpe = torch.zeros(1, 8, m.qk_rope_head_dim)
    ckv[:, :5], kpe[:, :5] = c_kv[:, :5], k_pe[:, :5]
    y1, _, _ = tmla.mla_decode(tp, tcfg, x[:, 5:], ckv, kpe, torch.tensor([5]))
    close(y1[:, 0], y[:, 5].detach().numpy(), atol=1e-5, rtol=1e-4)


# ------------------------------------------------------- deepseek-v2-lite-16b
def test_deepseek_init_tree_matches_jax():
    """MLA leaves, the first layer's dense FFN at ``dense_d_ff`` and the
    stacked experts with their shared expert."""
    check_init_tree(ARCH)


def test_deepseek_forward_loss_and_grads_match_jax():
    check_forward_loss_and_grads(ARCH)


def test_deepseek_prefill_and_decode_match_jax():
    check_prefill_and_decode(ARCH)


def test_deepseek_stage_plan_and_cache_layout():
    _, tcfg, _, tparams = bridge(ARCH)
    plan = [(tuple((sp.mixer, sp.ffn) for sp in specs), r)
            for specs, r in tm.stage_plan(tcfg)]
    assert plan == [((("mla", "dense"),), 1), ((("mla", "moe"),), 1)]
    assert tparams["stages"][0]["sub0"]["mlp"]["wi"]["w"].shape[-1] == tcfg.moe.dense_d_ff
    cache = tm.init_cache(tcfg, 3, 20, device="cpu")
    m = tcfg.mla
    assert tuple(cache[1]["sub0"]["ckv"].shape) == (1, 3, 20, m.kv_lora_rank)
    assert tuple(cache[1]["sub0"]["kpe"].shape) == (1, 3, 20, m.qk_rope_head_dim)


def test_compute_copy_keeps_the_router_float32():
    _, tcfg, _, tparams = bridge(ARCH)
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    copy = tm.compute_copy(tparams, bf, device="cpu")
    moe = copy["stages"][1]["sub0"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["wi"].dtype == copy["stages"][1]["sub0"]["attn"]["wq"]["w"].dtype \
        == torch.bfloat16
