"""Port parity for the LM backbone of the recurrentgemma serving slice.

On recurrentgemma-2b's smoke config in float32, with ``use_pallas_scan=True``
in both packages (the JAX Pallas scan in interpret mode, the port's scan
through its CUDA kernel's plain version on the CPU), and the JAX parameters
bridged through ``params_from_jax``: layers, attention variants, the RG-LRU
block, ``forward``, ``prefill`` and 20 ``decode_step``s.  With
``use_pallas_scan=False`` (the config's default) beside them: the block,
``forward``, ``loss_fn`` and every gradient through the associative scan,
and ``prefill`` and 20 decode steps through the sequential scan, each
package's own branches (``tests/lm_parity.py``'s atol 1e-5 plus rtol 1e-4
for the loss and gradients).  Float32 through a
few layers in two frameworks sums in another order, a few ulps per op, and
the residual stream grows to about 6 over the four layers, so logits and
activations are held within atol 1e-5 plus rtol 1e-5 (the largest gap seen:
1.03e-5 on a logit of 1.05 in the 48-token forward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import as_jax_dict, check_forward_loss_and_grads, check_prefill_and_decode
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import LM_ARCHS as JAX_LM_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.models.lm import attention as jattn
from repro.models.lm import layers as jlayers
from repro.models.lm import model as jm
from repro.models.lm import rglru as jrglru
from repro_torch.configs import ARCHS, LM_ARCHS, PORT_ONLY, get_arch
from repro_torch.interop import params_from_jax
from repro_torch.models.lm import attention as tattn
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm import model as tm
from repro_torch.models.lm import rglru as trglru
from repro_torch.models.lm.config import LMConfig
from repro_torch.tree import tree_leaves, tree_map, tree_paths

ATOL = RTOL = 1e-5


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.fixture(scope="module")
def rg():
    jcfg = dataclasses.replace(jax_get_arch("recurrentgemma-2b").smoke_config(),
                               use_pallas_scan=True)
    tcfg = dataclasses.replace(get_arch("recurrentgemma-2b").smoke_config(),
                               use_pallas_scan=True)
    jparams = jax.jit(jm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------- config, params
def test_registry_matches_the_jax_arch_and_names_unported_ones():
    """All twelve archs of the JAX registry resolve, with equal configs
    (the port's own config fields at the defaults that keep the JAX
    package's behaviour), smoke configs, cells, skips and parameter counts;
    beside them the port's own arch (ST-LLM on DeepSeek-V2-Lite's block),
    and no other; an unknown id raises."""
    assert sorted(set(ARCHS) - set(PORT_ONLY)) == sorted(JAX_ARCHS) and len(JAX_ARCHS) == 12
    assert PORT_ONLY == ("stllm-ds2lite-pems-all-la",) and not set(PORT_ONLY) & set(JAX_ARCHS)
    assert set(PORT_ONLY) <= set(ARCHS) and len(ARCHS) == 13
    assert sorted(LM_ARCHS) == sorted(JAX_LM_ARCHS)
    for arch_id in JAX_ARCHS:
        ours, theirs = get_arch(arch_id), jax_get_arch(arch_id)
        assert (ours.id, ours.family, ours.source) == (theirs.id, theirs.family, theirs.source)
        assert [dataclasses.astuple(c) for c in ours.cells(include_skipped=True)] \
            == [dataclasses.astuple(c) for c in theirs.cells(include_skipped=True)]
        assert ours.skips == theirs.skips
        if theirs.lm is None:
            assert ours.lm is None
            continue
        assert as_jax_dict(ours.lm) == dataclasses.asdict(theirs.lm)
        assert (as_jax_dict(ours.smoke_config())
                == dataclasses.asdict(theirs.smoke_config()))
        assert ours.lm.param_count() == theirs.lm.param_count()
        assert ours.lm.active_param_count() == theirs.lm.active_param_count()
    with pytest.raises(KeyError):
        get_arch("nope")


def test_params_from_jax_bridges_the_list_bearing_tree(rg):
    """``params["stages"]`` is a list: paths, order and values follow JAX's
    flattening (list index order, dict keys sorted)."""
    _, _, jparams, tparams = rg
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert tree_paths(tparams) == jpaths
    assert isinstance(tparams["stages"], list) and len(tparams["stages"]) == 2
    for ours, theirs in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        assert np.array_equal(ours.numpy(), np.asarray(theirs))
    rebuilt = tree_map(lambda t: t + 1, tparams)
    assert isinstance(rebuilt["stages"], list)
    assert torch.equal(rebuilt["stages"][1]["sub0"]["norm1"],
                       tparams["stages"][1]["sub0"]["norm1"] + 1)


def test_init_matches_jax_tree_structure_and_dtypes(rg):
    jcfg, tcfg, jparams, _ = rg
    ours = tm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(tree_leaves(ours)) == len(flat)
    for t, (_, j) in zip(tree_leaves(ours), flat):
        assert tuple(t.shape) == j.shape and str(t.dtype).endswith(str(j.dtype))
    # the one deterministic leaf: linspace agrees to an ulp, which
    # log(expm1(.)) of a small number amplifies to a few 1e-6 relative
    lam = ours["stages"][0]["sub0"]["rec"]["lam"]
    np.testing.assert_allclose(lam.numpy(),
                               np.asarray(jparams["stages"][0]["sub0"]["rec"]["lam"]),
                               rtol=1e-5)


def test_compute_copy_casts_all_but_lam_and_shares_what_is_in_place(rg):
    _, tcfg, _, tparams = rg
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    copy = tm.compute_copy(tparams, bf, device="cpu")
    for path, leaf in zip(tree_paths(copy), tree_leaves(copy)):
        assert leaf.dtype == (torch.float32 if path.endswith("lam") else torch.bfloat16)
    again = tm.compute_copy(copy, bf, device="cpu")
    assert all(a is b for a, b in zip(tree_leaves(again), tree_leaves(copy)))


# ------------------------------------------------------------------ layers
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    _close(tlayers.apply_rope(_t(x), _t(pos), 10_000.0),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    h = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    gain = rng.standard_normal((24,)).astype(np.float32)
    _close(tlayers.rms_norm(_t(h), _t(gain), 1e-6),
           jlayers.rms_norm(jnp.asarray(h), jnp.asarray(gain), 1e-6))
    mats = {name: {"w": (rng.standard_normal(shape) / 5).astype(np.float32)}
            for name, shape in (("wi", (24, 40)), ("wg", (24, 40)), ("wo", (40, 24)))}
    for kind in ("swiglu", "geglu", "gelu", "relu_sq"):
        _close(tlayers.mlp(params_from_jax(mats, device="cpu"), _t(h), kind),
               jlayers.mlp(jax.tree.map(jnp.asarray, mats), jnp.asarray(h), kind))


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(tlayers.gelu(_t(x)), jax.nn.gelu(jnp.asarray(x)), atol=1e-6, rtol=0)


# --------------------------------------------------------------- attention
def _qkv(rng, b, s, h, n_kv, d, skv=None):
    skv = skv or s
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, n_kv, d)).astype(np.float32),
            rng.standard_normal((b, skv, n_kv, d)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 5])
def test_full_and_blockwise_attention_match_jax(window):
    q, k, v = _qkv(np.random.default_rng(1), 2, 16, 4, 1, 8)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(_t, (q, k, v))
    _close(tattn.full_attention(tq, tk, tv, causal=True, window=window),
           jattn.full_attention(jq, jk, jv, causal=True, window=window))
    _close(tattn.blockwise_attention(tq, tk, tv, causal=True, window=window,
                                     q_chunk=4, kv_chunk=8),
           jattn.blockwise_attention(jq, jk, jv, causal=True, window=window,
                                     q_chunk=4, kv_chunk=8))


def test_banded_attention_matches_jax_at_a_48_token_prompt():
    q, k, v = _qkv(np.random.default_rng(2), 2, 48, 4, 1, 16)
    _close(tattn.banded_attention(_t(q), _t(k), _t(v), window=16, q_chunk=16),
           jattn.banded_attention(*map(jnp.asarray, (q, k, v)), window=16, q_chunk=16))


def test_banded_attention_refuses_a_ragged_prompt_as_jax_asserts():
    """At the smoke window of 16 a 40-token prompt is not a whole number of
    16-token chunks; the JAX version fails its assert, the port raises."""
    q, k, v = map(_t, _qkv(np.random.default_rng(3), 1, 40, 4, 1, 16))
    with pytest.raises(ValueError, match="multiple of q_chunk"):
        tattn.banded_attention(q, k, v, window=16, q_chunk=16)
    with pytest.raises(AssertionError):
        jattn.banded_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                               window=16, q_chunk=16)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_matches_jax(window):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 3, 1, 4, 2, 8, skv=20)
    lengths = np.array([1, 7, 20], np.int32)
    _close(tattn.decode_attention(_t(q), _t(k), _t(v), _t(lengths, torch.long),
                                  window=window),
           jattn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                  jnp.asarray(lengths), window=window))


# ------------------------------------------------------------------ RG-LRU
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rglru_block_matches_jax(rg, mode, use_pallas):
    jcfg, tcfg, jparams, tparams = rg
    jcfg = dataclasses.replace(jcfg, use_pallas_scan=use_pallas)
    tcfg = dataclasses.replace(tcfg, use_pallas_scan=use_pallas)
    jp = jax.tree.map(lambda a: a[0], jparams["stages"][0]["sub0"]["rec"])
    tp = tree_map(lambda t: t[0], tparams["stages"][0]["sub0"]["rec"])
    rng = np.random.default_rng(5)
    s = 1 if mode == "decode" else 9
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    w = tcfg.lru_width
    cache = None
    if mode != "train":
        cache = {"h": rng.standard_normal((2, w)).astype(np.float32),
                 "conv": rng.standard_normal((2, tcfg.conv1d_width - 1, w)).astype(np.float32)}
    jy, jc = jrglru.rglru_block(jp, jcfg, jnp.asarray(x),
                                cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    ty, tc = trglru.rglru_block(tp, tcfg, _t(x),
                                cache=None if cache is None else tree_map(_t, cache))
    _close(ty, jy)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])


# ------------------------------------------------------------- whole model
def test_forward_matches_jax_through_banded_attention(rg):
    jcfg, tcfg, jparams, tparams = rg
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 48)).astype(np.int32)
    jl, jaux = jm.forward(jparams, jcfg, jnp.asarray(toks))
    tl, taux = tm.forward(tparams, tcfg, _t(toks, torch.long))
    _close(taux, jaux)
    assert tl.shape == (2, 48, tcfg.padded_vocab)
    _close(tl, jl)


def test_prefill_and_20_decode_steps_match_jax(rg):
    """Prefill 12 tokens, then decode 20 more: the swa ring (window 16)
    wraps, and every step's logits agree; so do the caches at the end."""
    jcfg, tcfg, jparams, tparams = rg
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    jc = jm.init_cache(jcfg, 2, 40)
    tc = tm.init_cache(tcfg, 2, 40, device="cpu")
    jlog, jc, jlen = jm.prefill(jparams, jcfg, jnp.asarray(prompt), jc)
    tlog, tc, tlen = tm.prefill(tparams, tcfg, _t(prompt, torch.long), tc)
    _close(tlog, jlog)
    assert tlen.tolist() == np.asarray(jlen).tolist()
    jdecode = jax.jit(lambda p, t, c, n: jm.decode_step(p, jcfg, t, c, n))
    for _ in range(20):
        tok = rng.integers(0, tcfg.vocab, (2, 1)).astype(np.int32)
        jlog, jc = jdecode(jparams, jnp.asarray(tok), jc, jlen)
        tlog, tc = tm.decode_step(tparams, tcfg, _t(tok, torch.long), tc, tlen)
        _close(tlog, jlog)
        jlen, tlen = jlen + 1, tlen + 1
    assert tree_paths(tc) == tree_paths(params_from_jax(jax.device_get(jc), device="cpu"))
    for ours, theirs in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(ours, theirs)


def test_forward_loss_and_grads_match_jax_through_the_associative_scan():
    """``use_pallas_scan=False``: training's RG-LRU scans are associative in
    both packages (48 tokens through banded attention)."""
    check_forward_loss_and_grads("recurrentgemma-2b", seq=48)


def test_prefill_and_20_decode_steps_match_jax_through_the_sequential_scan():
    """``use_pallas_scan=False``: the cache branch's sequential scan in both
    packages, through prefill and 20 decode steps (the swa ring wraps)."""
    check_prefill_and_decode("recurrentgemma-2b", prompt=12, steps=20)


@pytest.mark.parametrize("variant", [
    {},
    {"pos": "learned", "tie_embeddings": True, "pad_vocab_to_multiple": 96},
], ids=["rope", "learned-tied-padded"])
def test_full_attention_arch_matches_jax(variant):
    """The ``full`` mixer with a contiguous cache, qkv bias and SwiGLU, on
    qwen1.5-4b's smoke config, built as an ``LMConfig`` from the JAX one's
    fields (the model functions take any LMConfig); and the same with
    learned positions, tied embeddings and a padded vocab whose padding
    columns are masked out of the logits."""
    jcfg = dataclasses.replace(jax_get_arch("qwen1.5-4b").smoke_config(), **variant)
    tcfg = LMConfig(**dataclasses.asdict(jcfg))
    jparams = jax.jit(jm.init, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(8)
    toks = rng.integers(0, tcfg.vocab, (2, 10)).astype(np.int32)
    _close(tm.forward(tparams, tcfg, _t(toks, torch.long))[0],
           jm.forward(jparams, jcfg, jnp.asarray(toks))[0])
    jc, tc = jm.init_cache(jcfg, 2, 16), tm.init_cache(tcfg, 2, 16, device="cpu")
    jlog, jc, jlen = jm.prefill(jparams, jcfg, jnp.asarray(toks[:, :6]), jc)
    tlog, tc, tlen = tm.prefill(tparams, tcfg, _t(toks[:, :6], torch.long), tc)
    _close(tlog, jlog)
    jdecode = jax.jit(lambda p, t, c, n: jm.decode_step(p, jcfg, t, c, n))
    for i in range(6, 10):
        tok = toks[:, i:i + 1]
        jlog, jc = jdecode(jparams, jnp.asarray(tok), jc, jlen)
        tlog, tc = tm.decode_step(tparams, tcfg, _t(tok, torch.long), tc, tlen)
        _close(tlog, jlog)
        jlen, tlen = jlen + 1, tlen + 1
