"""ST-LLM on DeepSeek-V2-Lite's block (the port's own arch
``stllm-ds2lite-pems-all-la``) against the plain reference kept outside both
packages, ``tests/reference/stllm_ds2lite.py``, a byte-identical copy of the
benchmark's ``bench/models/stllm_ds2lite.py``: seeded weights drawn by the
benchmark's ``make_params``, float32 on the CPU at a small size, the
published routing, balance loss and YaRN at small widths.

- the forward, the loss (MAE plus each MoE layer's balance loss) and every
  gradient leaf, at the repo's tolerance (atol 1e-5, rtol 1e-4);
- a router skewed so that one expert takes every token: the dropless layer
  drops nothing and gives the reference's output, where the capacity
  layer would drop; the counters read so;
- the per-sequence balance loss against its formula written out by loops;
- YaRN's frequencies, ramp and softmax scale against a direct transcription;
- AdamW in place, bit-equal to the functional update over three steps;
- the registered arch and the benchmark's configuration state one block.
"""
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the reference imports the benchmark's bench.inputs
    sys.path.insert(0, str(REPO))

from bench.inputs import leaves, make_params  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import stllm  # noqa: E402
from repro_torch.models.lm import moe as tmoe  # noqa: E402
from repro_torch.models.lm.config import MLAConfig  # noqa: E402
from repro_torch.models.lm.layers import apply_rope, rope_freqs, yarn_mscale  # noqa: E402
from repro_torch.models.lm.mla import softmax_scale  # noqa: E402
from repro_torch.optim import AdamConfig, apply_updates, init_opt_state  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

REFERENCE = REPO / "tests" / "reference" / "stllm_ds2lite.py"
BENCH_REFERENCE = REPO / "bench" / "models" / "stllm_ds2lite.py"
ARCH_ID = "stllm-ds2lite-pems-all-la"
ATOL, RTOL = 1e-5, 1e-4
YARN = dict(type="yarn", factor=40, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
#: the published keys at small widths (DeepSeek-V2's config.json names)
CFG = dict(num_nodes=24, in_features=2, out_features=1, input_len=4, horizon=3,
           hidden_size=32, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=16,
           qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, intermediate_size=48,
           moe_intermediate_size=16, n_routed_experts=8, num_experts_per_tok=3,
           n_shared_experts=2, first_k_dense_replace=1, num_hidden_layers=3,
           rms_norm_eps=1e-6, rope_theta=10000, rope_scaling=YARN, norm_topk_prob=False,
           routed_scaling_factor=1, seq_aux=True, aux_loss_alpha=0.001)


def _reference():
    spec = importlib.util.spec_from_file_location("stllm_ds2lite_reference", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _port_cfg(cfg: dict) -> stllm.STLLMConfig:
    """The registered arch with ``cfg``'s sizes: its routing, balance loss,
    YaRN and dropless experts as registered."""
    arch = get_arch(ARCH_ID).model
    bb = arch.backbone
    bb = dataclasses.replace(
        bb, layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"],
        mla=MLAConfig(kv_lora_rank=cfg["kv_lora_rank"],
                      qk_nope_head_dim=cfg["qk_nope_head_dim"],
                      qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"]),
        moe=dataclasses.replace(bb.moe, n_experts=cfg["n_routed_experts"],
                                top_k=cfg["num_experts_per_tok"],
                                n_shared=cfg["n_shared_experts"],
                                d_expert=cfg["moe_intermediate_size"],
                                dense_d_ff=cfg["intermediate_size"]))
    return dataclasses.replace(arch, num_nodes=cfg["num_nodes"], input_len=cfg["input_len"],
                               horizon=cfg["horizon"], backbone=bb)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=ATOL,
                               rtol=RTOL, err_msg=msg)


@pytest.fixture
def counting(monkeypatch):
    """The port's counters on, fresh, and off again after the test."""
    monkeypatch.setattr(tracing, "_COUNTS", {})


def test_reference_copy_is_the_benchmarks_byte_for_byte():
    assert REFERENCE.read_bytes() == BENCH_REFERENCE.read_bytes()


def test_registered_arch_and_benchmark_configuration_state_one_block():
    """The launcher's arch and the benchmark's configuration (through its
    adapter) are the same backbone: published widths, routing, YaRN and
    balance loss, 5 of 27 layers, all 64 experts, float32."""
    from bench.adapters.stllm import backbone_config

    arch = get_arch(ARCH_ID)
    assert arch.family == "stgnn" and arch.shapes == () and arch.model.num_nodes == 2716
    bb = arch.model.backbone
    config = json.loads((REPO / "bench" / "configs" / f"{ARCH_ID}.json").read_text())
    assert dataclasses.replace(backbone_config(config), name=bb.name) == bb
    assert (bb.layers, bb.d_model, bb.n_heads, bb.dtype) == (5, 2048, 16, "float32")
    assert (bb.mla.kv_lora_rank, bb.mla.qk_nope_head_dim, bb.mla.qk_rope_head_dim,
            bb.mla.v_head_dim) == (512, 128, 64, 128)
    m = bb.moe
    assert (m.n_experts, m.top_k, m.n_shared, m.d_expert, m.first_k_dense, m.dense_d_ff) == \
        (64, 6, 2, 1408, 1, 10944)
    assert (m.norm_topk_prob, m.routed_scaling_factor, m.seq_aux, m.dropless,
            m.aux_loss_coef) == (False, 1.0, True, True, 0.001)
    y = bb.rope_scaling
    assert (y.factor, y.original_max_position_embeddings, y.beta_fast, y.beta_slow,
            y.mscale, y.mscale_all_dim) == (40.0, 4096, 32.0, 1.0, 0.707, 0.707)


def test_forward_loss_and_every_gradient_match_the_reference(counting):
    params = make_params(REF.param_specs(CFG), 11, "cpu")
    tcfg = _port_cfg(CFG)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, CFG["input_len"], CFG["num_nodes"], 2), generator=g)
    y = torch.randn((2, CFG["horizon"], CFG["num_nodes"], 2), generator=g)
    paths = list(leaves(params))

    def grads_of(loss_fn):
        live = [p.clone().requires_grad_(True) for p in leaves(params).values()]
        tree = tree_map(lambda t: t, params)
        it = iter(live)
        tree = _rebuild(tree, it)
        value = loss_fn(tree)
        return value, torch.autograd.grad(value, live)

    ours, ours_g = grads_of(lambda p: stllm.loss_fn(p, tcfg, x, y))
    want, want_g = grads_of(lambda p: REF.loss(p, CFG, None, x, y, torch.mm))
    _close(ours, want, "loss")
    with torch.no_grad():
        _close(stllm.apply(params, tcfg, x), REF.forward(params, CFG, None, x, torch.mm),
               "forecasts")
    for path, a, b in zip(paths, ours_g, want_g):
        assert a.abs().max() > 0, path
        _close(a, b, "/".join(map(str, path)))
    tokens = 2 * CFG["num_nodes"]
    moe_layers = CFG["num_hidden_layers"] - CFG["first_k_dense_replace"]
    assert tracing.counts()["moe.assignments"] == moe_layers * tokens * 3 * 2  # 2 forwards
    assert tracing.counts()["moe.dropped"] == 0


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _moe_params(cfg: dict, skew: int):
    """One MoE layer's leaves, the router skewed so that expert ``skew``
    has every token's largest logit (inputs whose first entry is 3)."""
    d, e, de = cfg["hidden_size"], cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    g = torch.Generator().manual_seed(2)
    ds = cfg["n_shared_experts"] * de
    router = torch.randn((d, e), generator=g) / d ** 0.5
    router[0, skew] = 5.0  # a logit near 15: the others stay above underflow
    return {"router": {"w": router},
            "wi": torch.randn((e, d, de), generator=g) / d ** 0.5,
            "wg": torch.randn((e, d, de), generator=g) / d ** 0.5,
            "wo": torch.randn((e, de, d), generator=g) / de ** 0.5,
            "shared": {k: {"w": torch.randn(shape, generator=g) / shape[0] ** 0.5}
                       for k, shape in (("wi", (d, ds)), ("wg", (d, ds)), ("wo", (ds, d)))}}


def test_a_skewed_router_drops_nothing_and_matches_the_reference(counting):
    """Every one of 1,024 tokens picks expert 5: twice the capacity the
    capacity path gives an expert (1,024 x 3 / 8 x 1.25 = 480, rounded to
    512).  The dropless layer computes all 3,072 assignments and gives the
    reference's output and balance loss; the capacity layer drops every
    assignment past 512 of each expert."""
    tcfg = _port_cfg(CFG)
    moe = tcfg.backbone.moe
    p = _moe_params(CFG, skew=5)
    x = torch.randn((4, 256, CFG["hidden_size"]), generator=torch.Generator().manual_seed(3))
    x[..., 0] = 3.0
    y, aux = tmoe.moe_ffn(p, x, moe, "swiglu")
    want, want_aux = REF.moe(p, CFG, x.reshape(-1, CFG["hidden_size"]), 4, torch.mm)
    _close(y.reshape(-1, CFG["hidden_size"]), want, "output")
    _close(aux, want_aux, "balance loss")
    assert tracing.counts() == {"moe.assignments": 3072, "moe.dropped": 0, "moe.max_load": 1024}
    picks = torch.topk(x.reshape(-1, CFG["hidden_size"]) @ p["router"]["w"], 3).indices
    load = torch.bincount(picks.reshape(-1), minlength=CFG["n_routed_experts"])
    assert int(load[5]) == 1024
    tmoe.moe_ffn(p, x, dataclasses.replace(moe, dropless=False), "swiglu")
    assert tracing.counts()["moe.dropped"] == int(torch.clamp(load - 512, min=0).sum()) >= 512


def test_sequence_balance_loss_is_its_formula():
    """``alpha * mean_b sum_e f_be P_be``: ``f_be`` the share of sequence
    b's tokens that picked expert e, times E / k (DeepSeek-V2's count over
    ``S k / E``), ``P_be`` e's mean probability over those tokens."""
    moe = _port_cfg(CFG).backbone.moe
    b, s, e, k = 3, 10, moe.n_experts, moe.top_k
    g = torch.Generator().manual_seed(9)
    probs = torch.softmax(torch.randn((b * s, e), generator=g), dim=-1)
    top_ix = torch.topk(probs, k, dim=-1).indices
    want = 0.0
    for i in range(b):
        rows = range(i * s, (i + 1) * s)
        for j in range(e):
            share = sum(int(top_ix[r].eq(j).any()) for r in rows) / s
            want += share * e / k * float(probs[list(rows), j].mean())
    want = moe.aux_loss_coef * want / b
    got = tmoe._balance_loss(moe, probs, top_ix, b)
    assert float(got) == pytest.approx(want, rel=1e-6)


def _yarn_transcribed(dim, base, factor, orig, beta_fast, beta_slow):
    """DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` frequencies, float64."""
    def correction(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction(beta_fast)), 0)
    high = min(math.ceil(correction(beta_slow)), dim - 1)
    pos = np.arange(0, dim, 2) / dim
    extra, inter = 1.0 / base ** pos, 1.0 / (factor * base ** pos)
    ramp = np.clip((np.arange(dim // 2) - low) / (high - low), 0, 1)
    return low, high, inter * ramp + extra * (1 - ramp)


def test_yarn_frequencies_ramp_and_softmax_scale():
    bb = get_arch(ARCH_ID).model.backbone
    y = bb.rope_scaling
    low, high, want = _yarn_transcribed(64, 10000.0, 40.0, 4096, 32.0, 1.0)
    assert (low, high) == (10, 23)
    got = rope_freqs(64, bb.rope_theta, scaling=y)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert yarn_mscale(40.0, 0.707) == pytest.approx(m) and m == pytest.approx(1.2608, abs=1e-4)
    assert softmax_scale(bb) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    # the program's rotation is the reference's (halves, cos/sin gain 1)
    x = torch.randn((1, 50, 2, 64), generator=torch.Generator().manual_seed(1))
    positions = torch.arange(50)[None]
    cos, sin = REF.yarn_cos_sin({"rope_scaling": YARN, "qk_rope_head_dim": 64,
                                 "rope_theta": 10000}, 50, "cpu")
    np.testing.assert_allclose(apply_rope(x, positions, 10000.0, y)[0].numpy(),
                               REF.rope(x[0], cos, sin).numpy(), atol=1e-6, rtol=1e-6)


def test_adamw_in_place_is_the_functional_update_bit_for_bit(monkeypatch):
    """Three clipped steps: the in-place update (moments written where they
    lie, a leaf sliced 5 elements at a time, gradients dropped as applied)
    gives the functional one's parameters and moments exactly."""
    import repro_torch.optim.adam as adam

    monkeypatch.setattr(adam, "SLICE", 5)
    cfg = AdamConfig(lr=1e-3, grad_clip=1.0)
    g = torch.Generator().manual_seed(4)
    params = {"a": torch.randn((6, 7), generator=g), "b": [torch.randn((3,), generator=g)]}
    p1 = p2 = params
    s1, s2 = init_opt_state(params, cfg), init_opt_state(params, cfg)
    moments = s2["m"]["a"]
    for _ in range(3):
        grads = tree_map(lambda t: 5 * torch.randn(t.shape, generator=g), params)
        p1, s1, n1 = apply_updates(p1, tree_map(torch.clone, grads), s1, cfg, 1e-3)
        p2, s2, n2 = apply_updates(p2, grads, s2, cfg, 1e-3, in_place=True)
        assert torch.equal(n1, n2) and grads == {"a": None, "b": [None]}
    for tree in ("params", "m", "v"):
        a = p1 if tree == "params" else s1[tree]
        b = p2 if tree == "params" else s2[tree]
        assert torch.equal(a["a"], b["a"]) and torch.equal(a["b"][0], b["b"][0]), tree
    assert s2["m"]["a"] is moments and not torch.equal(p2["a"], params["a"])
