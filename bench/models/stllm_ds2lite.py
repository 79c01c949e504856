"""Plain reference of ST-LLM (Liu et al., arXiv:2401.04463) with DeepSeek-V2-
Lite's block as its backbone (arXiv:2405.04434; the configuration's keys are
those of the model's published config.json), in float32.

ST-LLM: each sensor's window ``[T, F]`` is one token, projected to
``hidden_size``, plus a learned per-node embedding; the tokens run causally
over the node order (rope positions 0..N-1) through the backbone; a final
RMSNorm and a head give each node's ``horizon`` forecasts.  Loss: the mean
absolute error against the first feature, plus each MoE layer's balance
loss.

The backbone's layers, pre-norm (RMSNorm with a gain, eps ``rms_norm_eps``)
around each of:

- MLA without a query LoRA: ``q = x Wq`` (per head ``qk_nope_head_dim`` +
  ``qk_rope_head_dim``), ``[c ‖ k_pe] = x Wdkv``, ``c`` normed, ``[k_nope ‖
  v] = c Wukv`` per head, rope on ``q_pe`` and the shared ``k_pe``, causal
  softmax attention at scale ``(nope + rope) ** -0.5 * mscale ** 2``, ``Wo``;
- YaRN rope, as DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``: the
  frequencies blended between ``theta``-extrapolated and
  ``factor``-interpolated by a linear ramp between the pair indices that
  ``beta_fast`` and ``beta_slow`` rotations bound at
  ``original_max_position_embeddings``; cos and sin times
  ``mscale(mscale) / mscale(mscale_all_dim)``;
- the first ``first_k_dense_replace`` layers a SwiGLU of width
  ``intermediate_size``; every later one a softmax router over
  ``n_routed_experts``, greedy top-``num_experts_per_tok`` weights (not
  renormalised where ``norm_topk_prob`` is false) times
  ``routed_scaling_factor``, each expert (a SwiGLU of width
  ``moe_intermediate_size``) applied to the tokens that picked it, plus
  ``n_shared_experts`` shared experts as one SwiGLU; and the per-sequence
  balance loss ``alpha * mean_b sum_e f_be P_be`` (``seq_aux``), ``f_be``
  expert e's picks in window b over ``S k / E``, ``P_be`` its mean
  probability there, ``alpha`` the configuration's ``aux_loss_alpha``.

Departures, as the program has them: the rope pairs a head's halves where
DeepSeek-V2 interleaves pairs (a fixed permutation of the rope columns of
``Wq`` and ``Wdkv``, which random weights cannot tell apart); ST-LLM has no
vocabulary (node tokens enter through the patch embedding), so there is no
token table or logit head.  Every product goes through ``mm``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.inputs import ONES

#: ST-LLM's node embedding is drawn at 0.02, its root's scale.
EMBED_FAN = 2500


def _sizes(cfg: dict) -> dict:
    n_moe = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    return dict(d=cfg["hidden_size"], h=cfg["num_attention_heads"],
                dn=cfg["qk_nope_head_dim"], dr=cfg["qk_rope_head_dim"],
                dv=cfg["v_head_dim"], r=cfg["kv_lora_rank"], e=cfg["n_routed_experts"],
                de=cfg["moe_intermediate_size"],
                ds=cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
                dff=cfg["intermediate_size"], dense=cfg["first_k_dense_replace"], moe=n_moe,
                t_in=cfg["input_len"] * cfg["in_features"],
                out=cfg["horizon"] * cfg["out_features"])


def param_specs(cfg: dict) -> list:
    """``(path, shape, fan_in)`` of every leaf, in the port's tree layout
    (``stages`` 0 the dense layers, 1 the MoE layers, each leaf stacked
    over its stage's layers), largest leaves first.  The leaves of the
    port's tree that no ST-LLM loss reads (the time-of-day table, the
    backbone's token table and logit head) are left out: the program reads
    none of them either."""
    z = _sizes(cfg)
    d, h, dn, dr, dv, r = z["d"], z["h"], z["dn"], z["dr"], z["dv"], z["r"]

    def attn(stage, n):
        a = ("backbone", "stages", stage, "sub0", "attn")
        return [(a + ("wq", "w"), (n, d, h * (dn + dr)), d),
                (a + ("wdkv", "w"), (n, d, r + dr), d),
                (a + ("ckv_norm",), (n, r), ONES),
                (a + ("wukv", "w"), (n, r, h * (dn + dv)), r),
                (a + ("wo", "w"), (n, h * dv, d), h * dv)]

    def norms(stage, n):
        s = ("backbone", "stages", stage, "sub0")
        return [(s + ("norm1",), (n, d), ONES), (s + ("norm2",), (n, d), ONES)]

    specs = []
    if z["moe"]:
        n, m = z["moe"], ("backbone", "stages", 1, "sub0", "moe")
        specs += [(m + ("wi",), (n, z["e"], d, z["de"]), d),
                  (m + ("wg",), (n, z["e"], d, z["de"]), d),
                  (m + ("wo",), (n, z["e"], z["de"], d), z["de"])]
        if z["ds"]:
            specs += [(m + ("shared", "wi", "w"), (n, d, z["ds"]), d),
                      (m + ("shared", "wg", "w"), (n, d, z["ds"]), d),
                      (m + ("shared", "wo", "w"), (n, z["ds"], d), z["ds"])]
    if z["dense"]:
        n, f = z["dense"], ("backbone", "stages", 0, "sub0", "mlp")
        specs += [(f + ("wi", "w"), (n, d, z["dff"]), d),
                  (f + ("wg", "w"), (n, d, z["dff"]), d),
                  (f + ("wo", "w"), (n, z["dff"], d), z["dff"])]
    for stage, n in ((1, z["moe"]), (0, z["dense"])):
        if n:
            specs += attn(stage, n)
    specs += [(("spatial",), (cfg["num_nodes"], d), EMBED_FAN)]
    if z["moe"]:
        specs += [(("backbone", "stages", 1, "sub0", "moe", "router", "w"),
                   (z["moe"], d, z["e"]), d)]
    specs += [(("patch", "w"), (z["t_in"], d), z["t_in"]), (("patch", "b"), (d,), None),
              (("head", "w"), (d, z["out"]), d), (("head", "b"), (z["out"],), None),
              (("backbone", "final_norm"), (d,), ONES)]
    for stage, n in ((1, z["moe"]), (0, z["dense"])):
        if n:
            specs += norms(stage, n)
    return specs


def graph(adjacency: torch.Tensor):
    """No graph operator: the node tokens attend over the node order."""
    return None


def rms_norm(x, gain, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * gain


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_cos_sin(cfg: dict, seq: int, device):
    """cos and sin ``[seq, rope dim]`` of DeepSeek-V2's YaRN rotary
    embedding (``emb = cat(freqs, freqs)``)."""
    y, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    factor, orig = float(y["factor"]), y["original_max_position_embeddings"]

    def pair_index(rotations):
        return (dim * math.log(orig / (rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(pair_index(y["beta_fast"])), 0)
    high = min(math.ceil(pair_index(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (factor * base ** exps)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = t[:, None] * inv_freq[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    gain = yarn_mscale(factor, y["mscale"]) / yarn_mscale(factor, y["mscale_all_dim"])
    return emb.cos() * gain, emb.sin() * gain


def rope(x, cos, sin):
    """x [S, ..., D] rotated by halves: ``x cos + rotate_half(x) sin``."""
    half = x.shape[-1] // 2
    rotated = torch.cat((-x[..., half:], x[..., :half]), dim=-1)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 2) + (cos.shape[1],)
    return x * cos.reshape(shape) + rotated * sin.reshape(shape)


def softmax_scale(cfg: dict) -> float:
    y = cfg["rope_scaling"]
    m = yarn_mscale(float(y["factor"]), y["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def mla(p, cfg: dict, x, cos, sin, mm):
    """One window's causal MLA; x: [S, d] -> [S, d]."""
    z = _sizes(cfg)
    s, h, dn, dr, dv, r = x.shape[0], z["h"], z["dn"], z["dr"], z["dv"], z["r"]
    q = mm(x, p["wq"]["w"]).reshape(s, h, dn + dr)
    ckv = mm(x, p["wdkv"]["w"])
    c = rms_norm(ckv[:, :r], p["ckv_norm"], cfg["rms_norm_eps"])
    k_pe = rope(ckv[:, r:], cos, sin)
    kv = mm(c, p["wukv"]["w"]).reshape(s, h, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe[:, None, :].expand(s, h, dr)], dim=-1)
    future = torch.ones((s, s), dtype=torch.bool, device=x.device).triu(1)
    scale = softmax_scale(cfg)
    heads = []
    for i in range(h):
        scores = mm(q[:, i], k[:, i].T) * scale
        probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
        heads.append(mm(probs, kv[:, i, dn:]))
    return mm(torch.cat(heads, dim=-1), p["wo"]["w"])


def swiglu(x, wi, wg, wo, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wi), wo)


def moe(p, cfg: dict, x, windows: int, mm):
    """The routed and shared experts of ``windows`` windows' tokens x:
    [windows * S, d] -> ([windows * S, d], the balance loss)."""
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(x, p["router"]["w"]), dim=-1)
    top_w, top_ix = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    top_w = top_w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for i in range(e):
        token, slot = torch.nonzero(top_ix == i, as_tuple=True)
        if token.numel():
            out = swiglu(x[token], p["wi"][i], p["wg"][i], p["wo"][i], mm)
            y = y.index_add(0, token, out * top_w[token, slot][:, None])
    if cfg["n_shared_experts"]:
        sh = p["shared"]
        y = y + swiglu(x, sh["wi"]["w"], sh["wg"]["w"], sh["wo"]["w"], mm)
    seq = x.shape[0] // windows
    picks = torch.zeros((windows, e), device=x.device).scatter_add_(
        1, top_ix.reshape(windows, seq * k), torch.ones((windows, seq * k), device=x.device))
    f = picks / (seq * k / e)
    aux = (f * probs.reshape(windows, seq, e).mean(dim=1)).sum(dim=1).mean()
    return y, cfg["aux_loss_alpha"] * aux


def _layer(params, stage: int, i: int):
    """Layer ``i`` of stage ``stage``'s stacked leaves."""
    def pick(node):
        return {k: pick(v) for k, v in node.items()} if isinstance(node, dict) else node[i]
    return pick(params["backbone"]["stages"][stage]["sub0"])


def _forward(params, cfg: dict, x, mm):
    """(forecasts [B, horizon, N, out], the summed balance loss)."""
    b, t, n, f = x.shape
    d, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
    tokens = x.permute(0, 2, 1, 3).reshape(b * n, t * f)
    hid = mm(tokens, params["patch"]["w"]) + params["patch"]["b"]
    hid = (hid.reshape(b, n, d) + params["spatial"]).reshape(b * n, d)
    cos, sin = yarn_cos_sin(cfg, n, x.device)
    aux = torch.zeros((), device=x.device)
    layers = [(0, i) for i in range(cfg["first_k_dense_replace"])] + \
        [(1, i) for i in range(cfg["num_hidden_layers"] - cfg["first_k_dense_replace"])]
    for stage, i in layers:
        lp = _layer(params, stage, i)
        a = rms_norm(hid, lp["norm1"], eps)
        hid = hid + torch.cat([mla(lp["attn"], cfg, a[w * n:(w + 1) * n], cos, sin, mm)
                               for w in range(b)])
        a = rms_norm(hid, lp["norm2"], eps)
        if stage == 0:
            m = lp["mlp"]
            hid = hid + swiglu(a, m["wi"]["w"], m["wg"]["w"], m["wo"]["w"], mm)
        else:
            out, layer_aux = moe(lp["moe"], cfg, a, b, mm)
            hid, aux = hid + out, aux + layer_aux
    hid = rms_norm(hid, params["backbone"]["final_norm"], eps)
    y = mm(hid, params["head"]["w"]) + params["head"]["b"]
    return y.reshape(b, n, cfg["horizon"], cfg["out_features"]).permute(0, 2, 1, 3), aux


def forward(params, cfg: dict, graph, x, mm):
    """x: [B, T, N, F] -> [B, horizon, N, out]; ``mm`` the 2-D product."""
    return _forward(params, cfg, x, mm)[0]


def loss(params, cfg: dict, graph, x, y, mm):
    pred, aux = _forward(params, cfg, x, mm)
    return torch.mean(torch.abs(pred - y[..., :cfg["out_features"]])) + aux
