"""Model FLOPs of ST-LLM on DeepSeek-V2-Lite's block
(``bench/models/stllm_ds2lite.py``): 2*m*n*k a product, attention's scores
and weighted values over the whole ``[S, S]`` square a head and window (the
reference materialises it and masks); in training each weight's gradient,
and the input's for every product but the patch embedding (the windows take
no gradient).  The routed experts' products take ``tokens * k`` rows
whatever the routing.  No diffusion hops, so no ``hop_shapes``."""
from __future__ import annotations


def routed_expert_flops(cfg: dict, assignments: int, *, train: bool) -> int:
    """The routed experts' products over ``assignments`` token-expert pairs
    (the three SwiGLU products of width ``moe_intermediate_size``)."""
    forward = 3 * 2 * assignments * cfg["hidden_size"] * cfg["moe_intermediate_size"]
    return 3 * forward if train else forward


def shared_expert_flops(cfg: dict, tokens: int, *, train: bool) -> int:
    """The shared experts' products of one MoE layer over ``tokens``."""
    width = cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    forward = 3 * 2 * tokens * cfg["hidden_size"] * width
    return 3 * forward if train else forward


def flops(cfg: dict, batch: int, *, train: bool) -> int:
    """Product FLOPs of one forward (``train``: with its backward) over a
    batch of ``batch`` windows."""
    n = cfg["num_nodes"]
    tokens = batch * n
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])
    t_in = cfg["input_len"] * cfg["in_features"]
    mult = 3 if train else 1  # forward, and the input's and the weight's gradients
    # the patch embedding: its input (the windows) takes no gradient
    total = 2 * tokens * t_in * d * (2 if train else 1)
    mla = 2 * tokens * (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d)
    scores = 2 * batch * h * n * n * ((dn + dr) + dv)
    dense = cfg["first_k_dense_replace"]
    moe_layers = cfg["num_hidden_layers"] - dense
    total += mult * cfg["num_hidden_layers"] * (mla + scores)
    total += mult * dense * 3 * 2 * tokens * d * cfg["intermediate_size"]
    k, e = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    total += moe_layers * (mult * 2 * tokens * d * e
                           + routed_expert_flops(cfg, tokens * k, train=train)
                           + shared_expert_flops(cfg, tokens, train=train))
    total += mult * 2 * tokens * d * cfg["horizon"] * cfg["out_features"]
    return total
