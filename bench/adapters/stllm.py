"""ST-LLM on the port (``repro_torch.models.stllm``) with the LM backbone
its configuration states: the configuration's published keys (DeepSeek-V2's
``config.json`` names) turned into the port's ``LMConfig``, its routing and
YaRN as ``MoEConfig`` and ``YaRNConfig`` fields, every assignment computed
(dropless), float32.  ST-LLM takes no graph operator, so ``adjacency``
goes unused.

On a card it sets the caching allocator's expandable segments for the
process (see ``build``).

``counters()``: the port's MoE counters (``repro_torch.tracing.count``),
accumulated on the device over every forward and read here in one copy:
``moe.assignments`` (routed token-expert pairs computed), ``moe.dropped``
and ``moe.max_load`` (the largest expert's assignments, summed over layers
and steps).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


def backbone_config(config: dict):
    """The port's ``LMConfig`` of the configuration's backbone keys."""
    from repro_torch.models.lm.config import LMConfig, MLAConfig, MoEConfig, YaRNConfig

    y = config["rope_scaling"]
    return LMConfig(
        name="stllm-backbone", layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"], d_ff=config["moe_intermediate_size"],
        head_dim=config["v_head_dim"], vocab=1, attn="mla", pos="rope",
        rope_theta=float(config["rope_theta"]),
        rope_scaling=YaRNConfig(
            factor=float(y["factor"]),
            original_max_position_embeddings=y["original_max_position_embeddings"],
            beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
            mscale=float(y["mscale"]), mscale_all_dim=float(y["mscale_all_dim"])),
        mlp="swiglu", norm_eps=config["rms_norm_eps"], dtype="float32",
        param_dtype="float32",
        mla=MLAConfig(kv_lora_rank=config["kv_lora_rank"],
                      qk_nope_head_dim=config["qk_nope_head_dim"],
                      qk_rope_head_dim=config["qk_rope_head_dim"],
                      v_head_dim=config["v_head_dim"]),
        moe=MoEConfig(n_experts=config["n_routed_experts"],
                      top_k=config["num_experts_per_tok"],
                      n_shared=config["n_shared_experts"],
                      d_expert=config["moe_intermediate_size"],
                      first_k_dense=config["first_k_dense_replace"],
                      dense_d_ff=config["intermediate_size"],
                      aux_loss_coef=config["aux_loss_alpha"],
                      norm_topk_prob=config["norm_topk_prob"],
                      routed_scaling_factor=float(config["routed_scaling_factor"]),
                      seq_aux=config["seq_aux"], dropless=True))


def counters() -> dict:
    from repro_torch.tracing import counts

    return counts()


def build(config: dict, traffic: dict, adjacency: np.ndarray, device):
    from repro_torch import tracing
    from repro_torch.models import stllm

    cfg = stllm.STLLMConfig(num_nodes=config["num_nodes"],
                            in_features=config["in_features"],
                            out_features=config["out_features"],
                            input_len=config["input_len"], horizon=config["horizon"],
                            backbone=backbone_config(config))
    tracing.count_on()
    if torch.device(device).type == "cuda":
        # 2.43 B float32 parameters with their gradients and AdamW moments fill
        # most of the card, and the reference's functional AdamW after the
        # window holds seven copies of them: expandable segments keep the
        # caching allocator from fragmenting around the 2.75 GiB expert
        # stacks (as PYTORCH_CUDA_ALLOC_CONF would, set for this process)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings("expandable_segments:True")

    def loss(params, x, y):
        return stllm.loss_fn(params, cfg, x, y)

    def forecast(params, x):
        return stllm.apply(params, cfg, x)

    return loss, forecast
