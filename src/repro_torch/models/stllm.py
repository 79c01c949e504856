"""ST-LLM-style model (Liu et al. 2024) — the paper's §5.5 scaling-study model.

Spatial-temporal tokenisation: each graph node's input window [T', F] becomes
one token via a linear patch embedding, plus learned spatial (per-node) and
time-of-day embeddings; the token sequence (length N) runs through the LM
backbone (GPT2-style here, built from ``repro_torch.models.lm``); a
regression head maps each node token to its horizon forecast.
Index-batching applies unchanged: the model consumes the same
sequence-to-sequence windows.

The backbone attends causally over the node order, as the reference does.
Above ``lm.model.BLOCKWISE_THRESHOLD`` nodes its attention is blockwise in
chunks of ``q_chunk = 512``, which must divide N: both packages refuse other
graphs of that size (the JAX package asserts, the port raises
``ValueError``).

``loss_fn`` passes no ``tod_index``, and the backbone never embeds tokens or
computes logits, so ``tod``, ``backbone.embed`` and ``backbone.lm_head`` get
zero gradients in training, as under ``jax.value_and_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import model as lm
from repro_torch.models.lm.config import LMConfig


@dataclasses.dataclass(frozen=True)
class STLLMConfig:
    num_nodes: int
    in_features: int = 2
    out_features: int = 1
    input_len: int = 12
    horizon: int = 12
    d_model: int = 256
    layers: int = 6
    n_heads: int = 8
    d_ff: int = 1024
    steps_per_day: int = 288
    dtype: str = "float32"

    def backbone_config(self) -> LMConfig:
        return LMConfig(
            name="stllm-backbone", layers=self.layers, d_model=self.d_model,
            n_heads=self.n_heads, n_kv_heads=self.n_heads, d_ff=self.d_ff,
            vocab=1, attn="full", pos="none", mlp="gelu",
            dtype=self.dtype, param_dtype="float32",
        )


def init(generator: torch.Generator, cfg: STLLMConfig,
         device: str | torch.device = "cuda") -> dict[str, Any]:
    """Random parameters drawn from ``generator`` on the generator's own
    device and placed on ``device``; tree, shapes and scales as the JAX
    package's ``init`` (the backbone is ``lm.model.init``'s)."""
    dev = resolve_device(device)
    in_dim = cfg.input_len * cfg.in_features
    out_dim = cfg.horizon * cfg.out_features

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device).to(dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return {
        "patch": {"w": normal(in_dim, cfg.d_model) / in_dim ** 0.5,
                  "b": zeros(cfg.d_model)},
        "spatial": normal(cfg.num_nodes, cfg.d_model) * 0.02,
        "tod": normal(cfg.steps_per_day, cfg.d_model) * 0.02,
        "backbone": lm.init(generator, cfg.backbone_config(), device=dev),
        "head": {"w": normal(cfg.d_model, out_dim) / cfg.d_model ** 0.5,
                 "b": zeros(out_dim)},
    }


def apply(params, cfg: STLLMConfig, x_seq: torch.Tensor, *,
          tod_index: torch.Tensor | None = None) -> torch.Tensor:
    """x_seq: [B, T', N, F] -> [B, horizon, N, out_features].

    ``tod_index``: [B] time-of-day bucket of each window's start, or None.
    """
    b, t, n, f = x_seq.shape
    # one token a node: its window, time-major then feature
    tokens = x_seq.permute(0, 2, 1, 3).reshape(b, n, t * f)
    x = tokens @ params["patch"]["w"].to(tokens.dtype) + params["patch"]["b"]
    x = x + params["spatial"][None].to(x.dtype)
    if tod_index is not None:
        x = x + params["tod"][tod_index][:, None].to(x.dtype)
    h, _ = lm.backbone(params["backbone"], cfg.backbone_config(), x)
    out = h.float() @ params["head"]["w"] + params["head"]["b"]
    out = out.reshape(b, n, cfg.horizon, cfg.out_features)
    return out.permute(0, 2, 1, 3)


def loss_fn(params, cfg: STLLMConfig, x, y):
    """Mean absolute error against ``y``'s first ``out_features`` channels."""
    pred = apply(params, cfg, x)
    return torch.mean(torch.abs(pred - y[..., : cfg.out_features]))
