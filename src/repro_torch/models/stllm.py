"""ST-LLM-style model (Liu et al. 2024) — the paper's §5.5 scaling-study model.

Spatial-temporal tokenisation: each graph node's input window [T', F] becomes
one token via a linear patch embedding, plus learned spatial (per-node) and
time-of-day embeddings; the token sequence (length N) runs through the LM
backbone (GPT2-style here, built from ``repro_torch.models.lm``); a
regression head maps each node token to its horizon forecast.
Index-batching applies unchanged: the model consumes the same
sequence-to-sequence windows.

The backbone attends causally over the node order, as the reference does
(rope positions 0..N-1).  Above ``lm.model.BLOCKWISE_THRESHOLD`` nodes its
attention is blockwise in chunks of ``q_chunk = 512``, the last chunk
shorter where 512 does not divide N (the JAX package asserts 512 | N), and
trains with a backward that recomputes a query chunk at a time.

``STLLMConfig.backbone`` swaps the GPT-2-style stand-in for any LM
backbone config (``configs/stgnn.py``: DeepSeek-V2-Lite's MLA and MoE
block, the port's own addition); the backbone's MoE balance loss then joins
the MAE.  ``loss_fn`` passes no ``tod_index``, and the backbone never embeds
tokens or computes logits, so ``tod``, ``backbone.embed`` and
``backbone.lm_head`` get zero gradients in training, as under
``jax.value_and_grad``.
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
    #: the LM backbone; None: the GPT-2-style stand-in of the fields above
    backbone: LMConfig | None = None

    @property
    def width(self) -> int:
        """The token width: the backbone's ``d_model``."""
        return self.backbone_config().d_model

    def backbone_config(self) -> LMConfig:
        if self.backbone is not None:
            return self.backbone
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

    d = cfg.width
    return {
        "patch": {"w": normal(in_dim, d) / in_dim ** 0.5, "b": zeros(d)},
        "spatial": normal(cfg.num_nodes, d) * 0.02,
        "tod": normal(cfg.steps_per_day, d) * 0.02,
        "backbone": lm.init(generator, cfg.backbone_config(), device=dev),
        "head": {"w": normal(d, out_dim) / d ** 0.5, "b": zeros(out_dim)},
    }


def apply(params, cfg: STLLMConfig, x_seq: torch.Tensor, *,
          tod_index: torch.Tensor | None = None) -> torch.Tensor:
    """x_seq: [B, T', N, F] -> [B, horizon, N, out_features].

    ``tod_index``: [B] time-of-day bucket of each window's start, or None.
    """
    return _forward(params, cfg, x_seq, tod_index)[0]


def _forward(params, cfg: STLLMConfig, x_seq, tod_index=None):
    """(forecasts, the backbone's summed auxiliary loss)."""
    b, t, n, f = x_seq.shape
    # one token a node: its window, time-major then feature
    tokens = x_seq.permute(0, 2, 1, 3).reshape(b, n, t * f)
    x = tokens @ params["patch"]["w"].to(tokens.dtype) + params["patch"]["b"]
    x = x + params["spatial"][None].to(x.dtype)
    if tod_index is not None:
        x = x + params["tod"][tod_index][:, None].to(x.dtype)
    h, aux = lm.backbone(params["backbone"], cfg.backbone_config(), x)
    out = h.float() @ params["head"]["w"] + params["head"]["b"]
    out = out.reshape(b, n, cfg.horizon, cfg.out_features)
    return out.permute(0, 2, 1, 3), aux


def loss_fn(params, cfg: STLLMConfig, x, y):
    """Mean absolute error against ``y``'s first ``out_features`` channels,
    plus the backbone's MoE balance loss where it has MoE layers (each
    window's ``N`` node tokens one sequence)."""
    pred, aux = _forward(params, cfg, x)
    mae = torch.mean(torch.abs(pred - y[..., : cfg.out_features]))
    return mae + aux if cfg.backbone_config().moe is not None else mae
