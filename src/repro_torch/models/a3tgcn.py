"""A3T-GCN (Zhu et al. 2020) — the paper's §5.5 broader-applicability model.

TGCN cell (GRU whose gates are 2-hop GCNs over the symmetric-normalised
adjacency) unrolled over the input window, followed by global temporal
attention over the hidden-state sequence and a final projection to the
horizon.  Matches the PGT ``a3tgcn2`` example the paper integrates with.

Parameters are a nested dict of tensors shaped like the JAX package's pytree
(``gcn_ru``, ``gcn_c``, ``att``, ``proj``), so
``repro_torch.interop.params_from_jax`` carries the reference's weights
across unchanged.  The JAX ``lax.scan`` over time is a Python loop here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class A3TGCNConfig:
    num_nodes: int
    in_features: int = 2
    hidden: int = 32
    input_len: int = 12
    horizon: int = 12


def init(generator: torch.Generator, cfg: A3TGCNConfig,
         device: str | torch.device = "cuda") -> dict[str, Any]:
    """Random parameters drawn from ``generator`` on the generator's own
    device and placed on ``device``; tree, shapes and initialisation rules
    as the JAX package's ``init`` (Glorot-style normals with variance
    ``2 / (fan_in + fan_out)``, zero biases, ``gcn_ru.b2`` ones)."""
    dev = resolve_device(device)
    in_dim, h = cfg.in_features, cfg.hidden

    def glorot(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * (2.0 / sum(shape[-2:])) ** 0.5).to(dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return {
        # two-layer GCN inside each gate: (in+h) -> h
        "gcn_ru": {"w1": glorot(in_dim + h, 2 * h), "b1": zeros(2 * h),
                   "w2": glorot(2 * h, 2 * h),
                   "b2": torch.ones((2 * h,), dtype=torch.float32, device=dev)},
        "gcn_c": {"w1": glorot(in_dim + h, h), "b1": zeros(h),
                  "w2": glorot(h, h), "b2": zeros(h)},
        "att": {"w": glorot(h, 1), "b": zeros(1)},
        "proj": {"w": glorot(h, cfg.horizon), "b": zeros(cfg.horizon)},
    }


def _gcn(p, a_hat, x):
    """Two-hop GCN: A(A X W1 + b1) W2 + b2, x: [B, N, C]."""
    h = torch.einsum("mn,bnc->bmc", a_hat, x) @ p["w1"] + p["b1"]
    return torch.einsum("mn,bnc->bmc", a_hat, h) @ p["w2"] + p["b2"]


def _tgcn_cell(params, a_hat, x, h):
    xh = torch.cat([x, h], dim=-1)
    ru = torch.sigmoid(_gcn(params["gcn_ru"], a_hat, xh))
    r, u = torch.chunk(ru, 2, dim=-1)
    xc = torch.cat([x, r * h], dim=-1)
    c = torch.tanh(_gcn(params["gcn_c"], a_hat, xc))
    return u * h + (1.0 - u) * c


def apply(params, cfg: A3TGCNConfig, a_hat: torch.Tensor,
          x_seq: torch.Tensor) -> torch.Tensor:
    """x_seq: [B, T, N, F] -> [B, horizon, N, 1]."""
    bsz, steps, n, _ = x_seq.shape
    h = torch.zeros((bsz, n, cfg.hidden), dtype=x_seq.dtype, device=x_seq.device)
    hs = []
    for t in range(steps):
        h = _tgcn_cell(params, a_hat, x_seq[:, t], h)
        hs.append(h)
    hs = torch.stack(hs)  # [T, B, N, H]
    scores = hs @ params["att"]["w"] + params["att"]["b"]  # [T, B, N, 1]
    alpha = torch.softmax(scores, dim=0)  # attention over the time axis
    ctx = torch.sum(alpha * hs, dim=0)  # [B, N, H]
    out = ctx @ params["proj"]["w"] + params["proj"]["b"]  # [B, N, horizon]
    return out.permute(0, 2, 1)[..., None]


def loss_fn(params, cfg: A3TGCNConfig, a_hat, x, y):
    """A3T-GCN trains with MSE (Table 6) against ``y``'s first channel."""
    pred = apply(params, cfg, a_hat, x)
    return torch.mean((pred - y[..., :1]) ** 2)
