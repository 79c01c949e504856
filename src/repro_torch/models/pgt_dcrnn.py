"""PGT-DCRNN — the paper's lightweight variant (§3).

A single spatiotemporal diffusion-conv recurrent layer processed *stepwise*:
the hidden state is carried across the input sequence and an output is emitted
at every step, forming a prediction sequence of equal length to the input
(the paper's modification for batched seq2seq prediction).  No encoder-decoder
structure — deliberately simpler and faster than full DCRNN.

Parameters are a nested dict of tensors shaped like the JAX package's pytree
(``ru``/``c``/``proj``, each with ``w`` and ``b``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.diffusion_conv import diffusion_conv


@dataclasses.dataclass(frozen=True)
class PGTDCRNNConfig:
    num_nodes: int
    in_features: int = 2
    out_features: int = 1
    hidden: int = 64
    max_diffusion_step: int = 2
    input_len: int = 12
    horizon: int = 12
    # Run every hop through the hand-written kernels on a CUDA card (the JAX
    # package's name for its Pallas path): hop_gemm forward and backward in
    # training, hop_project without gradients; their plain versions on the CPU.
    use_pallas: bool = True
    remat: bool = False  # checkpoint each time step (needed at PeMS scale)

    @property
    def n_matrices(self) -> int:
        return 1 + 2 * self.max_diffusion_step


def init(generator: torch.Generator, cfg: PGTDCRNNConfig,
         device: str | torch.device = "cuda") -> dict[str, Any]:
    """Random parameters drawn from ``generator`` (a CPU generator), placed
    on ``device``."""
    dev = resolve_device(device)
    in_dim = (cfg.in_features + cfg.hidden) * cfg.n_matrices

    def normal(rows, cols):
        return torch.randn((rows, cols), generator=generator, dtype=torch.float32)

    def dconv(out):
        return {"w": (normal(in_dim, out) / in_dim ** 0.5).to(dev),
                "b": torch.zeros((out,), dtype=torch.float32, device=dev)}

    ru = dconv(2 * cfg.hidden)
    c = dconv(cfg.hidden)
    proj_w = normal(cfg.hidden, cfg.out_features) / cfg.hidden ** 0.5
    return {
        "ru": ru,
        "c": c,
        "proj": {"w": proj_w.to(dev),
                 "b": torch.zeros((cfg.out_features,), dtype=torch.float32,
                                  device=dev)},
    }


def _cell(params, cfg: PGTDCRNNConfig, supports, x, h):
    xh = torch.cat([x, h], dim=-1)
    ru = torch.sigmoid(
        diffusion_conv(xh, supports, params["ru"]["w"], params["ru"]["b"],
                       k_hops=cfg.max_diffusion_step, use_pallas=cfg.use_pallas))
    r, u = torch.split(ru, cfg.hidden, dim=-1)
    xc = torch.cat([x, r * h], dim=-1)
    c = torch.tanh(
        diffusion_conv(xc, supports, params["c"]["w"], params["c"]["b"],
                       k_hops=cfg.max_diffusion_step, use_pallas=cfg.use_pallas))
    return u * h + (1.0 - u) * c


def apply(params, cfg: PGTDCRNNConfig, supports, x_seq: torch.Tensor) -> torch.Tensor:
    """x_seq: [B, T, N, F] -> [B, T, N, out_features] (stepwise predictions)."""
    bsz, steps, n, _ = x_seq.shape
    h = torch.zeros((bsz, n, cfg.hidden), dtype=x_seq.dtype, device=x_seq.device)

    def step(h, xt):
        h2 = _cell(params, cfg, supports, xt, h)
        return h2, h2 @ params["proj"]["w"] + params["proj"]["b"]

    outs = []
    for t in range(steps):
        if cfg.remat and torch.is_grad_enabled():
            h, out = checkpoint(step, h, x_seq[:, t], use_reentrant=False)
        else:
            h, out = step(h, x_seq[:, t])
        outs.append(out)
    return torch.stack(outs, dim=1)


def loss_fn(params, cfg: PGTDCRNNConfig, supports, x, y):
    """Mean absolute error of the stepwise predictions against ``y``'s first
    ``out_features`` channels."""
    pred = apply(params, cfg, supports, x)
    return torch.mean(torch.abs(pred - y[..., : cfg.out_features]))
