"""PGT-DCRNN (PGT-I, arXiv:2507.11683, section 3): one diffusion-
convolutional GRU layer run stepwise over the input, emitting a forecast at
every step; loss the mean absolute error against the next ``horizon`` rows'
first feature.

A reference model exports ``param_specs``, ``graph`` (its operator from
the raw adjacency), ``forward`` and ``loss``.
"""
from __future__ import annotations

import torch

from bench.models.dconv import cell_specs, graph, gru_cell, project  # noqa: F401


def param_specs(cfg: dict) -> list:
    """``(path, shape, fan_in)`` of every leaf, in the port's tree layout."""
    k, h = cfg["max_diffusion_step"], cfg["hidden"]
    return (cell_specs((), cfg["in_features"], h, 1 + 2 * k)
            + [(("proj", "w"), (h, cfg["out_features"]), h),
               (("proj", "b"), (cfg["out_features"],), None)])


def forward(params, cfg: dict, supports, x, mm):
    """x: [B, T, N, F] -> [B, T, N, out]."""
    bsz, steps, n, _ = x.shape
    h = torch.zeros((bsz, n, cfg["hidden"]), dtype=x.dtype, device=x.device)
    outs = []
    for t in range(steps):
        h = gru_cell(params, supports, x[:, t], h, cfg["max_diffusion_step"],
                     cfg["hidden"], mm)
        outs.append(project(params["proj"], h, mm))
    return torch.stack(outs, dim=1)


def loss(params, cfg: dict, supports, x, y, mm):
    pred = forward(params, cfg, supports, x, mm)
    return torch.mean(torch.abs(pred - y[..., :cfg["out_features"]]))
