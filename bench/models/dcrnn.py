"""DCRNN (Li et al., ICLR 2018, arXiv:1707.01926): an encoder stack of
diffusion-convolutional GRU layers reads the input; a decoder stack, fed its
own previous output (no teacher forcing), rolls out ``horizon`` forecasts
through an output projection; loss the mean absolute error against the
first feature.

A reference model exports ``param_specs``, ``graph`` (its operator from
the raw adjacency), ``forward`` and ``loss``.
"""
from __future__ import annotations

import torch

from bench.models.dconv import cell_specs, graph, gru_cell, project  # noqa: F401


def param_specs(cfg: dict) -> list:
    """``(path, shape, fan_in)`` of every leaf, in the port's tree layout."""
    k, h, layers = cfg["max_diffusion_step"], cfg["hidden"], cfg["layers"]
    specs = []
    for stack, first in (("encoder", cfg["in_features"]), ("decoder", cfg["out_features"])):
        for i in range(layers):
            specs += cell_specs((stack, i), first if i == 0 else h, h, 1 + 2 * k)
    return specs + [(("proj", "w"), (h, cfg["out_features"]), h),
                    (("proj", "b"), (cfg["out_features"],), None)]


def _stack(cells, cfg, supports, x, hs, mm):
    inp, out = x, []
    for p, h in zip(cells, hs):
        inp = gru_cell(p, supports, inp, h, cfg["max_diffusion_step"],
                       cfg["hidden"], mm)
        out.append(inp)
    return out


def forward(params, cfg: dict, supports, x, mm):
    """x: [B, T_in, N, F] -> [B, horizon, N, out]."""
    bsz, steps, n, _ = x.shape
    hs = [torch.zeros((bsz, n, cfg["hidden"]), dtype=x.dtype, device=x.device)
          for _ in range(cfg["layers"])]
    for t in range(steps):
        hs = _stack(params["encoder"], cfg, supports, x[:, t], hs, mm)
    prev = torch.zeros((bsz, n, cfg["out_features"]), dtype=x.dtype, device=x.device)
    outs = []
    for _ in range(cfg["horizon"]):
        hs = _stack(params["decoder"], cfg, supports, prev, hs, mm)
        prev = project(params["proj"], hs[-1], mm)
        outs.append(prev)
    return torch.stack(outs, dim=1)


def loss(params, cfg: dict, supports, x, y, mm):
    pred = forward(params, cfg, supports, x, mm)
    return torch.mean(torch.abs(pred - y[..., :cfg["out_features"]]))
