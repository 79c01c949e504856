"""Plain reference of the example family: a per-node forecaster. Each
node's window ``[T, F]`` is one token, projected to ``hidden_size``; one
pre-norm SwiGLU block (RMSNorm with a gain, ``silu(z Wg) * (z Wi) Wo``)
adds to it; a final RMSNorm and a head give the node's ``horizon``
forecasts; loss the mean absolute error against the first feature.

Its norms' gains start at one (``ONES`` in ``param_specs``), as an LM's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.inputs import ONES

EPS = 1e-6


def param_specs(cfg: dict) -> list:
    """``(path, shape, fan_in)`` of every leaf, in the port's tree layout."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    t_in, out = cfg["input_len"] * cfg["in_features"], cfg["horizon"] * cfg["out_features"]
    return [(("patch", "w"), (t_in, d), t_in), (("patch", "b"), (d,), None),
            (("norm", "g"), (d,), ONES),
            (("mlp", "wi", "w"), (d, ff), d), (("mlp", "wg", "w"), (d, ff), d),
            (("mlp", "wo", "w"), (ff, d), ff),
            (("final_norm", "g"), (d,), ONES),
            (("head", "w"), (d, out), d), (("head", "b"), (out,), None)]


def graph(adjacency: torch.Tensor):
    """No graph operator: each node is forecast from its own window."""
    return None


def rms_norm(x, gain):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) * gain


def forward(params, cfg: dict, graph, x, mm):
    """x: [B, T, N, F] -> [B, horizon, N, out]; ``mm`` the 2-D product."""
    b, t, n, f = x.shape
    h = mm(x.permute(0, 2, 1, 3).reshape(b * n, t * f), params["patch"]["w"]) \
        + params["patch"]["b"]
    z, p = rms_norm(h, params["norm"]["g"]), params["mlp"]
    h = h + mm(F.silu(mm(z, p["wg"]["w"])) * mm(z, p["wi"]["w"]), p["wo"]["w"])
    y = mm(rms_norm(h, params["final_norm"]["g"]), params["head"]["w"]) + params["head"]["b"]
    return y.reshape(b, n, cfg["horizon"], cfg["out_features"]).permute(0, 2, 1, 3)


def loss(params, cfg: dict, graph, x, y, mm):
    pred = forward(params, cfg, graph, x, mm)
    return torch.mean(torch.abs(pred - y[..., :cfg["out_features"]]))
