"""The port's side of the example family (``bench/example_family``): a
per-node forecaster on the port's LM layers (``repro_torch.models.lm``).
Each node's input window is one token: a patch projection, one pre-norm
SwiGLU block with its residual, a final RMSNorm and a head to the horizon.
It takes no graph operator, so ``adjacency`` goes unused.

``counters()`` is the adapter's program counters: the harness records each
one's change over the measured window in ``Record.counters``.
"""
from __future__ import annotations

import numpy as np
import torch

_CALLS = {"loss_calls": 0}


def counters() -> dict:
    return dict(_CALLS)


def build(config: dict, traffic: dict, adjacency: np.ndarray, device):
    from repro_torch.models.lm.layers import linear, mlp, rms_norm

    horizon, out = config["horizon"], config["out_features"]

    def forecast(params, x):
        b, t, n, f = x.shape
        h = linear(params["patch"], x.permute(0, 2, 1, 3).reshape(b, n, t * f))
        h = h + mlp(params["mlp"], rms_norm(h, params["norm"]["g"]), "swiglu")
        y = linear(params["head"], rms_norm(h, params["final_norm"]["g"]))
        return y.reshape(b, n, horizon, out).permute(0, 2, 1, 3)

    def loss(params, x, y):
        _CALLS["loss_calls"] += 1
        return torch.mean(torch.abs(forecast(params, x) - y[..., :out]))

    return loss, forecast
