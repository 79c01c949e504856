"""Models of the port that take DCRNN's two random-walk supports
(``repro_torch.models.dcrnn``, ``pgt_dcrnn``): ``loss_fn(params, cfg,
supports, x, y)`` and ``apply(params, cfg, supports, x)``, the supports
built by the port's ``transition_matrices`` from the raw adjacency.

An adapter (``bench/adapters/<adapter>.py``, named by a configuration's
``adapter``) exports ``build(config, traffic, adjacency, device)``, which
returns the port's ``(loss(params, x, y), forecast(params, x))``.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch


def build(config: dict, traffic: dict, adjacency: np.ndarray, device):
    from repro_torch.data import transition_matrices

    module = importlib.import_module(f"repro_torch.models.{config['port_model']}")
    cls = getattr(module, config["port_config"])
    names = {f.name for f in dataclasses.fields(cls)}
    cfg = cls(**{k: v for k, v in config.items() if k in names})
    # C order, as the launcher places them: the hop kernel would copy a
    # strided support on every call
    supports = tuple(torch.as_tensor(np.ascontiguousarray(s)).to(device)
                     for s in transition_matrices(adjacency))
    forecast_cfg = dataclasses.replace(cfg, use_pallas=traffic.get("use_pallas", False))

    def loss(params, x, y):
        return module.loss_fn(params, cfg, supports, x, y)

    def forecast(params, x):
        return module.apply(params, forecast_cfg, supports, x)

    return loss, forecast
