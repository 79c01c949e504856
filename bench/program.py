"""The system under test: the port (``repro_torch``), set up as its launcher
sets it up, and the calls the measured window drives.

This module and the adapters (``bench/adapters/``) are the benchmark's only
modules that import the program.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from bench.inputs import Inputs, leaves, to_device


class Program:
    """One cell's model on the port: its graph operator and resident series
    built by the port from the raw inputs (the configuration's adapter,
    ``IndexDataset.from_raw`` inside ``build_engine``), the engine's train
    step, and a forecast through the model."""

    def __init__(self, config: dict, traffic: dict, inputs: Inputs, device, seed: int):
        from repro_torch.core import WindowSpec
        from repro_torch.optim import AdamConfig
        from repro_torch.pipeline import PipelineConfig, build_pipeline
        from repro_torch.pipeline.gathers import resolve_gather

        adapter = importlib.import_module(f"bench.adapters.{config['adapter']}")
        self._loss, self._forecast = adapter.build(config, traffic, inputs.adjacency, device)
        self._counters = getattr(adapter, "counters", None)
        self.params = to_device(inputs.params, device)
        self.spec = WindowSpec(horizon=config["horizon"], input_len=config["input_len"])
        self.adam = AdamConfig(lr=traffic["lr"], grad_clip=traffic["grad_clip"]) \
            if traffic["mode"] == "train" else AdamConfig()

        def loss_fn(p, x, y):
            return self.loss(p, x, y), {}

        self.engine = build_pipeline(
            inputs.raw, self.spec, loss_fn, self.params,
            PipelineConfig(batch_per_rank=traffic["batch"], gather=traffic["gather"],
                           seed=seed, adam=self.adam, device=str(device)))
        self.gather = resolve_gather(traffic["gather"])

    # ----------------------------------------------------------- counters
    def resident_bytes(self) -> int:
        return self.engine.dataset.nbytes_index()

    def counters(self) -> dict:
        """The adapter's program counters (``counters() -> {name: number}``),
        or none where it exports no ``counters``."""
        return dict(self._counters()) if self._counters is not None else {}

    # ------------------------------------------------------------ training
    def loss(self, params, x, y) -> torch.Tensor:
        """The model's loss on a gathered batch (the faults wrap it)."""
        return self._loss(params, x, y)

    def init_state(self):
        from repro_torch.train.loop import init_train_state

        return init_train_state(self.params, self.adam)

    def starts(self, ids: np.ndarray) -> torch.Tensor:
        return self.engine.batch_of_starts(ids)

    def train_step(self, state, starts):
        return self.engine.train_step(state, starts)

    def first_gradient(self, state) -> dict:
        """The gradient the optimiser took at step 1, from its first moment
        after that step (``m_1 = (1 - b1) g_1``), by path, on the host."""
        return {k: (m / (1.0 - self.adam.b1)).cpu()
                for k, m in leaves(state["opt"]["m"]).items()}

    # ----------------------------------------------------------- forecast
    def apply(self, params, x) -> torch.Tensor:
        """The model's forecasts of a gathered batch (the faults wrap it)."""
        return self._forecast(params, x)

    @torch.no_grad()
    def forecast(self, starts: torch.Tensor) -> torch.Tensor:
        """Forecasts of the windows at ``starts``, on the host."""
        x, _ = self.gather(self.engine.dataset.series, starts,
                           input_len=self.spec.in_len, horizon=self.spec.horizon)
        return self.apply(self.params, x).cpu()
