"""``build_pipeline``: the one-call constructor of the placement-aware trainer.

Returns an :class:`~repro_torch.pipeline.engine.Engine` (``.fit``,
``.evaluate``, ``.dataset``, ``.dataplane``, ``.describe()``,
``.batch_of_starts``, ``.train_step``).  Unlike the JAX package it takes no
mesh: the device is ``PipelineConfig.device``, ``"cuda"`` unless the caller
asks for the CPU, and the ranks are the ``torch.distributed`` process group
(none: one process).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.core.index_dataset import IndexDataset
from repro_torch.core.windows import WindowSpec
from repro_torch.pipeline.dataplane import DataPlane, PipelineConfig, build_dataplane
from repro_torch.pipeline.engine import ElasticConfig, Engine, build_engine

#: The legacy name: an assembled trainer IS the engine.
Pipeline = Engine


def build_pipeline(
    raw: np.ndarray,
    spec: WindowSpec,
    loss_fn: Callable,
    init_params: Any,
    config: PipelineConfig = PipelineConfig(),
    *,
    dataset: IndexDataset | None = None,
    elastic: ElasticConfig | None = None,
) -> Engine:
    """See :func:`build_engine`."""
    return build_engine(raw, spec, loss_fn, init_params, config,
                        dataset=dataset, elastic=elastic)


__all__ = ["Pipeline", "PipelineConfig", "build_pipeline", "DataPlane",
           "build_dataplane", "Engine", "ElasticConfig", "build_engine"]
