"""Serving stack of the port: continuous batching on one device.

- ``Server``/``ServeConfig``: the single-host reference server, one lane
  prefilled at a time.
- ``InferencePlane``: one device's slot pool with batched prefill.
- ``Router``: bounded admission (``Backpressure``), deadlines, prompt-length
  grouping for batched prefill.
- ``ServeEngine``: Router + planes; greedy output equals the ``Server``'s.
- ``SampleParams``/``keyed_sample``: the sampling contract; greedy only so
  far.

Paged planes, the keyed sampler and the elastic fleet wait for later slices
(``ROADMAP.md``).
"""
from repro_torch.serve.common import count_transfers, device_get
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.plane import InferencePlane
from repro_torch.serve.router import (Backpressure, Router, ServeRequest,
                                      TERMINAL_STATUSES)
from repro_torch.serve.sampling import SampleParams, keyed_sample
from repro_torch.serve.server import ServeConfig, Server, validate_request

__all__ = ["Backpressure", "InferencePlane", "Router", "SampleParams",
           "ServeConfig", "ServeEngine", "ServeRequest", "Server",
           "TERMINAL_STATUSES", "count_transfers", "device_get",
           "keyed_sample", "validate_request"]
