"""Serving stack of the port: continuous batching on one device.

- ``Server``/``ServeConfig``: the single-host reference server, one lane
  prefilled at a time.
- ``InferencePlane``: one device's slot pool with batched prefill.
- ``PagedInferencePlane``/``BlockPool``: paged KV, fixed-size cache blocks
  from a shared pool, so slot memory scales with live tokens instead of
  ``max_len × slots``; pool exhaustion backpressures.
- ``Router``: bounded admission (``Backpressure``), deadlines, prompt-length
  grouping for batched prefill, block-budget accounting for paged pools.
- ``SampleParams``/``keyed_sample``: request-keyed sampling; every draw is
  ``fold_in(fold_in(key(seed), rid), position)`` (the JAX package's
  threefry keys, bit for bit), a pure function of the request.
- ``ServeEngine``: Router + planes; output equal to ``Server``'s at any
  temperature, paged or contiguous.
- ``ServeWorker``/``FleetEngine``: the elastic fleet; worker processes
  announce through heartbeat transports, and the coordinator re-prefills a
  dead worker's in-flight requests on the survivors.
"""
from repro_torch.serve.blocks import NULL_BLOCK, BlockPool
from repro_torch.serve.common import count_transfers, device_get
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.fleet import FileMailbox, FleetEngine, LocalMailbox, ServeWorker
from repro_torch.serve.plane import InferencePlane, PagedInferencePlane
from repro_torch.serve.router import (Backpressure, Router, ServeRequest,
                                      TERMINAL_STATUSES)
from repro_torch.serve.sampling import SampleParams, keyed_sample
from repro_torch.serve.server import ServeConfig, Server, validate_request

__all__ = ["Backpressure", "BlockPool", "FileMailbox", "FleetEngine",
           "InferencePlane", "LocalMailbox", "NULL_BLOCK",
           "PagedInferencePlane", "Router", "SampleParams", "ServeConfig",
           "ServeEngine", "ServeRequest", "ServeWorker", "Server",
           "TERMINAL_STATUSES", "count_transfers", "device_get",
           "keyed_sample", "validate_request"]
