"""Series placements of distributed-index-batching (paper §4.2, §5.4).

Only the names live here so far: the single-device pipeline runs
``REPLICATED``, and the time-sharded placements arrive with
distributed-index-batching over ``torch.distributed``.
"""
from __future__ import annotations

import enum


class Placement(enum.Enum):
    REPLICATED = "replicated"
    PARTITIONED = "partitioned"
    ONDEMAND = "ondemand"
