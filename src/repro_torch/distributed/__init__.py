"""Distributed substrate of the port.  So far the checkpoints; the heartbeat,
re-mesh, transport and leader modules arrive with distributed-index-batching
(``ROADMAP.md`` queue 1, item 4)."""
from repro_torch.distributed.checkpoint import (Checkpointer, checkpoint_meta,
                                                latest_step, restore)

__all__ = ["Checkpointer", "restore", "latest_step", "checkpoint_meta"]
