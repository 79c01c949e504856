"""Distributed substrate of the port.  So far the checkpoints (one writer
under a process group); the heartbeat, re-mesh, transport and leader modules
arrive with elastic training (``ROADMAP.md`` queue 1, item 4b)."""
from repro_torch.distributed.checkpoint import (Checkpointer, checkpoint_meta,
                                                latest_step, restore)

__all__ = ["Checkpointer", "restore", "latest_step", "checkpoint_meta"]
