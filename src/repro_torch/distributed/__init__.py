"""Distributed substrate of the port: checkpoints (one writer under a process
group), and elastic training's heartbeats, re-mesh planning, transports and
leader succession."""
from repro_torch.distributed.checkpoint import (Checkpointer, checkpoint_meta,
                                                latest_step, restore)
from repro_torch.distributed.elastic import (ElasticPlan, HeartbeatMonitor,
                                             plan_remesh, scale_batch_or_steps)
from repro_torch.distributed.leader import (LeaderCheckpointer, LeaderHistorySink,
                                            LeaderTracker)
from repro_torch.distributed.transport import (FileHeartbeatTransport,
                                               TcpHeartbeatCollector,
                                               TcpHeartbeatEmitter, make_transport)

__all__ = ["Checkpointer", "restore", "latest_step", "checkpoint_meta",
           "HeartbeatMonitor", "plan_remesh", "ElasticPlan",
           "scale_batch_or_steps", "FileHeartbeatTransport",
           "TcpHeartbeatCollector", "TcpHeartbeatEmitter", "make_transport",
           "LeaderTracker", "LeaderCheckpointer", "LeaderHistorySink"]
