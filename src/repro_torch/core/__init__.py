"""Core of the paper's contribution: index-batching on one device."""
from repro_torch.core.batching import (
    gather_batch,
    gather_batch_fused,
    gather_batch_take,
    materialize_windows,
)
from repro_torch.core.distributed import Placement
from repro_torch.core.index_dataset import IndexDataset
from repro_torch.core.sampler import EvalFeeds, GlobalShuffleSampler, ShardInfo
from repro_torch.core.windows import WindowSpec, index_batching_bytes, materialized_bytes, num_windows

__all__ = [
    "IndexDataset",
    "WindowSpec",
    "Placement",
    "EvalFeeds",
    "GlobalShuffleSampler",
    "ShardInfo",
    "gather_batch",
    "gather_batch_fused",
    "gather_batch_take",
    "materialize_windows",
    "num_windows",
    "materialized_bytes",
    "index_batching_bytes",
]
