"""Core of the paper's contribution: index-batching and its distributed forms."""
from repro_torch.core.batching import (
    gather_batch,
    gather_batch_fused,
    gather_batch_take,
    materialize_windows,
)
from repro_torch.core.distributed import Placement, local_time_range, resident_rows
from repro_torch.core.index_dataset import IndexDataset
from repro_torch.core.sampler import (EvalFeeds, GlobalShuffleSampler,
                                      LocalBatchShuffleSampler, ShardInfo)
from repro_torch.core.windows import WindowSpec, index_batching_bytes, materialized_bytes, num_windows

__all__ = [
    "IndexDataset",
    "WindowSpec",
    "Placement",
    "EvalFeeds",
    "GlobalShuffleSampler",
    "LocalBatchShuffleSampler",
    "ShardInfo",
    "gather_batch",
    "gather_batch_fused",
    "gather_batch_take",
    "materialize_windows",
    "num_windows",
    "materialized_bytes",
    "index_batching_bytes",
    "local_time_range",
    "resident_rows",
]
