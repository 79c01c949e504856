"""Placement-aware training pipeline, in two layers:

- DataPlane: placement → resident rows → sampler → deterministic per-rank
  feeds;
- Engine: the train step with the window gather (and the exchange) fused in,
  the gradient all-reduce, checkpoints, fit (with resume and the feed
  prefetcher), evaluate, and elastic restarts (``ElasticConfig``).

``build_pipeline`` is the one-call constructor (returns an Engine).
"""
from repro_torch.pipeline.gathers import GATHERS, resolve_gather
from repro_torch.pipeline.dataplane import DataPlane, PipelineConfig, build_dataplane
from repro_torch.pipeline.engine import ElasticConfig, Engine, build_engine
from repro_torch.pipeline.pipeline import Pipeline, build_pipeline
from repro_torch.pipeline.prefetch import FeedPrefetcher, PrefetchPlan
from repro_torch.pipeline.samplers import ShardAlignedBatchSampler

__all__ = [
    "Pipeline",
    "PipelineConfig",
    "build_pipeline",
    "DataPlane",
    "build_dataplane",
    "Engine",
    "ElasticConfig",
    "build_engine",
    "GATHERS",
    "resolve_gather",
    "FeedPrefetcher",
    "PrefetchPlan",
    "ShardAlignedBatchSampler",
]
