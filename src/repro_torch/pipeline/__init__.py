"""Single-device training pipeline, in two layers:

- DataPlane: placed dataset → sampler → deterministic feeds;
- Engine: the train step with the window gather fused in, checkpoints,
  fit (with resume and the feed prefetcher), evaluate.

``build_pipeline`` is the one-call constructor (returns an Engine).
"""
from repro_torch.pipeline.gathers import GATHERS, resolve_gather
from repro_torch.pipeline.dataplane import DataPlane, PipelineConfig, build_dataplane
from repro_torch.pipeline.engine import Engine, build_engine
from repro_torch.pipeline.pipeline import Pipeline, build_pipeline
from repro_torch.pipeline.prefetch import FeedPrefetcher, PrefetchPlan

__all__ = [
    "Pipeline",
    "PipelineConfig",
    "build_pipeline",
    "DataPlane",
    "build_dataplane",
    "Engine",
    "build_engine",
    "GATHERS",
    "resolve_gather",
    "FeedPrefetcher",
    "PrefetchPlan",
]
