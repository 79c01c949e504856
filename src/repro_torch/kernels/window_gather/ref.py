"""Plain PyTorch oracle for the index-batching window gather.

Given the resident series ``[T, C]`` (C = flattened nodes×features, or 1 for a
token stream) and per-sample window starts ``[B]``, produce the stacked
windows ``[B, span, C]`` — exactly what the paper's NumPy-view batching hands
to the model, but on the device.  Starts follow ``jax.lax.dynamic_slice``,
whose rule the JAX oracle inherits: a negative start counts from the end
(``s + T``), then the start is clamped to ``[0, T - span]``.
"""
from __future__ import annotations

import torch


def window_gather_ref(series: torch.Tensor, starts: torch.Tensor, *,
                      span: int) -> torch.Tensor:
    """series: [T, ...], starts: [B] int -> [B, span, ...]."""
    t = series.shape[0]
    if not 0 < span <= t:
        raise ValueError(f"span {span} outside [1, {t}] for a series of {t} rows")
    first = first_rows(starts.to(series.device), t, span)
    return series[first[:, None] + torch.arange(span, device=series.device)]


def first_rows(starts: torch.Tensor, t: int, span: int) -> torch.Tensor:
    """``dynamic_slice``'s start rule for windows of ``span`` rows out of
    ``t``: negative starts wrap once, then clamp to ``[0, t - span]``."""
    s = starts.to(torch.long)
    return torch.where(s < 0, s + t, s).clamp(0, t - span)
