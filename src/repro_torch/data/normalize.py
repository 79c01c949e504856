"""Train-split standardisation (paper Alg. 1 lines 16-20).

The paper computes mean/std over the *training windows* of x.  Because every
training window is a contiguous view into the series, this equals the mean/std
over the series range the training windows cover (up to the triangular
under-weighting of the first/last ``horizon − 1`` steps, which is O(h/T) and
irrelevant at PeMS scale).  We standardise over the covered range — this is
what makes index-batching possible: normalisation happens **in place on the
single series copy**, never on materialised snapshots.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Scaler:
    mean: float
    std: float

    def transform(self, x):
        return (x - self.mean) / self.std

    def inverse(self, x):
        return x * self.std + self.mean


def fit_scaler(series: np.ndarray, train_end_step: int, feature: int | None = 0) -> Scaler:
    """Fit on ``series[:train_end_step]``.

    ``feature``: traffic pipelines standardise the signal channel only (speed),
    leaving encoded time-of-day channels alone; pass ``None`` to fit over all
    channels (paper Alg. 1 behaviour).
    """
    sl = series[:train_end_step] if feature is None else series[:train_end_step, ..., feature]
    mean = float(np.mean(sl))
    std = float(np.std(sl))
    if std == 0.0:
        std = 1.0
    return Scaler(mean=mean, std=std)


def apply_scaler(series: np.ndarray, scaler: Scaler, feature: int | None = 0) -> np.ndarray:
    out = np.array(series, copy=True)
    if feature is None:
        out = (out - scaler.mean) / scaler.std
    else:
        out[..., feature] = (out[..., feature] - scaler.mean) / scaler.std
    return out


def apply_scaler_device(series: torch.Tensor, scaler: Scaler,
                        feature: int | None = 0) -> torch.Tensor:
    """On-device standardisation — the GPU-index-batching path (§4.1):
    the raw series is transferred once and standardised on the accelerator.
    Returns a new tensor; ``series`` is left as it was."""
    if feature is None:
        return (series - scaler.mean) / scaler.std
    out = series.clone()
    out[..., feature] = (series[..., feature] - scaler.mean) / scaler.std
    return out
