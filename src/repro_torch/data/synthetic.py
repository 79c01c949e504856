"""Synthetic PeMS-shaped traffic series.

The real PeMS feed is not redistributable; for correctness/benchmark work we
generate series with the same statistical shape the paper describes (Table 1):
``[entries, nodes, features]`` with feature 0 = speed-like signal (diurnal
cycle + spatially-correlated AR noise + incident dips) and feature 1 =
time-of-day encoding — the "speed, day of week" pair of PeMS.  Spatial
correlation follows the sensor graph so that diffusion convolutions have real
signal to learn.
"""
from __future__ import annotations

import numpy as np

STEPS_PER_DAY = 288  # 5-minute bins, as PeMS


def make_traffic_series(
    entries: int,
    nodes: int,
    features: int = 2,
    *,
    seed: int = 0,
    adjacency: np.ndarray | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Return ``[entries, nodes, features]`` synthetic traffic data."""
    rng = np.random.default_rng(seed)
    t = np.arange(entries, dtype=np.float64)
    tod = (t % STEPS_PER_DAY) / STEPS_PER_DAY  # [T]

    # Per-node free-flow speed and diurnal dip depth/phase.
    free_flow = rng.uniform(55.0, 70.0, size=nodes)
    dip = rng.uniform(10.0, 30.0, size=nodes)
    phase = rng.uniform(-0.05, 0.05, size=nodes)

    # Two rush-hour dips (morning/evening) via sum of Gaussians over tod.
    def rush(center):
        return np.exp(-0.5 * ((tod[:, None] - center - phase[None, :]) / 0.06) ** 2)

    speed = free_flow[None, :] - dip[None, :] * (rush(0.33) + 0.8 * rush(0.71))

    # AR(1) noise, spatially smoothed through the adjacency if given.
    noise = rng.standard_normal((entries, nodes)) * 2.0
    for i in range(1, entries):
        noise[i] += 0.85 * noise[i - 1]
        noise[i] *= 0.55
    if adjacency is not None:
        deg = adjacency.sum(axis=1, keepdims=True) + 1e-6
        smooth = adjacency / deg
        noise = noise + noise @ smooth.T * 0.5
    speed = np.clip(speed + noise, 3.0, 85.0)

    out = np.zeros((entries, nodes, features), dtype=dtype)
    out[..., 0] = speed.astype(dtype)
    if features > 1:
        out[..., 1] = np.broadcast_to(tod[:, None], (entries, nodes)).astype(dtype)
    for f in range(2, features):
        out[..., f] = rng.standard_normal((entries, nodes)).astype(dtype)
    return out


def make_token_stream(entries: int, vocab: int, *, seed: int = 0) -> np.ndarray:
    """Synthetic LM token stream (Zipfian) — the nodes==1 degenerate series used
    to apply index-batching to the assigned LM architectures."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    return rng.choice(vocab, size=entries, p=p).astype(np.int32)
