"""Standard (materialising) vs index batching — the paper's core contribution.

``materialize_windows`` is the faithful Alg.-1 baseline: it builds the full
(x, y) snapshot stacks with ~2·horizon× duplication.  ``gather_batch`` is
index-batching: the training step receives the *resident series* and a
vector of window start indices and reconstructs the batch on the device with
a windowed gather — the paper's NumPy views, on the card.  One copy of the
series stays in device memory; the gather feeds the first layer from it.

Window starts follow ``jax.lax.dynamic_slice``, as in the JAX package: a
negative start counts from the end of the series, and a window that would
run past either end is moved back inside it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.window_gather.ref import first_rows


def materialize_windows(
    series: np.ndarray, starts: np.ndarray, input_len: int, horizon: int
) -> tuple[np.ndarray, np.ndarray]:
    """Alg.-1 baseline: stack every (x, y) snapshot (paper eq. 1 memory)."""
    xs = np.stack([series[s : s + input_len] for s in starts], axis=0)
    ys = np.stack([series[s + input_len : s + input_len + horizon] for s in starts], axis=0)
    return xs, ys


def _windows(series: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """``series[start : start+length]`` for every start, placed like
    ``dynamic_slice``: [B, length, ...]."""
    first = first_rows(starts.to(series.device), series.shape[0], length)
    return series[first[:, None] + torch.arange(length, device=series.device)]


def gather_batch(
    series: torch.Tensor, starts: torch.Tensor, *, input_len: int, horizon: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Index-batching: (x, y) for a batch of window starts, gathered on-device.

    series: [T, ...]   starts: [B] int32
    returns x: [B, input_len, ...], y: [B, horizon, ...]
    """
    return (_windows(series, starts, input_len),
            _windows(series, starts + input_len, horizon))


def gather_batch_take(
    series: torch.Tensor, starts: torch.Tensor, *, input_len: int, horizon: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-based variant (``index_select`` over explicit index grids).

    Identical to :func:`gather_batch` for starts in range; starts must lie
    in ``[0, T - input_len - horizon]`` (no clamp).
    """
    starts = starts.to(torch.long)
    offs_x = torch.arange(input_len, device=series.device)
    offs_y = input_len + torch.arange(horizon, device=series.device)
    b = starts.shape[0]
    x = series.index_select(0, (starts[:, None] + offs_x).reshape(-1))
    y = series.index_select(0, (starts[:, None] + offs_y).reshape(-1))
    return (x.reshape((b, input_len) + series.shape[1:]),
            y.reshape((b, horizon) + series.shape[1:]))


def gather_batch_fused(
    series: torch.Tensor, starts: torch.Tensor, *, input_len: int, horizon: int,
    use_pallas: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One gather of the whole span, split into (x, y).

    Halves the index traffic vs :func:`gather_batch`.  With
    ``use_pallas=True`` the gather runs through the hand-written CUDA kernel
    (``kernels/window_gather``) on a CUDA series.
    """
    from repro_torch.kernels.window_gather import gather_xy

    return gather_xy(series, starts, input_len=input_len, horizon=horizon,
                     use_pallas=use_pallas)


def gather_x_batch(series: torch.Tensor, starts: torch.Tensor, *, length: int) -> torch.Tensor:
    """x-only gather (serving path / LM next-token windows where y = shift(x))."""
    return _windows(series, starts, length)


def lm_window_batch(
    stream: torch.Tensor, starts: torch.Tensor, *, seq_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Index-batching applied to an LM token stream (the nodes==1 case):
    inputs = stream[s : s+seq], labels = stream[s+1 : s+seq+1]."""
    w = _windows(stream, starts, seq_len + 1)
    return w[:, :-1], w[:, 1:]
