"""Selectable window-gather implementations for the training step.

Every variant has the same contract:
``gather(series, starts, *, input_len, horizon) -> (x, y)`` with
``x: [B, input_len, ...]`` and ``y: [B, horizon, ...]`` — bit-identical
results for in-range starts, different lowerings:

- ``slice``  — clamped per-window slices, as one advanced index (the default).
- ``take``   — ``index_select`` over explicit index grids.
- ``fused``  — one gather of the whole span, split into (x, y).
- ``pallas`` — the fused span gather through the hand-written CUDA kernel
  (``kernels/window_gather``); the name is the JAX package's, kept so that
  flags and tests line up.  A CPU series takes the kernel's plain version.
- ``auto``   — measured dispatch (``kernels/autotune``): the fastest of the
  above for this (backend, shape bucket), from the tuning cache
  (``build/tuning/TUNING_<backend>.json``) or a live measurement under
  ``set_autotune(mode="tune")``; the static default (``slice`` on the CPU,
  ``pallas`` on the card) when no verdict covers the bucket.  Every variant
  is bit-identical, so ``auto`` only ever changes speed, never values.

The JAX package's ``lm`` (token-stream windows) arrives with a later slice.
"""
from __future__ import annotations

import functools
from typing import Callable

from repro_torch.core.batching import (gather_batch, gather_batch_fused,
                                       gather_batch_take)


def gather_batch_auto(series, starts, *, input_len: int, horizon: int):
    """Measured dispatch through the shape-bucketed autotuner, resolved per
    call from the series' device; the candidates are the named gathers
    above, all bit-identical."""
    from repro_torch.kernels.autotune import dispatch

    return dispatch("gather", series, starts, input_len=input_len,
                    horizon=horizon)


GATHERS: dict[str, Callable] = {
    "slice": gather_batch,
    "take": gather_batch_take,
    "fused": gather_batch_fused,
    "pallas": functools.partial(gather_batch_fused, use_pallas=True),
    "auto": gather_batch_auto,
}

_LATER = {"lm": "the LM slice (token-stream windows)"}


def resolve_gather(name: str) -> Callable:
    try:
        return GATHERS[name]
    except KeyError:
        if name in _LATER:
            raise NotImplementedError(
                f"gather {name!r} is not ported yet; it arrives with "
                f"{_LATER[name]}") from None
        raise ValueError(
            f"unknown gather {name!r}; expected one of {sorted(GATHERS)}") from None
