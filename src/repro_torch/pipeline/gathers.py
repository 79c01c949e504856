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

The JAX package's ``auto`` (measured dispatch) and ``lm`` (token-stream
windows) arrive with later slices of the port.
"""
from __future__ import annotations

import functools
from typing import Callable

from repro_torch.core.batching import (gather_batch, gather_batch_fused,
                                       gather_batch_take)

GATHERS: dict[str, Callable] = {
    "slice": gather_batch,
    "take": gather_batch_take,
    "fused": gather_batch_fused,
    "pallas": functools.partial(gather_batch_fused, use_pallas=True),
}

_LATER = {"auto": "the tooling slice (measured dispatch)",
          "lm": "the LM slice (token-stream windows)"}


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
