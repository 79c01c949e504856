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
- ``lm``     — token-stream windows (``core.batching.lm_window_batch``):
  the one contract deviation — y is x shifted by one inside the same span
  (``x: [B, input_len]``, ``y: [B, input_len]``), so ``horizon`` only sets
  the window span (use ``WindowSpec(horizon=1, input_len=seq_len)``).

Under the distributed placements a rank holds only some time rows of the
series (``core/distributed.resident_rows``): the data plane hands the
gathers starts REBASED to the rows' origin, checked on the host to lie
inside them, so any variant above gathers from the resident slice as it
would from the whole series.  :func:`exchange_windows` assembles windows
whose rows lie on several ranks (``ONDEMAND``'s train batches, and the eval
batches of both time-sharded placements); :func:`split_windows` cuts its
windows into (x, y) as the named gather would.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.batching import (gather_batch, gather_batch_fused,
                                       gather_batch_take, lm_window_batch)
from repro_torch.tracing import span


def lm_gather(series, starts, *, input_len: int, horizon: int):
    """LM next-token windows: inputs = stream[s:s+L], labels = shift-by-one.

    ``horizon`` is fixed by the WindowSpec span (the extra label token) and
    unused here: the gather reads ``input_len + 1`` tokens and splits them
    into the (x, y) pair.
    """
    del horizon
    return lm_window_batch(series, starts, seq_len=input_len)


def gather_batch_auto(series, starts, *, input_len: int, horizon: int):
    """Measured dispatch through the shape-bucketed autotuner, resolved per
    call from the series' device; the candidates are the named gathers
    above, all bit-identical."""
    from repro_torch.kernels.autotune import dispatch

    return dispatch("gather", series, starts, input_len=input_len,
                    horizon=horizon)


def exchange_windows(series: torch.Tensor, starts: torch.Tensor, *, span: int,
                     owned: tuple[int, int], group=None,
                     impl: str = "ref") -> torch.Tensor:
    """Windows whose rows are spread over the ranks, assembled exactly with
    one sum all-reduce: ``[G, span, ...]`` for the ``G`` starts of a GLOBAL
    batch, the same on every rank.

    ``series`` is this rank's resident ``[R, ...]`` rows and ``starts`` the
    global batch's starts rebased to their origin (they may lie outside).
    Each rank writes the rows it OWNS (``owned``, local ``[lo, hi)``; the
    ranks' owned ranges partition the series) into a zeroed buffer and the
    all-reduce adds the buffers: every element is one rank's value plus
    zeros, and ``x + 0 == x`` in floating point, so the windows equal a
    gather from the whole series (a ``-0.0`` may come back as ``+0.0``,
    which compares equal).  Feeds are pure in (seed, epoch, rank), so every
    rank already knows every start: there is no request round.

    The rows are read by ``window_gather`` with span 1 (``impl``: ``"ref"``,
    ``"pallas"`` for the CUDA kernel, ``"auto"``), at clamped positions,
    then masked.  The all-reduce moves ``G * span`` rows of payload a call.
    """
    from repro_torch.kernels.window_gather import window_gather

    r = series.shape[0]
    rows = starts.to(torch.long)[:, None] + torch.arange(span, device=series.device)
    lo, hi = owned
    mine = ((rows >= lo) & (rows < hi)).reshape(-1, 1, 1)
    got = window_gather(series.reshape(r, -1),
                        rows.clamp(0, r - 1).reshape(-1).to(torch.int32),
                        span=1, impl=impl)
    buf = torch.where(mine, got, got.new_zeros(()))
    buf = buf.reshape((starts.shape[0], span) + tuple(series.shape[1:]))
    dist.all_reduce(buf, group=group)
    return buf


#: ``window_gather`` lowering of the exchange for each train-step gather.
EXCHANGE_IMPL = {"pallas": "pallas", "auto": "auto"}


def _spanned(gather: Callable) -> Callable:
    """``gather`` inside the ``gather`` span (:mod:`repro_torch.tracing`)."""
    def spanned(series, starts, *, input_len: int, horizon: int):
        with span("gather"):
            return gather(series, starts, input_len=input_len, horizon=horizon)
    return functools.update_wrapper(spanned, gather)


GATHERS: dict[str, Callable] = {name: _spanned(fn) for name, fn in {
    "slice": gather_batch,
    "take": gather_batch_take,
    "fused": gather_batch_fused,
    "pallas": functools.partial(gather_batch_fused, use_pallas=True),
    "auto": gather_batch_auto,
    "lm": lm_gather,
}.items()}


def split_windows(name: str, windows: torch.Tensor, input_len: int):
    """(x, y) of whole ``[G, span, ...]`` windows, as gather ``name`` splits
    them: ``lm`` shifts y by one token, every other gather cuts at
    ``input_len``."""
    if name == "lm":
        return windows[:, :input_len], windows[:, 1:input_len + 1]
    return windows[:, :input_len], windows[:, input_len:]


def resolve_gather(name: str) -> Callable:
    try:
        return GATHERS[name]
    except KeyError:
        raise ValueError(
            f"unknown gather {name!r}; expected one of {sorted(GATHERS)}") from None
