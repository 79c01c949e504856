"""Shared serving utilities: the device→host transfer funnel, and the
host→device upload of token rows.

Every blocking device→host pull in the serving stack goes through
``device_get``: the decode loop's latency budget is dominated by these syncs
(each one stalls the Python thread on the device stream), so they are
funneled through ONE seam that (a) tests can count via ``count_transfers``
to pin the one-pull-per-step contract, and (b) keeps the hot loop honest:
adding a second pull per step shows up as a failing assertion, not a silent
p99 regression.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.distributed import is_dtensor

_COUNTER: dict | None = None


def device_get(x) -> np.ndarray:
    """Blocking device→host pull (the only sanctioned one in repro_torch.serve).

    A DTensor (a sharded plane's token row, split over the data axes) is
    made whole first, so every rank pulls the whole row: still one pull a
    call on every rank."""
    global _COUNTER
    if _COUNTER is not None:
        _COUNTER["pulls"] += 1
    if is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def to_device(tokens: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host row of token ids or lengths as the long tensor the model
    indexes with (a small upload; not a pull)."""
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


@contextlib.contextmanager
def count_transfers():
    """Count ``device_get`` calls in the block: ``with count_transfers() as c:
    ...; c["pulls"]``.  Nestable; each block counts its own pulls."""
    global _COUNTER
    prev, _COUNTER = _COUNTER, {"pulls": 0}
    try:
        yield _COUNTER
    finally:
        _COUNTER = prev
