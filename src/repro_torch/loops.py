"""Loops of alike iterations, marked so that a cost counter can roll them.

Eager PyTorch unrolls every loop, so a dry-run pays for each trip in Python
time: a 32k-token prefill's blockwise attention runs 64 × 64 blocks a layer.
:func:`trips` is ``range(n)`` for such a loop.  While a rolling counter is
active (``launch/costs.CostCounter(roll=True)``, the dry-run's) it yields
only 0 and 1, and the counter counts the second trip's costs ``n - 1``
times, as the JAX package's ``analyze_hlo`` rolls a while body up by its
trip count.  The second trip, not the first, stands for the rest: it holds
the carry of the trip before it as every later trip does, so its live
memory is the loop's steady state.  A rolling counter takes meta arguments
only (it counts meta shards, which hold no values), so a rolled loop never
hands a caller a wrong result.
"""
from __future__ import annotations

import torch

#: the rolling counters now active, innermost last
_ROLLING: list = []


def trips(n: int, *, holds_autograd: bool = False):
    """``range(n)`` for a loop of ``n`` alike iterations.

    Under a rolling counter it yields only 0 and 1, and has the counter
    count trip 1's costs for trips 1 to ``n - 1``.  A loop whose iterations feed one
    autograd graph is rolled only with gradients off, since its backward
    runs outside the loop; ``holds_autograd=True`` marks a loop whose body
    runs its own backward.
    """
    counter = _ROLLING[-1] if _ROLLING else None
    if (counter is None or n <= 1
            or (torch.is_grad_enabled() and not holds_autograd)):
        yield from range(n)
        return
    yield 0
    mark = counter.open_trip()
    yield 1
    counter.close_trip(mark, n - 1)
