"""Loop forms of the port: loops of alike iterations, marked so that a cost
counter can roll them, and the associative scan.

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

:func:`associative_scan` is the port's copy of ``jax.lax.associative_scan``'s
algorithm, recursion and association included, so a float combine rounds as
the JAX package's does: about 17 ops a level over ``ceil(log2 S)`` levels in
place of a loop over ``S`` steps.
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


def _take(t: torch.Tensor, dim: int, start: int, stop, step: int = 1) -> torch.Tensor:
    """``t[..., start:stop:step, ...]`` along ``dim`` (a view)."""
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def associative_scan(fn, elems, dim: int = 0) -> tuple:
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` with
    the associative ``fn(earlier, later) -> combined`` (tuples alike).

    ``jax.lax.associative_scan``'s recursion: combine the pairs
    ``elems[0:-1:2]`` and ``elems[1::2]``, scan those (the results at odd
    positions), combine the odd results (all but the last at an even count)
    with ``elems[2::2]`` (the results at even positions), put ``elems[0]``
    first, and interleave.  Each combine is the op ``fn`` issues, so the
    results round as XLA's do wherever ``fn``'s ops round alike.  (XLA
    interleaves by padding with zeros and adding, which turns a -0.0 into
    +0.0; the copies here keep its sign.)
    """
    elems = tuple(elems)
    dim = dim % elems[0].dim()
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn(tuple(_take(e, dim, 0, -1, 2) for e in elems),
                                  tuple(_take(e, dim, 1, None, 2) for e in elems)), dim)
    head = odd if n % 2 else tuple(_take(o, dim, 0, -1) for o in odd)
    even = fn(head, tuple(_take(e, dim, 2, None, 2) for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty(e.shape, dtype=ev.dtype, device=ev.device)
        _take(full, dim, 0, 1).copy_(_take(e, dim, 0, 1))
        _take(full, dim, 2, None, 2).copy_(ev)
        _take(full, dim, 1, None, 2).copy_(od)
        out.append(full)
    return tuple(out)
