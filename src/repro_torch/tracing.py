"""Named ranges of the program's host work, on the profiler's clock.

``with span("forward"): ...`` opens ``torch.profiler.record_function(
"repro_torch.forward")`` while a ``torch.profiler`` profile is active on
the calling thread, so the range lands in the same Kineto trace as the CUDA
kernels and copies it launches, on the same clock.  A reader of that trace
gives each device op to the innermost span open when it was launched (on
any host thread: autograd launches the backward's kernels from its own
thread while the caller's ``backward`` span is open).

With no profiler active a span costs one check and returns a shared no-op
context: no ``RecordFunction`` and no object a call.  Nothing is written.

The spans, each opened once a step (or a request), where the work happens:

- ``starts``: ``DataPlane.batch_of_starts``, the host check and the int32
  host -> device copy of the step's window starts;
- ``gather``: every gather of ``pipeline/gathers.GATHERS``, the window gather
  from the resident series (inside ``forward`` in a train step);
- ``forward``: ``train/loop.make_train_step``, the model's forward and loss;
- ``backward``: there too, ``torch.autograd.grad``;
- ``optimizer``: there too, ``optim.apply_updates`` (global norm, clip,
  AdamW).
"""
from __future__ import annotations

import contextlib

import torch

#: Every span's name in the trace starts with this.
PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range ``PREFIX + name`` in an active profiler's
    trace, else nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
