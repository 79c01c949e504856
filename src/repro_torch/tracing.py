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

The LM layers' regions are open in the forward and again in their
backward (:func:`spanned`), so a reader sees both, nested in ``forward``
and ``backward``:

- ``attention``: MLA's projections, rope and attention (with the blockwise
  recompute of its backward);
- ``route``: the MoE router, top-k, sort and dispatch, and the weighted
  combine back to the tokens;
- ``experts``: the routed and shared expert products.

Counters (:func:`count`) accumulate on the device, where the values are,
with no host sync, once :func:`count_on` has been called; :func:`counts`
reads them all in one copy.  Off, a count costs one check.
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


class _Close(torch.autograd.Function):
    """Identity on a region's inputs; its backward closes the region's
    span, which :class:`_Open` opened in the backward of its outputs."""

    @staticmethod
    def forward(ctx, held, *xs):
        ctx.held = held
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.held:
            ctx.held.pop().__exit__(None, None, None)
        return (None, *grads)


class _Open(torch.autograd.Function):
    """Identity on a region's outputs; its backward opens the span."""

    @staticmethod
    def forward(ctx, held, name, *ys):
        ctx.held, ctx.name = held, name
        return tuple(y.view_as(y) for y in ys)

    @staticmethod
    def backward(ctx, *grads):
        record = torch.profiler.record_function(PREFIX + ctx.name)
        record.__enter__()
        ctx.held.append(record)
        return (None, None, *grads)


def _through(fn, head: tuple, values: tuple) -> tuple:
    """``values`` with the tensors that need a gradient passed through
    ``fn(*head, *those)``, the rest as they were."""
    at = [i for i, v in enumerate(values) if isinstance(v, torch.Tensor) and v.requires_grad]
    out = list(values)
    for i, v in zip(at, fn(*head, *(values[i] for i in at))):
        out[i] = v
    return tuple(out)


def spanned(name: str, fn, *inputs):
    """``fn(*inputs)`` with the span ``name`` open around it, and around
    its backward too: autograd meets the region's outputs first and its
    inputs last, so identities on both open and close the span there (on
    autograd's thread, inside the caller's ``backward`` span).  ``fn``
    returns a tensor or a tuple; tensors in ``inputs`` and in the result
    that need no gradient pass by.  With no profiler active: ``fn(*inputs)``."""
    if not torch.autograd._profiler_enabled():
        return fn(*inputs)
    with torch.profiler.record_function(PREFIX + name):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)):
            return fn(*inputs)
        held: list = []
        out = fn(*_through(_Close.apply, (held,), inputs))
        single = not isinstance(out, tuple)
        out = _through(_Open.apply, (held, name), (out,) if single else out)
        return out[0] if single else out


_COUNTS: dict | None = None


def count_on() -> None:
    """Start accumulating :func:`count` (a no-op where already started)."""
    global _COUNTS
    if _COUNTS is None:
        _COUNTS = {}


def counting() -> bool:
    """Whether :func:`count` accumulates (after :func:`count_on`)."""
    return _COUNTS is not None


def count(name: str, value: torch.Tensor) -> None:
    """Add the integer ``value`` (a 0-d tensor, on its device) to counter
    ``name``, once :func:`count_on` has been called; else nothing."""
    if _COUNTS is None:
        return
    value = value.detach().to(torch.int64)
    held = _COUNTS.get(name)
    if held is None:
        _COUNTS[name] = value.clone()
    else:
        held.add_(value)


def counts() -> dict[str, int]:
    """Every counter's total so far, read in one copy to the host."""
    if not _COUNTS:
        return {}
    names = list(_COUNTS)
    values = torch.stack([_COUNTS[k].to(_COUNTS[names[0]].device) for k in names]).tolist()
    return dict(zip(names, values))
