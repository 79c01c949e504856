"""Async feed prefetch pipeline: staleness-aware batch construction overlap.

The synchronous feed path puts host-side batch construction and the
host→device copy on the critical path of every step:

    feed row -> starts lookup -> copy to the device -> step   (lockstep)

Index-batching made the device side of the step cheap (the gather runs from
the resident series), which leaves the host feed path as visible overhead
that bounded staleness can hide (MSPipe, arXiv:2402.15113).  This module is
that pipeline, in two stages:

- **Stage 1 — host materialization** (always on, background thread): pull
  ``[<=chunk, width]`` numpy row blocks from a ``grid_stream``-style
  iterator and queue them, bounded by ``depth`` blocks.  Feeds are pure
  functions of (seed, epoch, rank), so a row built early holds the window
  ids it would hold if built lockstep.

- **Stage 2 — host→device transfer**:

  * ``staleness == 0`` — transfer at consume, on the CALLER thread:
    ``next()`` pops a host row and calls ``transfer(row)`` right there, the
    exact op order of the synchronous path, so training is bit-identical.
  * ``staleness >= 1`` — a transfer thread runs ``transfer`` up to
    ``staleness`` batches beyond the one being consumed.  With ``device=``
    a CUDA device, ``transfer`` returns a host row and the thread copies it
    to the card: into one of a ring of pinned host buffers (each refilled
    only after the copy out of it has completed), then to the device with a
    non-blocking copy on a side CUDA stream, and records an event.  The
    consumer makes its current stream wait on that event and marks the
    tensor as used on that stream (``record_stream``), so the caching
    allocator does not hand its memory out while the step still reads it.
    On a CPU device the thread builds the tensor with no stream.  Values
    are identical either way; only the timing moves.

``close()`` drains the pipeline: both threads stop, queued work is dropped,
and the iterator ends.

Under ``torch.distributed`` each process drains its own
``DataPlane.grid_stream`` (its feed columns, or the global rows the
``ONDEMAND`` exchange needs) and the transfer function rebases and checks
the starts on the host (``DataPlane.host_batch_of_starts``), so every
placement keeps the staleness-0 bit-identity.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

#: End-of-stream marker flowing through the stage queues.
_DONE = object()

#: Queue put/get timeout — how often blocked stage threads re-check stop.
_TICK = 0.05


@dataclasses.dataclass(frozen=True)
class PrefetchPlan:
    """How far ahead each pipeline stage may run.

    ``depth``      host row blocks stage 1 may materialize beyond the block
                   being consumed (bounds host memory: depth × chunk rows).
    ``staleness``  device batches stage 2 may transfer beyond the batch
                   being consumed.  0 = lockstep (transfer at consume, on
                   the caller thread); s >= 1 = the copy for step k+s may be
                   in flight while step k computes.
    ``chunk``      feed rows per stage-1 block.
    """

    depth: int = 2
    staleness: int = 0
    chunk: int = 8

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {self.depth}")
        if self.staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {self.staleness}")
        if self.chunk < 1:
            raise ValueError(f"prefetch chunk must be >= 1, got {self.chunk}")


class _DeviceCopy:
    """Stage 2's host row -> device tensor, on the transfer thread.

    CUDA: a ring of pinned buffers, a side stream and one event per copy; a
    buffer is refilled only after the event of its last copy completes.
    CPU: ``torch.as_tensor``.  Returns ``(tensor, event | None)``.
    """

    def __init__(self, device: torch.device, slots: int):
        self.cuda = device.type == "cuda"
        if self.cuda and device.index is None:  # the transfer thread sets it
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.slots: list[list] = [[None, None] for _ in range(slots)]  # [buffer, event]
        self.next = 0
        self.stream = torch.cuda.Stream(device=device) if self.cuda else None

    def __call__(self, row: np.ndarray):
        host = torch.as_tensor(np.ascontiguousarray(row))
        if not self.cuda:
            return host.to(self.device), None
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        buf, event = slot
        if event is not None:
            event.synchronize()  # the last copy out of this buffer is done
        if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
            buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        buf.copy_(host)
        with torch.cuda.stream(self.stream):
            out = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        slot[:] = [buf, event]
        return out, event


class FeedPrefetcher:
    """Iterator of device-ready batches over a host feed-chunk stream.

    ``rows``: iterator of ``[<=chunk, width]`` numpy blocks (e.g.
    ``DataPlane.grid_stream(epoch)``).  ``transfer``: one host row -> batch
    (``DataPlane.prefetch_transfer(staleness)``).  ``device``: at staleness
    >= 1, where stage 2 copies the host rows ``transfer`` returns (see the
    module docstring); None yields ``transfer(row)`` as it is.  Yields one
    batch for every row of every block, in order — the same sequence the
    synchronous loop produces.
    """

    def __init__(self, rows: Iterator[np.ndarray],
                 transfer: Callable[[np.ndarray], Any],
                 plan: PrefetchPlan = PrefetchPlan(),
                 *, device: str | torch.device | None = None):
        self.plan = plan
        self._transfer = transfer
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._finished = False
        # Stage 1: host row blocks, materialized `depth` blocks ahead.
        self._host_q: queue.Queue = queue.Queue(maxsize=plan.depth)
        self._host_thread = threading.Thread(
            target=self._host_stage, args=(rows,),
            name="feed-prefetch-host", daemon=True)
        # Stage 2 (staleness >= 1 only): device batches, transferred up to
        # `staleness` beyond the consumed batch (queue slots + the row the
        # thread is transferring bound the run-ahead).
        self._dev_q: queue.Queue | None = None
        self._dev_thread: threading.Thread | None = None
        self._copy: _DeviceCopy | None = None
        if plan.staleness >= 1:
            if device is not None:
                # every batch in the queue, the one being copied and the one
                # the consumer holds can each pin a buffer
                self._copy = _DeviceCopy(torch.device(device), plan.staleness + 2)
            self._dev_q = queue.Queue(maxsize=plan.staleness)
            self._dev_thread = threading.Thread(
                target=self._transfer_stage, name="feed-prefetch-transfer",
                daemon=True)
        # staleness-0 consume path: rows of the block currently being drained
        self._pending: list[np.ndarray] = []
        self._host_thread.start()
        if self._dev_thread is not None:
            self._dev_thread.start()

    # ------------------------------------------------------------- stages
    def _put(self, q: queue.Queue, item) -> bool:
        """Bounded put that aborts (returns False) once close() is called."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=_TICK)
                return True
            except queue.Full:
                continue
        return False

    def _host_stage(self, rows: Iterator[np.ndarray]) -> None:
        try:
            for block in rows:
                if self._stop.is_set() or not self._put(self._host_q, block):
                    break
            else:
                self._put(self._host_q, _DONE)
        except BaseException as e:  # surfaced to the consumer in __next__
            self._error = e
            self._put(self._host_q, _DONE)
        finally:
            close = getattr(rows, "close", None)
            if close is not None:
                close()

    def _transfer_stage(self) -> None:
        try:
            if self._copy is not None and self._copy.cuda:
                torch.cuda.set_device(self._copy.device)
            while not self._stop.is_set():
                try:
                    block = self._host_q.get(timeout=_TICK)
                except queue.Empty:
                    continue
                if block is _DONE:
                    self._put(self._dev_q, _DONE)
                    return
                for row in block:
                    batch = self._transfer(row)
                    if self._copy is not None:
                        batch = self._copy(batch)
                    if not self._put(self._dev_q, batch):
                        return
            # closed mid-stream: nothing more to do
        except BaseException as e:
            self._error = e
            self._put(self._dev_q, _DONE)

    # ----------------------------------------------------------- consumer
    def __iter__(self) -> "FeedPrefetcher":
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        if self._dev_q is None:
            # staleness 0: pop a host row and transfer it HERE, on the
            # caller thread — the synchronous path's exact op order.
            while not self._pending:
                block = self._get(self._host_q)
                if block is _DONE:
                    return self._finish()
                self._pending = list(block)
            return self._transfer(self._pending.pop(0))
        batch = self._get(self._dev_q)
        if batch is _DONE:
            return self._finish()
        if self._copy is None:
            return batch
        tensor, event = batch
        if event is not None:
            stream = torch.cuda.current_stream(tensor.device)
            stream.wait_event(event)
            tensor.record_stream(stream)
        return tensor

    def _get(self, q: queue.Queue):
        while True:
            if self._stop.is_set():
                return _DONE
            try:
                return q.get(timeout=_TICK)
            except queue.Empty:
                if self._error is not None:
                    return _DONE

    def _finish(self):
        self._finished = True
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        raise StopIteration

    # -------------------------------------------------------------- drain
    def close(self, *, timeout: float = 5.0) -> None:
        """Drain the pipeline: stop both threads, drop queued work.

        Idempotent, and safe to call from the step loop's ``finally``.
        After close() the iterator is exhausted.
        """
        self._stop.set()
        self._finished = True
        for t in (self._host_thread, self._dev_thread):
            if t is None or not t.is_alive():
                continue
            deadline = time.monotonic() + timeout
            while t.is_alive() and time.monotonic() < deadline:
                # unblock producers stuck on a full queue
                for q in (self._host_q, self._dev_q):
                    if q is not None:
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass
                t.join(timeout=_TICK)
        if self._copy is not None and self._copy.cuda:
            # Copies still in flight on the side stream end here, so the
            # caller may free what the stream touches once close() returns
            # (an elastic re-mesh frees the old plane right after the drain).
            self._copy.stream.synchronize()
