"""Async, atomic checkpoints in the JAX package's on-disk format.

- **Async**: ``save`` copies the state to host memory (the only synchronous
  part: ``.detach().cpu().numpy().copy()`` of every tensor) and hands
  serialization to a background thread; training resumes while bytes hit
  disk.
- **Atomic**: writes go to a ``mkdtemp`` directory that is ``os.replace``d
  into ``step_<10 digits>``; the ``manifest.json`` (with the sha256 of every
  file) is written last, so a crash mid-write never leaves a
  readable-but-corrupt checkpoint.
- **Retention**: the ``keep`` most recent steps are retained, older ones
  pruned.
- **One writer**: under ``torch.distributed`` every rank holds a
  ``Checkpointer`` and calls ``save`` at the same steps, but only process 0
  copies and writes; ``wait`` then ends in a barrier, so no rank goes on
  while a write is in flight, and every rank can ``restore`` what process 0
  wrote.  Elastic runs pick the writer themselves: ``snapshot`` and
  ``save_snapshot`` copy and write from any process with no collective
  (:class:`repro_torch.distributed.leader.LeaderCheckpointer`).

Format 1, as the JAX package writes and reads it: ``arrays.npz`` keyed by
each leaf's ``/``-joined tree path (``"params/encoder/0/ru/w"``, dict keys
sorted, lists by index) and ``manifest.json`` with ``step``, ``meta``,
``format``, ``leaves`` (shape and dtype) and ``files``.  The port's
optimizer step is a Python int; it is stored as an int32 0-d array, as the
JAX state holds it, and restored as an int.  So either package restores
what the other wrote.  ``restore(..., device=...)`` takes the place of the
JAX package's ``shardings=``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import process_info
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten


def _host(leaf) -> np.ndarray:
    """A real host COPY of one leaf, so the async writer never sees what the
    caller changes afterwards."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: widen, losslessly
            t = t.float()
        return t.cpu().numpy().copy()
    if isinstance(leaf, int):  # the optimizer step
        return np.asarray(leaf, np.int32)
    return np.array(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {path: _host(leaf)
            for path, leaf in zip(tree_paths(tree), tree_leaves(tree))}


def _unflatten_into(template: Any, flat: dict[str, np.ndarray],
                    device: torch.device | None) -> Any:
    leaves = []
    for key, leaf in zip(tree_paths(template), tree_leaves(template)):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != expected {shape}")
        if isinstance(leaf, torch.Tensor):
            leaves.append(torch.from_numpy(arr).to(
                device=device or leaf.device, dtype=leaf.dtype))
        elif isinstance(leaf, int):
            leaves.append(int(arr))
        else:
            leaves.append(arr)
    return tree_unflatten(template, leaves)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Checkpointer:
    """Async checkpoint writer with atomic manifests and retention; under a
    process group, process 0 writes and the others only keep step with it
    (see the module docstring)."""

    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        rank, size = process_info()
        self.writer = rank == 0
        self._grouped = size > 1

    @staticmethod
    def snapshot(state: Any) -> dict[str, np.ndarray]:
        """Host copy of every leaf of ``state``, keyed by tree path: the
        synchronous half of :meth:`save`, exposed so a standby writer
        (:class:`repro_torch.distributed.leader.LeaderCheckpointer`) can hold
        the would-be checkpoint in host memory without writing it.  The copy
        is taken while the device tensors are still valid; after a failed
        collective they may not be, but the held copy can always be
        written."""
        return _flatten(state)

    def save(self, state: Any, *, step: int, meta: dict | None = None) -> None:
        """``meta``: JSON-serialisable run coordinates stored in the manifest
        (e.g. ``{epoch, done_in_epoch}``), read back with
        :func:`checkpoint_meta`.  A collective call under a process group:
        every rank calls it at the same steps."""
        # Wait BEFORE the host copy: holding a new snapshot while the
        # previous write still holds its own would double host memory.
        self.wait()
        if not self.writer:
            return
        self.save_snapshot(_flatten(state), step=step, meta=meta)

    def save_snapshot(self, flat: dict[str, np.ndarray], *, step: int,
                      meta: dict | None = None, sync: bool = False) -> None:
        """Write a :meth:`snapshot` from THIS process, whatever its rank (the
        caller decides who writes), with no collective.  ``sync=True``
        writes before returning even on an async checkpointer: a successor
        makes its takeover checkpoint durable before it exits."""
        self.flush()  # one write in flight at a time
        if self.async_write and not sync:
            self._thread = threading.Thread(
                target=self._write, args=(flat, step, meta), daemon=True)
            self._thread.start()
        else:
            self._write(flat, step, meta)
            self.flush()  # surface a sync-write failure immediately

    def _write(self, flat: dict[str, np.ndarray], step: int,
               meta: dict | None = None) -> None:
        try:
            final = os.path.join(self.dir, f"step_{step:010d}")
            tmp = tempfile.mkdtemp(prefix=f".step_{step}-", dir=self.dir)
            arrays_path = os.path.join(tmp, "arrays.npz")
            np.savez(arrays_path, **flat)
            manifest = {
                "step": step,
                "meta": meta or {},
                "format": 1,
                "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in flat.items()},
                "files": {"arrays.npz": _sha256(arrays_path)},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._prune()
        except BaseException as e:  # surfaced on the next wait()/save()
            self._error = e

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    def wait(self) -> None:
        """Join the in-flight write; raise if it failed.  Under a process
        group, then a barrier (a collective call: every rank calls it)."""
        self.flush()
        if self._grouped:
            dist.barrier()

    def flush(self) -> None:
        """Join the in-flight write, with no collective; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") \
                    and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)


def checkpoint_meta(directory: str, *, step: int | None = None) -> dict:
    """The run coordinates saved alongside a checkpoint (empty when absent)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    with open(os.path.join(directory, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f).get("meta") or {}


def latest_step(directory: str) -> int | None:
    try:
        steps = Checkpointer(directory).steps()
    except FileNotFoundError:
        return None
    return steps[-1] if steps else None


def restore(
    directory: str,
    template: Any,
    *,
    step: int | None = None,
    device: str | torch.device | None = None,
    verify: bool = True,
) -> tuple[Any, int]:
    """Load a checkpoint into ``template``'s structure.  Returns
    ``(state, step)``.

    Each tensor leaf takes its template leaf's dtype, and lands on
    ``device`` (default: the template leaf's own device); an int leaf comes
    back as an int.
    """
    dev = resolve_device(device) if device is not None else None
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays_path = os.path.join(path, "arrays.npz")
    if verify and _sha256(arrays_path) != manifest["files"]["arrays.npz"]:
        raise IOError(f"checksum mismatch in {arrays_path} — corrupt checkpoint")
    with np.load(arrays_path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_into(template, flat, dev), manifest["step"]
