"""Public linear-scan op: the plain oracle by default, the kernel on request.

``use_pallas=True`` (the JAX package's flag name) runs the hand-written CUDA
scan on a CUDA tensor, or its plain version on a CPU tensor.  The kernel
loops to S exactly, so nothing is padded, and the JAX op's tiling knobs
(``chunk``, ``backend``) have no counterpart.  ``impl`` overrides ``use_pallas``:
``"ref"``/``"pallas"`` force a lowering, ``"auto"`` routes through the
measured dispatcher (:mod:`repro_torch.kernels.autotune`).  The kernel path
is forward-only, as in the JAX package, whose Pallas scan has no gradient
either: asking it for a gradient raises, on the CPU as on the card.
DTensor operands (a sharded serving plane's RG-LRU, the dry-run's cells)
run the kernel, or the plain scan, on each rank's local shard, batch rows
and channels being independent; the plain scan first makes a sequence split
over a mesh dim whole, where the kernel refuses it.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import as_dtensor, is_dtensor, wrap_local
from repro_torch.kernels.linear_scan.kernel import linear_scan as _linear_scan_kernel
from repro_torch.kernels.linear_scan.ref import linear_scan_ref


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None,
                *, use_pallas: bool = False, impl: str | None = None):
    """h_t = a_t*h_{t-1} + b_t.  a/b: [B, S, D], h0: [B, D] (zeros if None).

    Returns (h_seq [B, S, D], h_last [B, D]).
    """
    if impl == "auto":
        from repro_torch.kernels.autotune import dispatch
        if h0 is None:
            h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=a.dtype, device=a.device)
        return dispatch("linear_scan", a, b, h0)
    if impl is not None:
        if impl not in ("ref", "pallas"):
            raise ValueError(f"impl {impl!r}; expected ref|pallas|auto")
        use_pallas = impl == "pallas"
    if not use_pallas:
        if is_dtensor(a):
            return scan_on_whole_sequences(linear_scan_ref, a, b, h0)
        return linear_scan_ref(a, b, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        raise NotImplementedError(
            "linear_scan(use_pallas=True) has no backward: the CUDA scan is "
            "forward-only, as the JAX package's Pallas scan is; train with "
            "use_pallas=False (LMConfig.use_pallas_scan=False)")
    if is_dtensor(a):
        return _scan_on_shards(a, b, h0)
    return _linear_scan_kernel(a, b, h0)


def _scan_on_shards(a, b, h0, scan=_linear_scan_kernel):
    """``scan`` (the kernel; RG-LRU's associative scan passes its own) on
    each rank's own ``[B_local, S, D_local]`` shard of DTensor operands
    (batch rows and channels are independent), wrapped back with ``a``'s
    placements.  A split sequence raises: the recurrence cannot be cut
    there without carrying ``h`` across shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = a.device_mesh
    if any(p == Shard(1) for p in a.placements):
        raise ValueError(f"linear_scan: the sequence dim is split ({a.placements}); "
                         f"a shard cannot scan without the carry of the one before")
    pl = [Replicate() if isinstance(p, Partial) else p for p in a.placements]
    ph = [Shard(1) if p == Shard(2) else p for p in pl]  # h0 / h_last [B, D]
    a_l, b_l = (as_dtensor(t, mesh).redistribute(mesh, pl).to_local() for t in (a, b))
    h0_l = None if h0 is None else as_dtensor(h0, mesh).redistribute(mesh, ph).to_local()
    h, h_last = scan(a_l, b_l, h0_l)
    return (wrap_local(h, mesh, pl, a.shape),
            wrap_local(h_last, mesh, ph, (a.shape[0], a.shape[2])))


def scan_on_whole_sequences(scan, a, b, h0):
    """``scan`` (the plain scan, or RG-LRU's associative scan) of DTensor
    operands on each rank's local shards, as :func:`_scan_on_shards` runs
    the kernel, a sequence split over a mesh dim first made whole there
    (an all-gather over that dim)."""
    from torch.distributed.tensor import Replicate, Shard

    if any(p == Shard(1) for p in a.placements):
        a = a.redistribute(a.device_mesh, [Replicate() if p == Shard(1) else p
                                           for p in a.placements])
    return _scan_on_shards(a, b, h0, scan=scan)
