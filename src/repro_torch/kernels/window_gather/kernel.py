"""Launcher of the hand-written CUDA window gather (``csrc/window_gather.cu``).

Replaces the Pallas TPU kernel ``window_gather`` of the JAX package
(``repro/kernels/window_gather/kernel.py``).  Its plain PyTorch version is
:func:`~repro_torch.kernels.window_gather.ref.window_gather_ref` (clamped
advanced indexing): a CPU tensor takes it, a CUDA tensor launches the kernel
or raises.  ``window_gather.launches`` counts the kernel's launches.

Launch shape (:func:`launch_shape`): a window's span rows are contiguous in
the series and in the output.  Where a row is a whole number of 16-byte
chunks and both base addresses are 16-byte aligned, the ``"bulk"`` route
copies the windows in pieces of at most :data:`PIECE_BYTES` through Hopper's
bulk copy engine, with a persistent grid of at most one block per SM, each
block an equal share of the bytes; otherwise the ``"vector"`` route runs one
block per output row (``csrc/window_gather.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import library
from repro_torch.kernels.common import kernel_defaults, sm_count
from repro_torch.kernels.window_gather.ref import window_gather_ref

# Bytes of one shared-memory buffer of the bulk route; the kernel keeps eight.
PIECE_BYTES = 4 * 1024


def launch_shape(batch: int, span: int, row_bytes: int, *, aligned: bool,
                 sms: int) -> tuple[str, int]:
    """``(route, blocks)`` of the gather of ``batch`` windows of ``span``
    rows of ``row_bytes`` bytes on a card with ``sms`` SMs; ``aligned``:
    the series and the output both start on a 16-byte boundary.  The bulk
    route runs a block per :data:`PIECE_BYTES` of output, at most one per
    SM."""
    if row_bytes % 16 or not aligned:
        return "vector", batch * span
    return "bulk", min(-(-batch * span * row_bytes // PIECE_BYTES), sms)


def _entry():
    lib = library("window_gather")
    fn = lib.window_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.window_gather_error.argtypes = [ctypes.c_int]
        lib.window_gather_error.restype = ctypes.c_char_p
    return lib, fn


def window_gather(series: torch.Tensor, starts: torch.Tensor, *,
                  span: int) -> torch.Tensor:
    """series: [T, C] contiguous, starts: [B] int32 -> [B, span, C].

    Starts out of ``[0, T - span]`` are clamped, as the oracle does.
    """
    kd = kernel_defaults(series.device)
    if not kd.kernel:
        return window_gather_ref(series, starts, span=span)
    if series.dim() != 2 or not series.is_contiguous():
        raise ValueError(f"series must be a contiguous [T, C] tensor, got "
                         f"shape {tuple(series.shape)}")
    if (starts.dim() != 1 or starts.dtype != torch.int32
            or starts.device != series.device or not starts.is_contiguous()):
        raise ValueError(f"starts must be a contiguous [B] int32 tensor on "
                         f"{series.device}, got {starts.dtype} "
                         f"{tuple(starts.shape)} on {starts.device}")
    t, c = series.shape
    if not 0 < span <= t:
        raise ValueError(f"span {span} outside [1, {t}] for a series of {t} rows")
    b = starts.shape[0]
    out = torch.empty((b, span, c), dtype=series.dtype, device=series.device)
    if out.numel() == 0:
        return out
    row_bytes = c * series.element_size()
    route, blocks = launch_shape(
        b, span, row_bytes, aligned=(series.data_ptr() | out.data_ptr()) % 16 == 0,
        sms=sm_count(series.device))
    lib, fn = _entry()
    with torch.cuda.device(series.device):
        err = fn(series.data_ptr(), starts.data_ptr(), out.data_ptr(), t, row_bytes, b,
                 span, PIECE_BYTES if route == "bulk" else 0, blocks,
                 torch.cuda.current_stream(series.device).cuda_stream)
    if err:
        raise RuntimeError(f"window_gather launch failed: "
                           f"{lib.window_gather_error(err).decode()} ({err})")
    window_gather.launches += 1
    return out


window_gather.launches = 0
