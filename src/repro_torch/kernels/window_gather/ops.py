"""Public window-gather op: the plain oracle by default, the kernel on request.

Handles arbitrary trailing shape by flattening to [T, C] (a view of a
contiguous series) and restoring the shape afterwards; the CUDA kernel masks
the ragged row end itself, so nothing is padded.  The batching layer
(`repro_torch.core.batching`) routes through here when ``use_pallas=True``
— the JAX package's flag name, which here selects the hand-written CUDA
kernel.  ``impl`` overrides ``use_pallas``: ``"ref"``/``"pallas"`` force a
lowering, ``"auto"`` routes through the measured dispatcher
(:mod:`repro_torch.kernels.autotune`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.window_gather.kernel import window_gather as _window_gather_kernel
from repro_torch.kernels.window_gather.ref import window_gather_ref


def window_gather(series: torch.Tensor, starts: torch.Tensor, *, span: int,
                  use_pallas: bool = False, impl: str | None = None) -> torch.Tensor:
    """series: [T, ...], starts: [B] -> [B, span, ...]."""
    if impl == "auto":
        from repro_torch.kernels.autotune import dispatch
        return dispatch("window_gather", series, starts, span=span)
    if impl is not None:
        if impl not in ("ref", "pallas"):
            raise ValueError(f"impl {impl!r}; expected ref|pallas|auto")
        use_pallas = impl == "pallas"
    if not use_pallas:
        return window_gather_ref(series, starts, span=span)
    t = series.shape[0]
    trailing = tuple(series.shape[1:])
    flat = series.reshape(t, -1).contiguous()
    out = _window_gather_kernel(flat, starts.to(torch.int32).contiguous(), span=span)
    return out.reshape((starts.shape[0], span) + trailing)


def gather_xy(
    series: torch.Tensor,
    starts: torch.Tensor,
    *,
    input_len: int,
    horizon: int,
    use_pallas: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused gather of the full span, split into (x, y) views."""
    w = window_gather(series, starts, span=input_len + horizon, use_pallas=use_pallas)
    return w[:, :input_len], w[:, input_len:]
