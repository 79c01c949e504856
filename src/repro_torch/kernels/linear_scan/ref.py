"""Plain PyTorch oracle for the diagonal linear recurrence h_t = a_t*h_{t-1} + b_t.

This is the RG-LRU inner loop (and any diagonal SSM).  A sequential loop
over time with a float32 carry: each step is a rounded product and a rounded
sum, so the CUDA kernel (``csrc/linear_scan.cu``) equals it bit for bit.
With float32 inputs it is the JAX oracle's ``lax.scan``; with bfloat16
inputs it follows the JAX Pallas kernel, which loads to float32 and carries
float32, where the JAX oracle would carry bfloat16.  The loop runs through
``loops.trips``: ``range(S)`` but under a rolling cost counter, which counts
a 32k-token prefill's scan from two steps (the dry-run's).
"""
from __future__ import annotations

import torch

from repro_torch.loops import trips


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None):
    """a, b: [B, S, D]; h0: [B, D] or None (zeros).

    Returns ``(h_seq [B, S, D] in a.dtype, h_last [B, D] in h0.dtype)``;
    ``h_last`` is in ``a.dtype`` when ``h0`` is None.
    """
    bsz, s, d = a.shape
    h = (torch.zeros((bsz, d), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    h_seq = torch.empty_like(a)
    for t in trips(s):
        h = a[:, t].float() * h + b[:, t].float()
        h_seq[:, t] = h
    return h_seq, h.to(a.dtype if h0 is None else h0.dtype)
