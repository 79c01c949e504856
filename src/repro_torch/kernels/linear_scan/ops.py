"""Public linear-scan op: the plain oracle by default, the kernel on request.

``use_pallas=True`` (the JAX package's flag name) runs the hand-written CUDA
scan on a CUDA tensor, or its plain version on a CPU tensor.  The kernel
loops to S exactly, so nothing is padded.  The JAX op's tiling knobs
(``chunk``, ``backend``) and its measured dispatch (``impl="auto"``) wait
for the autotuner's slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan.kernel import linear_scan as _linear_scan_kernel
from repro_torch.kernels.linear_scan.ref import linear_scan_ref


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None,
                *, use_pallas: bool = False):
    """h_t = a_t*h_{t-1} + b_t.  a/b: [B, S, D], h0: [B, D] (zeros if None).

    Returns (h_seq [B, S, D], h_last [B, D]).
    """
    if not use_pallas:
        return linear_scan_ref(a, b, h0)
    return _linear_scan_kernel(a, b, h0)
