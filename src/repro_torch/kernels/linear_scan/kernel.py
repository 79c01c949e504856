"""Launcher of the hand-written CUDA linear scan (``csrc/linear_scan.cu``).

Replaces the Pallas TPU kernel ``linear_scan`` of the JAX package
(``repro/kernels/linear_scan/kernel.py``): the diagonal recurrence
``h_t = a_t * h_{t-1} + b_t`` with a float32 carry.  Its plain PyTorch
version is :func:`~repro_torch.kernels.linear_scan.ref.linear_scan_ref`: a
CPU tensor takes it, a CUDA tensor launches the kernel or raises.
``linear_scan.launches`` counts the kernel's launches.

Launch shape (:func:`scan_threads`): one thread per (batch, channel), a
block of one warp (32 consecutive channels of one batch row) or two.  Two
only where that still leaves a block for every SM and D is wider than one
warp; otherwise one, so B = 2 at the RG-LRU's D = 2,560 is 160 blocks on the
H100's 132 SMs.  Each block streams a and b through a ring of shared-memory
stages (``csrc/linear_scan.cu``).  A decode step (S = 1) takes a kernel
without a ring, whose launch shape is fixed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import library
from repro_torch.kernels.common import kernel_defaults, sm_count
from repro_torch.kernels.linear_scan.ref import linear_scan_ref

_DTYPES = (torch.float32, torch.bfloat16)


def scan_threads(batch: int, dim: int, sms: int) -> int:
    """Threads (= channels) a block of the scan over [batch, *, dim] on a
    card with ``sms`` SMs: 64 where ``batch`` x ceil(dim / 64) blocks still
    cover every SM and dim > 32, else 32."""
    return 64 if dim > 32 and batch * -(-dim // 64) >= sms else 32


def _entry():
    lib = library("linear_scan")
    fn = lib.linear_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.linear_scan_error.argtypes = [ctypes.c_int]
        lib.linear_scan_error.restype = ctypes.c_char_p
    return lib, fn


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None):
    """a, b: [B, S, D] float32 or bfloat16 (one dtype); h0: [B, D] float32
    or bfloat16, or None (zeros).

    Returns ``(h_seq [B, S, D] in a.dtype, h_last [B, D] in h0.dtype)``
    (``a.dtype`` when ``h0`` is None).
    """
    kd = kernel_defaults(a.device)
    if not kd.kernel:
        return linear_scan_ref(a, b, h0)
    if a.dim() != 3 or a.dtype not in _DTYPES:
        raise ValueError(f"linear_scan: a must be a [B, S, D] float32 or "
                         f"bfloat16 tensor, got {a.dtype} {tuple(a.shape)}")
    for name, t in (("a", a), ("b", b)):
        if (t.shape != a.shape or t.dtype != a.dtype or t.device != a.device
                or not t.is_contiguous()):
            raise ValueError(f"linear_scan: {name} must be a contiguous "
                             f"{a.dtype} {tuple(a.shape)} tensor on {a.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    bsz, s, d = a.shape
    if h0 is not None and (h0.shape != (bsz, d) or h0.dtype not in _DTYPES
                           or h0.device != a.device or not h0.is_contiguous()):
        raise ValueError(f"linear_scan: h0 must be a contiguous [{bsz}, {d}] "
                         f"float32 or bfloat16 tensor on {a.device}, got "
                         f"{h0.dtype} {tuple(h0.shape)} on {h0.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        raise NotImplementedError(
            "linear_scan has no backward kernel; differentiate the plain "
            "version (use_pallas=False)")
    h_dtype = a.dtype if h0 is None else h0.dtype
    h_seq = torch.empty_like(a)
    h_last = torch.empty((bsz, d), dtype=h_dtype, device=a.device)
    if bsz * d == 0:
        return h_seq, h_last
    lib, fn = _entry()
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
                 h_seq.data_ptr(), h_last.data_ptr(), bsz, s, d,
                 int(a.dtype == torch.bfloat16), int(h_dtype == torch.bfloat16),
                 scan_threads(bsz, d, sm_count(a.device)),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"linear_scan launch failed: "
                           f"{lib.linear_scan_error(err).decode()} ({err})")
    linear_scan.launches += 1
    return h_seq, h_last


linear_scan.launches = 0
