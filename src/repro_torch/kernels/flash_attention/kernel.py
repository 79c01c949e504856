"""Launcher of the hand-written CUDA flash attention (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention`` of the JAX package
(``repro/kernels/flash_attention/kernel.py``): forward attention with an
online softmax, grouped-query heads read in place, and keys past Skv masked
in every mode.  bfloat16 runs on the tensor cores (``mma.sync``), float32 on
the CUDA cores; each dtype has its own tiles.  Its plain PyTorch version is
:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_ref`: a CPU
tensor takes it, a CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import library
from repro_torch.kernels.common import kernel_defaults
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: float32 tiles the kernel is compiled for, each square (block_q == block_k).
BLOCKS = (32, 64, 128)
#: The bfloat16 kernel's one tile (block_q == block_k == 64): 8 warps, four
#: of 16 query rows in each of two key groups over alternate key tiles.
BF16_BLOCK = 64
#: Widest head dim the kernels cover.
MAX_D = 256
#: Shared memory a block may opt into on sm_90 (H100, H200).
MAX_SMEM = 232_448


def _padded_d(d: int) -> int:
    """D padded to the kernels' column tile: a power of two, at least 16."""
    dp = 16
    while dp < d:
        dp *= 2
    return dp


def smem_bytes(block_q: int, block_k: int, d: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory the kernel asks for.  float32: Q and K/V tiles of
    ``Dp + 1`` columns, the key-major P tile and three per-row vectors.
    bfloat16: a Q tile and the two key groups' K and V tiles, of ``Dp``
    columns.  ``Dp`` is D padded to a power of two, at least 16."""
    dp = _padded_d(d)
    if dtype == torch.bfloat16:
        return 2 * (block_q + 2 * 2 * block_k) * dp
    return 4 * ((block_q + block_k) * (dp + 1) + block_k * (block_q + 1)
                + 3 * block_q)


def fits(block_q: int, block_k: int, d: int,
         dtype: torch.dtype = torch.float32) -> bool:
    """Whether the tiles are compiled for ``dtype`` (square; float32 in
    ``BLOCKS``, bfloat16 ``BF16_BLOCK``) and fit one block's shared
    memory."""
    compiled = BLOCKS if dtype == torch.float32 else (BF16_BLOCK,)
    return (block_q == block_k and block_q in compiled
            and smem_bytes(block_q, block_k, d, dtype) <= MAX_SMEM)


def _entry():
    lib = library("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error.argtypes = [ctypes.c_int]
        lib.flash_attention_error.restype = ctypes.c_char_p
    return lib, fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k/v: [B, Hkv, Skv, D] (H % Hkv == 0), float32 or
    bfloat16, any strides with a contiguous last dim -> [B, H, Sq, D].

    On a CUDA tensor the result is a view of a ``[B, Sq, H, D]`` buffer (the
    model layout), which the kernel writes through strides.
    """
    kd = kernel_defaults(q.device)
    if not kd.kernel:
        return flash_attention_ref(q, k, v, causal=causal)
    bq = kd.block_q if block_q is None else block_q
    bk = kd.block_k if block_k is None else block_k
    if q.dim() != 4 or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q must be a [B, H, Sq, D] float32 or "
                         f"bfloat16 tensor, got {q.dtype} {tuple(q.shape)}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dim() != 4 or t.dtype != q.dtype or t.device != q.device
                or (t.shape[-1] > 1 and t.stride(-1) != 1)):
            raise ValueError(f"flash_attention: {name} must be a 4-d {q.dtype} "
                             f"tensor on {q.device} with a contiguous last dim, "
                             f"got {t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()} on {t.device}")
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape
            or hkv == 0 or h % hkv):
        raise ValueError(f"flash_attention: k and v must be [{b}, Hkv, Skv, {d}] "
                         f"with Hkv dividing {h}, got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not 0 < d <= MAX_D or skv == 0:
        raise ValueError(f"flash_attention: head dim {d} outside [1, {MAX_D}] "
                         f"or no keys (Skv = {skv})")
    if not fits(bq, bk, d, q.dtype):
        shape = (f"({BF16_BLOCK}, {BF16_BLOCK})" if q.dtype == torch.bfloat16
                 else f"square, in {BLOCKS}")
        raise ValueError(f"flash_attention: tiles ({bq}, {bk}) at head dim {d} "
                         f"need {smem_bytes(bq, bk, d, q.dtype)} bytes of shared "
                         f"memory (at most {MAX_SMEM}); {q.dtype} tiles must be "
                         f"{shape}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernel; differentiate the plain "
            "version (use_pallas=False)")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    lib, fn = _entry()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *strides, b, h, hkv, sq, skv, d, 1.0 / math.sqrt(d),
                 int(causal), int(q.dtype == torch.bfloat16), bq, bk,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error(err).decode()} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
