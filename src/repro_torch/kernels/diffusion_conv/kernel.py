"""Launcher of the hand-written CUDA hop kernel (``csrc/hop_project.cu``).

Replaces the Pallas TPU kernel ``hop_project`` of the JAX package
(``repro/kernels/diffusion_conv/kernel.py``): one diffusion hop fused with
its projection,

    Z_k = S @ Z_{k-1}            S [N, N], Z [N, B, C]
    Y  += Z_k @ W_k              W_k [C, H], Y [N, B, H]

:func:`hop_project_plain` is its plain PyTorch version: a CPU tensor takes
it, a CUDA tensor launches the kernel or raises.  The kernel runs on the
tensor cores in 3xTF32 (three TF32 products per fp32 product, fp32
accumulation), which keeps fp32 accuracy.  It has no backward.

The kernel's register tile covers at most ``MAX_C`` feature columns.  The
hop is separable in C (``Z_k[..., tile] = S @ Z_{k-1}[..., tile]`` and
``Y += sum over tiles of Z_k[..., tile] @ W_k[tile, :]``), so
:func:`hop_project` runs a wider C as equal column tiles of at most
``MAX_C``, each tile's Y feeding the next tile's launch; every tile reads S
again.  ``hop_project.launches`` counts the kernel's launches, one a tile.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import library
from repro_torch.kernels.common import kernel_defaults

#: Widest feature dim C the kernel's register tile covers; wider C runs as
#: column tiles.
MAX_C = 128


def hop_project_plain(s, z, w, y):
    """(Z_next, Y_next) = (S @ Z, Y + (S @ Z) @ W) with plain einsums."""
    z_next = torch.einsum("mn,nbc->mbc", s, z)
    return z_next, y + torch.einsum("nbc,ch->nbh", z_next, w)


def _entry():
    lib = library("hop_project")
    fn = lib.hop_project_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.hop_project_error.argtypes = [ctypes.c_int]
        lib.hop_project_error.restype = ctypes.c_char_p
    return lib, fn


def column_tiles(c: int) -> list[tuple[int, int]]:
    """``(lo, hi)`` bounds of the fewest equal column tiles of at most
    ``MAX_C`` that cover ``c`` feature columns."""
    n = -(-c // MAX_C)
    if n <= 1:
        return [(0, c)]
    width = -(-c // n)
    return [(lo, min(lo + width, c)) for lo in range(0, c, width)]


def hop_project(s, z, w, y):
    """One fused hop.  s: [N, N], z: [N, B, C], w: [C, H], y: [N, B, H].

    Returns ``(z_next, y_next)``.  Any C: above ``MAX_C`` the columns run
    as tiles (:func:`column_tiles`), on the kernel or, for a CPU tensor, on
    its plain version.
    """
    tiles = column_tiles(z.shape[2])
    if len(tiles) == 1:
        return _hop_tile(s, z, w, y)
    z_parts = []
    for lo, hi in tiles:
        z_part, y = _hop_tile(s, z[..., lo:hi].contiguous(), w[lo:hi].contiguous(), y)
        z_parts.append(z_part)
    return torch.cat(z_parts, dim=-1), y


def _hop_tile(s, z, w, y):
    """One launch over at most ``MAX_C`` columns (the plain version on a
    CPU tensor)."""
    kd = kernel_defaults(z.device)
    if not kd.kernel:
        return hop_project_plain(s, z, w, y)
    n, b, c = z.shape
    h = w.shape[1]
    expect = {"s": (n, n), "w": (c, h), "y": (n, b, h)}
    for name, t in (("s", s), ("z", z), ("w", w), ("y", y)):
        if t.dtype != torch.float32 or t.device != z.device or not t.is_contiguous():
            raise ValueError(f"hop_project: {name} must be contiguous float32 on "
                             f"{z.device}, got {t.dtype} on {t.device}")
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"hop_project: {name} has shape {tuple(t.shape)}, "
                             f"expected {expect[name]}")
    if not 0 < c <= MAX_C:
        raise ValueError(f"hop_project: feature dim C={c} outside [1, {MAX_C}]")
    if any(t.requires_grad for t in (s, z, w, y)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "hop_project has no backward kernel; differentiate the plain "
            "version (use_pallas=False)")
    z_out = torch.empty_like(z)
    y_out = torch.empty_like(y)
    if z.numel() == 0:
        return z_out, y_out
    lib, fn = _entry()
    with torch.cuda.device(z.device):
        err = fn(s.data_ptr(), z.data_ptr(), w.data_ptr(), y.data_ptr(),
                 z_out.data_ptr(), y_out.data_ptr(), n, b, c, h,
                 torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"hop_project launch failed: "
                           f"{lib.hop_project_error(err).decode()} ({err})")
    hop_project.launches += 1
    return z_out, y_out


hop_project.launches = 0
