"""Launchers of the hand-written CUDA hop kernels (``csrc/hop_project.cu``,
``csrc/hop_gemm.cu``).

``hop_project`` replaces the Pallas TPU kernel ``hop_project`` of the JAX
package (``repro/kernels/diffusion_conv/kernel.py``): one diffusion hop fused
with its projection,

    Z_k = S @ Z_{k-1}            S [N, N], Z [N, B, C]
    Y  += Z_k @ W_k              W_k [C, H], Y [N, B, H]

:func:`hop_project_plain` is its plain PyTorch version: a CPU tensor takes
it, a CUDA tensor launches the kernel or raises.  The kernel runs both
products on the tensor cores through ``wgmma`` in 3xTF32 (three TF32
products per fp32 product, fp32 accumulation), which keeps fp32 accuracy,
and splits Z inside the kernel: it allocates nothing.  It has no backward.

The kernel's tiles hold whole batch elements of at most ``MAX_C`` feature
columns.  The hop is separable in C (``Z_k[..., tile] = S @ Z_{k-1}[...,
tile]`` and ``Y += sum over tiles of Z_k[..., tile] @ W_k[tile, :]``), so
:func:`hop_project` runs a wider C as equal column tiles of at most
``MAX_C``, each tile's Y feeding the next tile's launch; every tile reads S
again.  ``hop_project.launches`` counts the kernel's launches, one a tile.

``hop_gemm`` replaces no TPU kernel (the JAX package differentiates XLA's
products): the hop of training and its backward,

    forward   Z_k      = S  @ Z_{k-1}
    backward  dZ_{k-1} = Sᵀ @ dZ_k

through ``wgmma`` in 3xTF32, likewise with fp32 accuracy.
:func:`hop_gemm_plain` is its plain version, taken by a CPU tensor.
:func:`hop` is the differentiable hop that
:func:`~repro_torch.kernels.diffusion_conv.ops.diffusion_conv` runs where a
gradient is wanted; its backward launches only for an input that needs a
gradient, and it keeps only a reference to S (the supports take no
gradient).  ``hop_gemm.launches_fwd`` and ``hop_gemm.launches_bwd`` count
the kernel's launches in each direction.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library
from repro_torch.kernels.common import kernel_defaults, sm_count

#: Widest feature dim C of a batch element in the kernel's tile; wider C runs
#: as column tiles.
MAX_C = 128


def hop_project_plain(s, z, w, y):
    """(Z_next, Y_next) = (S @ Z, Y + (S @ Z) @ W) with plain einsums."""
    z_next = torch.einsum("mn,nbc->mbc", s, z)
    return z_next, y + torch.einsum("nbc,ch->nbh", z_next, w)


def _entry():
    lib = library("hop_project")
    fn = lib.hop_project_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    CPU tensor).  Every shape takes the one kernel, which sizes its own tiles
    from (N, B, C): a persistent block on each of the card's SMs."""
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
                 z_out.data_ptr(), y_out.data_ptr(), n, b, c, h, sm_count(z.device),
                 torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"hop_project launch failed: "
                           f"{lib.hop_project_error(err).decode()} ({err})")
    hop_project.launches += 1
    return z_out, y_out


hop_project.launches = 0


def hop_gemm_plain(s, z, *, transpose: bool = False):
    """``S @ Z`` (``Sᵀ @ Z`` with ``transpose``) of z: [N, B, C], as one
    plain product over the N x (B·C) view."""
    n = s.shape[0]
    a = s.T if transpose else s
    return (a @ z.reshape(n, -1)).reshape(z.shape)


@functools.lru_cache(maxsize=None)
def _gemm_entry():
    """The loaded library and its typed entry, resolved once a process."""
    lib = library("hop_gemm")
    fn = lib.hop_gemm_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.hop_gemm_error.argtypes = [ctypes.c_int]
        lib.hop_gemm_error.restype = ctypes.c_char_p
    return lib, fn


def hop_gemm(s, z, *, transpose: bool = False):
    """One hop.  s: [N, N] contiguous float32; z: [N, B, C] float32 in any
    strides.  Returns ``S @ Z`` (``Sᵀ @ Z`` with ``transpose``), [N, B, C]
    contiguous: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if not kernel_defaults(z.device).kernel:
        return hop_gemm_plain(s, z, transpose=transpose)
    if z.dim() != 3:
        raise ValueError(f"hop_gemm: z must be [N, B, C], got shape {tuple(z.shape)}")
    n, b, c = z.shape
    for name, t in (("s", s), ("z", z)):
        if t.dtype != torch.float32 or t.device != z.device:
            raise ValueError(f"hop_gemm: {name} must be float32 on {z.device}, got "
                             f"{t.dtype} on {t.device}")
    if tuple(s.shape) != (n, n) or not s.is_contiguous():
        raise ValueError(f"hop_gemm: s must be a contiguous [{n}, {n}], got shape "
                         f"{tuple(s.shape)}, strides {s.stride()}")
    out = torch.empty((n, b, c), dtype=torch.float32, device=z.device)
    if out.numel() == 0:
        return out
    kp = -(-n // 4) * 4
    planes = torch.empty(2 * b * c * kp, dtype=torch.float32, device=z.device)
    lib, fn = _gemm_entry()
    with torch.cuda.device(z.device):
        err = fn(s.data_ptr(), z.data_ptr(), out.data_ptr(), planes.data_ptr(), n, b, c,
                 *z.stride(), int(transpose), sm_count(z.device),
                 torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"hop_gemm launch failed: {lib.hop_gemm_error(err).decode()} "
                           f"({err})")
    if transpose:
        hop_gemm.launches_bwd += 1
    else:
        hop_gemm.launches_fwd += 1
    return out


hop_gemm.launches_fwd = 0
hop_gemm.launches_bwd = 0


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, z):
        ctx.save_for_backward(s)  # a reference: the backward needs S itself
        return hop_gemm(s, z)

    @staticmethod
    def backward(ctx, grad):
        (s,) = ctx.saved_tensors
        dz = hop_gemm(s, grad, transpose=True) if ctx.needs_input_grad[1] else None
        return None, dz


def hop(s, z):
    """The differentiable hop ``S @ Z`` of z: [N, B, C]; S takes no gradient."""
    if s.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("hop: the supports take no gradient; detach S")
    return _Hop.apply(s, z)
