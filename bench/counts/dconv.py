"""FLOPs of the products of one diffusion convolution and of the output
projection, as ``bench/models/dconv.py`` computes them: 2*m*n*k a product,
the backward only for the operands that need a gradient (the supports never
do; the weights always do in training).
"""
from __future__ import annotations


def dconv_flops(n: int, b: int, c: int, h: int, k_hops: int, *,
                train: bool, input_grad: bool) -> int:
    """One DConv of a ``[b, n, c]`` input into ``h`` features over two
    supports of ``k_hops`` hops each."""
    hops = 2 * k_hops * 2 * n * n * b * c
    proj = 2 * (b * n) * ((1 + 2 * k_hops) * c) * h
    if not train:
        return hops + proj
    backward = proj  # the weight's gradient
    if input_grad:
        backward += hops + proj  # each hop's input, the projection's input
    return hops + proj + backward


def project_flops(n: int, b: int, h: int, out: int, *, train: bool) -> int:
    """The output projection ``[b*n, h] @ [h, out]``: in training also the
    weight's and the input's gradients."""
    f = 2 * b * n * h * out
    return 3 * f if train else f


def hop_shape(n: int, b: int, c: int, h: int, k_hops: int) -> list[tuple]:
    """``(n, b, c, h)`` of each hop of one DConv: the hop ``S @ Z`` fused
    with its share of the projection, ``Z_k @ W_k``."""
    return [(n, b, c, h)] * (2 * k_hops)


def hop_bound_s(shapes, peak_flops: float, peak_bytes: float) -> float:
    """Least device time of those hops: each the larger of its FLOPs
    (``2n^2bc + 2nbch``, counted once) over ``peak_flops`` and its bytes
    (S, Z, Y and W read once, Z and Y written once, float32) over
    ``peak_bytes``."""
    total = 0.0
    for n, b, c, h in shapes:
        flops = 2 * n * n * b * c + 2 * n * b * c * h
        nbytes = 4 * (n * n + 2 * n * b * c + 2 * n * b * h + c * h)
        total += max(flops / peak_flops, nbytes / peak_bytes)
    return total


def hop_gemm_bound_s(shapes, peak_flops: float, peak_bytes: float) -> float:
    """Least device time of those hops on training's hop kernel, each
    ``[n, n] @ [n, b*c]`` alone (its projection runs apart): the larger of
    three TF32 products of its ``2n^2bc`` FLOPs (3xTF32, float32's
    accuracy) over ``peak_flops`` and its bytes (S and Z read once, the
    result written once, float32) over ``peak_bytes``."""
    total = 0.0
    for n, b, c, _ in shapes:
        flops = 3 * 2 * n * n * b * c
        nbytes = 4 * (n * n + 2 * n * b * c)
        total += max(flops / peak_flops, nbytes / peak_bytes)
    return total
