"""Public diffusion-conv op: the plain oracle by default, the kernels on request.

``use_pallas=True`` (the JAX package's flag name) runs the hops on the
hand-written CUDA kernels on a CUDA tensor, or on their plain versions on a
CPU tensor.  Where a gradient is wanted, each hop is the differentiable
:func:`~repro_torch.kernels.diffusion_conv.kernel.hop` (the ``hop_gemm``
kernel, forward and backward) and the projection stays one plain product,
as :func:`diffusion_conv_ref` forms it.  Without gradients every hop runs
through ``hop_project``, fused with its share of the projection.  ``impl``
overrides ``use_pallas``: ``"ref"``/``"pallas"`` force a lowering,
``"auto"`` routes through the measured dispatcher
(:mod:`repro_torch.kernels.autotune`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.diffusion_conv.kernel import hop, hop_project
from repro_torch.kernels.diffusion_conv.ref import diffusion_conv_ref


def diffusion_conv(x, supports, w, b, *, k_hops: int, use_pallas: bool = False,
                   impl: str | None = None):
    """x: [B, N, C] -> [B, N, H].  See ref.py for the weight layout."""
    if impl == "auto":
        from repro_torch.kernels.autotune import dispatch
        return dispatch("diffusion_conv", x, tuple(supports), w, b,
                        k_hops=k_hops, n_supports=len(supports))
    if impl is not None:
        if impl not in ("ref", "pallas"):
            raise ValueError(f"impl {impl!r}; expected ref|pallas|auto")
        use_pallas = impl == "pallas"
    if not use_pallas:
        return diffusion_conv_ref(x, supports, w, b, k_hops=k_hops)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, b, *supports)):
        return _trained(x, supports, w, b, k_hops)
    c = x.shape[2]
    h = w.shape[1]
    z0 = x.transpose(0, 1).contiguous()  # [N, B, C]
    # Identity-hop projection: one plain matmul, as the JAX package leaves
    # it to XLA outside its kernel.
    y = z0 @ w[:c]
    wk = w[c:].reshape(len(supports), k_hops, c, h)
    for si, s in enumerate(supports):
        s = s.contiguous()
        z = z0
        for k in range(k_hops):
            z, y = hop_project(s, z, wk[si, k].contiguous(), y)
    return y.transpose(0, 1) + b


def _trained(x, supports, w, b, k_hops: int):
    """The differentiable path: hops on [N, B, C] (the first reads x's
    transposed view in place), then ``[x | Z_k...] @ w + b`` over [B, N, ·],
    as the oracle forms it: its output is contiguous, so the ops after it
    save no reordered copy of their input for the backward."""
    z0 = x.transpose(0, 1)
    feats = [x]
    for s in supports:
        s = s.contiguous()
        z = z0
        for _ in range(k_hops):
            z = hop(s, z)
            feats.append(z.transpose(0, 1))
    return torch.cat(feats, dim=-1) @ w + b
