"""Public diffusion-conv op: the plain oracle by default, the kernel on request.

``use_pallas=True`` (the JAX package's flag name) runs every hop through
the hand-written CUDA ``hop_project`` on a CUDA tensor, or its plain version
on a CPU tensor.  That path is forward-only, as in the JAX package, whose
Pallas hop has no gradient either: asking it for a gradient raises.
``impl`` overrides ``use_pallas``: ``"ref"``/``"pallas"`` force a lowering,
``"auto"`` routes through the measured dispatcher
(:mod:`repro_torch.kernels.autotune`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.diffusion_conv.kernel import hop_project
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
        raise NotImplementedError(
            "diffusion_conv(use_pallas=True) has no backward: the hop_project "
            "kernel is forward-only (its backward kernel is still to be "
            "written); train with use_pallas=False")
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
