"""Public flash-attention op: model layout [B, S, H, D], the plain oracle by
default, the kernel on request.

``use_pallas=True`` (the JAX package's flag name) runs the hand-written CUDA
kernel on a CUDA tensor, or its plain version on a CPU tensor.  The kernel
reads and writes the model layout through strides and masks ragged tiles
itself, so nothing is transposed in memory or padded.  ``impl`` overrides
``use_pallas``: ``"ref"``/``"pallas"`` force a lowering, ``"auto"`` routes
through the measured dispatcher (:mod:`repro_torch.kernels.autotune`).  The
kernel path is forward-only, as in the JAX package, whose Pallas kernel has
no gradient either: asking it for a gradient raises, on the CPU as on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention as _flash_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, use_pallas: bool = False,
                    block_q: int | None = None, block_k: int | None = None,
                    impl: str | None = None) -> torch.Tensor:
    """q: [B, S, H, D]; k/v: [B, S, Hkv, D] -> [B, S, H, D] (model layout).

    The kernel path takes equal query and key lengths, as the JAX op's
    padding does; ``block_q``/``block_k`` default to the device's row of
    :mod:`repro_torch.kernels.common`.
    """
    if impl == "auto":
        from repro_torch.kernels.autotune import dispatch
        return dispatch("flash_attention", q, k, v, causal=causal)
    if impl is not None:
        if impl not in ("ref", "pallas"):
            raise ValueError(f"impl {impl!r}; expected ref|pallas|auto")
        use_pallas = impl == "pallas"
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not use_pallas:
        return flash_attention_ref(qt, kt, vt, causal=causal).transpose(1, 2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention(use_pallas=True) has no backward: the CUDA kernel "
            "is forward-only, as the JAX package's Pallas kernel is; "
            "differentiate the plain version (use_pallas=False)")
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention(use_pallas=True) takes equal query "
                         f"and key lengths, got {q.shape[1]} and {k.shape[1]}")
    return _flash_kernel(qt, kt, vt, causal=causal, block_q=block_q,
                         block_k=block_k).transpose(1, 2)
