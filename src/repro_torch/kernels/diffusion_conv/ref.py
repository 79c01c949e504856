"""Plain PyTorch oracle for diffusion convolution (DCRNN dual random-walk form).

Weight layout (rows of ``w``): [identity | support0 hop1..K | support1 hop1..K]
each block of size C, so ``w: [(1 + n_supports*K) * C, H]``.
"""
from __future__ import annotations

import torch


def diffusion_conv_ref(x, supports, w, b, *, k_hops: int):
    """x: [B, N, C], supports: tuple of [N, N], w: [(1+S*K)*C, H], b: [H]."""
    feats = [x]
    for s in supports:
        z = x
        for _ in range(k_hops):
            z = torch.einsum("mn,bnc->bmc", s, z)
            feats.append(z)
    h = torch.cat(feats, dim=-1)
    return h @ w + b
